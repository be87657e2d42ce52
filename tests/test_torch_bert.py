"""paddle_tpu_torch.models.bert against paddle_tpu.models.bert.

bert_tiny (vocab 1024, hidden 128, 2 layers, 4 heads, FFN 256) with
dropout 0, weights drawn by paddle_tpu and carried by
``bert_params_from_numpy``; batch 2 x seq 64, ids from a numpy seed and
MLM labels at ~15 % of the positions (-100 elsewhere), as
bench.py::bench_bert_base makes them. On the CPU both packages run the
attention composite (the reference has no TPU kernel here, the port no
card)."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu.optimizer import AdamW as JAdamW
import paddle_tpu_torch as ptt
from paddle_tpu_torch import bert_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn.layers import Dropout, MultiHeadAttention
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import jax_state_numpy

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
BATCH, SEQ, LR, STEPS = 2, 64, 1e-3, 3
# loss: f32, the same math summed in other orders (measured <= 1e-6 of
# 7.0); bf16 O1, the white ops' products rounded to bf16 at places an
# ulp apart between XLA and torch (measured <= 6.8e-4; GPT's limit,
# tests/test_torch_train_step.py)
LOSS_TOL = {False: dict(rtol=1e-5, atol=0), True: dict(rtol=0, atol=2e-3)}
# logits, largest error over the largest logit: f32 summation order
# (measured 2e-7); bf16 one ulp of the logits' bf16 product (2^-7 at
# their scale, measured 0.0078 absolute)
LOGIT_TOL = {False: 1e-5, True: 2.0 ** -5}
# gradients, each tensor's largest error over its largest element (or a
# hundredth of the model's largest gradient element, when that is more:
# the key biases' exact gradient is 0, since softmax ignores a shift
# shared by every key, and both sides hold rounding noise there, ~1e-9
# in f32 and ~3e-5 in bf16). f32: measured <= 1.7e-6. bf16 O1: the
# ulp-apart roundings carried through the backward, measured <= 2.1e-2
GRAD_TOL = {False: 1e-5, True: 2.0 ** -5}


def _twins(seed=0, **kw):
    pt.seed(seed)
    jm = jbert.BertForMaskedLM(jbert.bert_tiny(**NO_DROPOUT, **kw))
    jm.train()
    init = jax_state_numpy(jm)
    tm = tbert.BertForMaskedLM(tbert.bert_tiny(**NO_DROPOUT, **kw),
                               device="cpu")
    tm.load_state_dict(bert_params_from_numpy(init))
    tm.train()
    return jm, tm, init


def _batch(types=False, mask=False, seed=0):
    """ids, labels, token type ids (or None), attention mask (or None:
    the second row's last 20 positions masked)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int32)
    labels = np.where(rng.random((BATCH, SEQ)) < 0.15, ids, -100).astype(
        np.int32)
    tt = rng.integers(0, 2, (BATCH, SEQ)).astype(np.int32) if types \
        else None
    am = (np.arange(SEQ)[None] < np.array([[SEQ], [SEQ - 20]])).astype(
        np.int32) if mask else None
    return ids, labels, tt, am


def _grads(named, port):
    out = {}
    for n, p in named:
        g = p.grad
        if g is None:
            out[n] = None
        else:
            out[n] = g.float().numpy() if port else np.asarray(
                g.numpy(), np.float32)
    return out


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("types", [False, True],
                         ids=["no_types", "token_types"])
@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
def test_loss_logits_and_gradients_match_reference(amp_on, types, mask):
    jm, tm, _ = _twins()
    ids, labels, tt, am = _batch(types, mask)

    def opt(x, wrap):
        return None if x is None else wrap(x)

    with pt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        jloss, jlogits = jm(pt.to_tensor(ids), opt(tt, pt.to_tensor),
                            opt(am, pt.to_tensor),
                            labels=pt.to_tensor(labels))
    jloss.backward()
    with ptt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        tloss, tlogits = tm(torch.as_tensor(ids), opt(tt, torch.as_tensor),
                            opt(am, torch.as_tensor),
                            labels=torch.as_tensor(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               **LOSS_TOL[amp_on])
    want_l = np.asarray(jlogits.numpy(), np.float32)
    got_l = tlogits.detach().float().numpy()
    assert got_l.shape == want_l.shape == (BATCH, SEQ, 1024)
    assert np.abs(got_l - want_l).max() <= \
        LOGIT_TOL[amp_on] * np.abs(want_l).max()
    jg = _grads(jm.named_parameters(), port=False)
    tg = _grads(tm.named_parameters(), port=True)
    assert list(jg) == list(tg)
    # the pooler never reaches the MLM loss, nor the token-type table
    # without token types: no gradient on either side
    unused = {"bert.pooler.weight", "bert.pooler.bias"} | (
        set() if types else {"bert.embeddings.token_type_embeddings.weight"})
    assert {n for n, g in tg.items() if g is None} == unused
    assert {n for n, g in jg.items() if g is None} == unused
    top = max(np.abs(g).max() for g in jg.values() if g is not None)
    for n, w in jg.items():
        if w is None:
            continue
        g = tg[n]
        assert np.isfinite(g).all(), n
        scale = max(np.abs(w).max(), 1e-2 * top)
        assert np.abs(g - w).max() <= GRAD_TOL[amp_on] * scale, n


def _train(pkg, init, amp_on, ids, labels):
    """3 TrainStep calls of bench_bert_base's step (AdamW, O1 bf16 when
    amp_on) from the weights `init`: (losses, final state as numpy)."""
    if pkg == "ref":
        pt.seed(0)
        model = jbert.BertForMaskedLM(jbert.bert_tiny(**NO_DROPOUT))
        model.set_state_dict({k: pt.to_tensor(v) for k, v in init.items()})
        model.train()
        opt = JAdamW(learning_rate=LR, parameters=model.parameters())
        amp, step_cls = pt.amp, JTrainStep
    else:
        model = tbert.BertForMaskedLM(tbert.bert_tiny(**NO_DROPOUT),
                                      device="cpu")
        model.load_state_dict(bert_params_from_numpy(init))
        model.train()
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
        amp, step_cls = ptt.amp, ptt.TrainStep

    def loss_fn(m, ids, labels):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            loss, _ = m(ids, labels=labels)
        return loss

    step = step_cls(model, opt, loss_fn)
    losses = [float(np.asarray(step(ids, labels))) for _ in range(STEPS)]
    step.sync()
    state = jax_state_numpy(model) if pkg == "ref" else {
        k: v.detach().numpy() for k, v in model.state_dict().items()}
    return losses, state


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
def test_train_steps_match_reference(amp_on):
    """3 TrainStep calls against the reference's. The pooler and the
    token-type table get zero gradients on both sides (the port's
    TrainStep gives an unused parameter zeros, as jax.grad does), so
    AdamW's decoupled decay alone moves them, identically."""
    _, _, init = _twins()
    ids, labels, _, _ = _batch()
    want_losses, want = _train("ref", init, amp_on, ids, labels)
    got_losses, got = _train("port", init, amp_on, ids, labels)
    assert all(np.isfinite(got_losses))
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL[amp_on])
    assert sorted(got) == sorted(want)
    bound = 2 * LR * STEPS
    far = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        # a sign flip of a near-zero gradient moves an Adam parameter by
        # up to ~2 lr a step: nothing may differ by more
        assert d.max() <= bound, (k, d.max())
        far += int((d > 1e-3 * LR).sum())
    if not amp_on:
        n = sum(w.size for w in want.values())
        assert far / n < 2e-3, far / n
    decay = (1 - LR * 0.01) ** STEPS
    for k in ("bert.pooler.weight",
              "bert.embeddings.token_type_embeddings.weight"):
        np.testing.assert_allclose(got[k], init[k] * decay, rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
        assert not np.array_equal(got[k], init[k])


def test_encoder_layers_start_identical_as_in_reference():
    """The reference's quirk, kept: BertModel's encoder deep-copies one
    initialised layer, so every layer starts with its weights."""
    jm, _, init = _twins()
    tm = tbert.BertForMaskedLM(
        dataclasses.replace(tbert.bert_tiny(), num_layers=3), device="cpu")
    jm3 = jbert.BertForMaskedLM(
        dataclasses.replace(jbert.bert_tiny(), num_layers=3))
    for sd in ({k: v.numpy() for k, v in tm.state_dict().items()},
               jax_state_numpy(jm3), init):
        first = {k[len("bert.encoder.layers.0."):]: v for k, v in sd.items()
                 if k.startswith("bert.encoder.layers.0.")}
        assert len(first) == 16
        n_layers = len({k.split(".")[3] for k in sd
                        if k.startswith("bert.encoder.layers.")})
        for i in range(1, n_layers):
            for k, v in first.items():
                np.testing.assert_array_equal(
                    sd[f"bert.encoder.layers.{i}.{k}"], v)


def test_initial_weights_follow_the_reference_defaults():
    """Embeddings N(0, 0.02), Linear weights XavierUniform, biases and
    decoder_bias 0, LayerNorm 1/0; a seed gives the same weights, another
    seed others; dropout generators assigned after construction."""
    cfg = tbert.bert_tiny()
    m = tbert.BertForMaskedLM(cfg, device="cpu", seed=3)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    w = sd["bert.embeddings.word_embeddings.weight"]
    assert abs(w.std() - 0.02) < 1e-3 and abs(w.mean()) < 1e-3
    lim = np.sqrt(6.0 / (128 + 256))
    w1 = sd["bert.encoder.layers.0.linear1.weight"]
    assert w1.shape == (128, 256) and 0.95 * lim < np.abs(w1).max() <= lim
    assert not sd["decoder_bias"].any() and not sd["transform.bias"].any()
    assert (sd["transform_norm.weight"] == 1).all()
    again = tbert.BertForMaskedLM(cfg, device="cpu", seed=3)
    other = tbert.BertForMaskedLM(cfg, device="cpu", seed=4)
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    assert not np.array_equal(
        other.state_dict()["transform.weight"].numpy(),
        sd["transform.weight"])
    gens = {id(mod.generator) for mod in m.modules()
            if isinstance(mod, (Dropout, MultiHeadAttention))}
    assert len(gens) == 1 and None not in {
        mod.generator for mod in m.modules()
        if isinstance(mod, (Dropout, MultiHeadAttention))}


def test_dropout_draws_from_the_model_generator():
    """With dropout on, the same seed gives the same loss twice and the
    masks differ from step to step."""
    cfg = tbert.bert_tiny(hidden_dropout_prob=0.1,
                          attention_dropout_prob=0.1)
    ids, labels, _, _ = _batch()
    runs = []
    for _ in range(2):
        m = tbert.BertForMaskedLM(cfg, device="cpu", seed=5).train()
        runs.append([float(m(torch.as_tensor(ids),
                             labels=torch.as_tensor(labels))[0].detach())
                     for _ in range(2)])
    assert runs[0] == runs[1] and runs[0][0] != runs[0][1]


def test_parameter_count_of_bert_base():
    """bert_base: 110,104,890 parameters, by the reference's module
    structure (embeddings and their LayerNorm, 12 encoder layers, the
    pooler, the MLM transform and its LayerNorm, the decoder bias), on
    both packages' configs; the formula checked on the reference's
    bert_tiny built."""
    def formula(c):
        h, i = c.hidden_size, c.intermediate_size
        emb = (c.vocab_size + c.max_position_embeddings
               + c.type_vocab_size) * h + 2 * h
        layer = 4 * (h * h + h) + (h * i + i) + (i * h + h) + 4 * h
        return emb + c.num_layers * layer + 2 * (h * h + h) + 2 * h \
            + c.vocab_size

    jm = jbert.BertForMaskedLM(jbert.bert_tiny())
    assert formula(jbert.bert_tiny()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())
    assert formula(tbert.bert_base()) == formula(jbert.bert_base()) \
        == 110_104_890
    tm = tbert.BertForMaskedLM(tbert.bert_base(), device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 110_104_890


def test_bert_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.BertForMaskedLM(tbert.bert_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.BertModel(tbert.bert_tiny())
