"""The language models on the eager API's Tensors, ``GPTForCausalLM.
generate``, ``Optimizer.minimize`` and the models as ``Layer``s, held
to the reference's (ROADMAP Queue C faults 1-4).

The reference cases of tests/test_models.py (TestGPT's forward shape,
backward and KV-cache decode, TestLlama, TestBert), tests/
test_generation.py (LLaMA's generate against a full-context greedy
loop, the fused step against the eager loop, the sampling modes, the
length guard) and tests/test_inference_export.py (GPT's logits through
jit.save / load) run on both packages from the same weights: a Tensor
goes in and a Tensor comes out, logits and gradients within 1e-4 of the
reference's (f32 on the CPU; XLA and torch sum in different orders),
greedy tokens equal (the reference's own rule), sampled tokens equal to
themselves under one seed (the packages draw from different
generators). Then every public method of the reference's model
classes and ``Optimizer`` exists on the port's (the method scan), a
state_dict save / set_state_dict round trip is bit-equal, and
``minimize`` is bit-equal to backward, step, clear_grad."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.jit import InputSpec as JInputSpec
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu_torch import bert_params_from_numpy
from paddle_tpu_torch.jit import InputSpec as TInputSpec
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import generate as tgenerate
from paddle_tpu_torch.models import gpt as tgpt
from torch_port_helpers import cpu_place, jax_state_numpy, twin_gpts, \
    twin_llamas

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _twin_gpts(**kw):
    return twin_gpts(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     **kw)


def test_gpt_forward_shape():
    jm, tm = _twin_gpts()
    ids = _ids(jm.config.vocab_size, (2, 16))
    got = tm(ptt.to_tensor(ids))
    assert isinstance(got, ptt.Tensor)
    assert got.shape == [2, 16, jm.config.vocab_size]
    _close(got.numpy(), jm(pt.to_tensor(ids)).numpy())


def test_gpt_backward():
    jm, tm = _twin_gpts()
    jm.train()
    tm.train()
    ids = _ids(jm.config.vocab_size, (2, 8))
    grads = []
    for P, m, crit in ((pt, jm, jgpt.GPTPretrainingCriterion()),
                       (ptt, tm, tgpt.GPTPretrainingCriterion())):
        x = P.to_tensor(ids)
        loss = crit(m(x)[:, :-1], x[:, 1:])
        loss.backward()
        g = m.gpt.layers[0].attn.qkv_proj.weight.grad
        assert g is not None and np.isfinite(g.numpy()).all()
        grads.append((float(loss.numpy()), g.numpy()))
    assert isinstance(loss, ptt.Tensor)
    _close(grads[1][0], grads[0][0])
    _close(grads[1][1], grads[0][1])


def test_gpt_kv_cache_decode_matches_full():
    jm, tm = _twin_gpts()
    cfg = jm.config
    ids = _ids(cfg.vocab_size, (1, 8))
    steps = []
    for P, m in ((pt, jm), (ptt, tm)):
        x = P.to_tensor(ids)
        full = m(x).numpy()
        caches = [(P.zeros([1, 0, 4, 32]), P.zeros([1, 0, 4, 32]))
                  for _ in range(cfg.num_layers)]
        outs = []
        for t in range(8):
            pos = P.to_tensor(np.array([t], np.int32))
            logits, caches = m(x[:, t:t + 1], position_ids=pos,
                               caches=caches)
            outs.append(logits.numpy())
        step = np.concatenate(outs, axis=1)
        np.testing.assert_allclose(full, step, rtol=2e-4, atol=2e-4)
        steps.append(step)
    assert isinstance(caches[0][0], ptt.Tensor)
    _close(steps[1], steps[0])


def test_llama_forward_backward():
    jm, tm = twin_llamas()
    jm.train()
    tm.train()
    cfg = jm.config
    ids = _ids(cfg.vocab_size, (2, 16))
    out = []
    for P, m in ((pt, jm), (ptt, tm)):
        x = P.to_tensor(ids)
        logits = m(x)
        assert logits.shape == [2, 16, cfg.vocab_size]
        loss = P.ops.cross_entropy(logits[:, :-1], x[:, 1:])
        loss.backward()
        g = m.llama.layers[0].self_attn.q_proj.weight.grad
        assert g is not None and np.isfinite(g.numpy()).all()
        out.append((logits.numpy(), g.numpy()))
    assert isinstance(logits, ptt.Tensor)
    _close(out[1][0], out[0][0])
    _close(out[1][1], out[0][1])


def test_bert_mlm_loss():
    cfg_kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    pt.seed(0)
    jm = jbert.BertForMaskedLM(jbert.bert_tiny(**cfg_kw))
    tm = tbert.BertForMaskedLM(tbert.bert_tiny(**cfg_kw), device="cpu")
    tm.load_state_dict(bert_params_from_numpy(jax_state_numpy(jm)))
    jm.train()
    tm.train()
    ids = _ids(jm.config.vocab_size, (2, 16))
    out = []
    for P, m in ((pt, jm), (ptt, tm)):
        x = P.to_tensor(ids)
        loss, logits = m(x, labels=x, attention_mask=P.ones([2, 16]))
        assert logits.shape == [2, 16, jm.config.vocab_size]
        loss.backward()
        assert np.isfinite(float(loss.numpy()))
        out.append((float(loss.numpy()), logits.numpy(),
                    m.bert.embeddings.word_embeddings.weight.grad.numpy()))
    assert isinstance(loss, ptt.Tensor)
    for a, b in zip(out[1], out[0]):
        _close(a, b)


def _naive_greedy(P, model, ids, n_new):
    ids = np.asarray(ids)
    for _ in range(n_new):
        logits = model(P.to_tensor(ids.astype(np.int32)))
        nxt = np.argmax(np.asarray(logits.numpy())[:, -1], axis=-1)
        ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)], axis=1)
    return ids


def test_llama_generate_matches_full_context():
    jm, tm = twin_llamas(seed=3)
    prompt = _ids(1024, (2, 6), seed=1)
    want = _naive_greedy(ptt, tm, prompt, 6)
    out = tgenerate(tm, ptt.to_tensor(prompt), max_new_tokens=6)
    assert isinstance(out, ptt.Tensor)
    np.testing.assert_array_equal(out.numpy(), want)
    eager = tgenerate(tm, ptt.to_tensor(prompt), max_new_tokens=6,
                      use_fused_step=False)
    np.testing.assert_array_equal(out.numpy(), eager.numpy())
    ref = jgenerate(jm, pt.to_tensor(prompt), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref._data))


def test_fused_step_matches_eager_path():
    jm, tm = _twin_gpts()
    prompt = _ids(1024, (2, 5), seed=3)
    for kw in ({"do_sample": False},
               {"do_sample": True, "top_p": 0.9, "seed": 11},
               {"do_sample": False, "eos_token_id": 13}):
        fused = tgenerate(tm, ptt.to_tensor(prompt), max_new_tokens=8,
                          use_fused_step=True, **kw)
        eager = tgenerate(tm, ptt.to_tensor(prompt), max_new_tokens=8,
                          use_fused_step=False, **kw)
        assert isinstance(fused, ptt.Tensor)
        np.testing.assert_array_equal(fused.numpy(), eager.numpy(),
                                      err_msg=f"diverged for {kw}")
        if not kw["do_sample"]:
            ref = jgenerate(jm, pt.to_tensor(prompt), max_new_tokens=8,
                            **kw)
            np.testing.assert_array_equal(fused.numpy(),
                                          np.asarray(ref._data))


def test_sampling_modes_run():
    _, tm = _twin_gpts()
    prompt = _ids(1024, (2, 4), seed=2)
    outs = [tm.generate(ptt.to_tensor(prompt), max_new_tokens=5,
                        do_sample=True, temperature=0.8, top_p=0.9,
                        seed=3).numpy() for _ in range(2)]
    assert outs[0].shape == (2, 9)
    assert (outs[0][:, :4] == prompt).all()
    assert (outs[0] >= 0).all() and (outs[0] < 1024).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_length_guard():
    jm, tm = _twin_gpts()
    prompt = np.zeros((1, 250), np.int32)
    for P, m in ((pt, jm), (ptt, tm)):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(P.to_tensor(prompt), max_new_tokens=10)


def test_gpt_logits_roundtrip(tmp_path):
    jm, tm = _twin_gpts()
    ids = _ids(1000, (1, 16))
    for P, m, spec in ((pt, jm, JInputSpec), (ptt, tm, TInputSpec)):
        path = str(tmp_path / P.__name__ / "gpt")
        P.jit.save(m, path, input_spec=[spec([1, 16], "int32")])
        ref = m(P.to_tensor(ids)).numpy()
        out = P.jit.load(path)(P.to_tensor(ids)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        if P is pt:
            want = ref
    _close(out, want)


def test_state_dict_round_trip_is_bit_equal(tmp_path):
    """A reference script's ``model.set_state_dict(pt.load(path))``."""
    _, tm = _twin_gpts()
    ids = ptt.to_tensor(_ids(1024, (1, 8)))
    path = str(tmp_path / "gpt.pdparams")
    ptt.save(tm.state_dict(), path)
    fresh = tgpt.GPTForCausalLM(tgpt.gpt_tiny(hidden_dropout_prob=0.0,
                                              attention_dropout_prob=0.0),
                                device="cpu", seed=5)
    fresh.eval()
    assert not np.array_equal(fresh(ids).numpy(), tm(ids).numpy())
    missing, unexpected = fresh.set_state_dict(ptt.load(path))
    assert missing == [] and unexpected == []
    np.testing.assert_array_equal(fresh(ids).numpy(), tm(ids).numpy())


def test_torch_level_calls_stay_unwrapped():
    """The engine's, TrainStep's and chip_smoke.py's torch-level calls
    get torch tensors back, with no dispatch."""
    from paddle_tpu_torch.ops import registry
    _, tm = _twin_gpts()
    n = registry.dispatch_count()
    out = tm(torch.from_numpy(_ids(1024, (1, 8))))
    assert type(out) is torch.Tensor
    assert registry.dispatch_count() == n
    assert all(type(p) is torch.nn.Parameter
               for p in torch.nn.Module.parameters(tm))


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW",
                                  "Adagrad", "RMSProp", "Adadelta",
                                  "Adamax", "Lamb"])
def test_minimize_is_backward_step_clear_grad(name):
    """Each optimizer's inherited ``minimize`` (LBFGS, whose step takes
    a closure, aside): bit-equal to backward, step, clear_grad on the
    port, and within 1e-5 of the reference's minimize."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    results = []
    for P, how in ((ptt, "minimize"), (ptt, "steps"), (pt, "minimize")):
        lin = P.nn.Linear(8, 4)
        lin.weight.set_value(w)
        opt = getattr(P.optimizer, name)(learning_rate=0.1,
                                          parameters=lin.parameters())
        for _ in range(2):
            loss = (lin(P.to_tensor(x)) ** 2).mean()
            if how == "minimize":
                assert opt.minimize(loss) == (None, None)
            else:
                loss.backward()
                opt.step()
                opt.clear_grad()
        assert lin.weight.grad is None or not np.any(
            lin.weight.grad.numpy())
        results.append(lin.weight.numpy())
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], results[2], rtol=1e-5,
                               atol=1e-5)


# the method scan: every public method of a reference class exists on
# the port's, inherited or its own (the scan that found faults 2-4)
MODEL_CLASSES = [
    ("models.gpt", n) for n in (
        "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings",
        "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion")] + [
    ("models.llama", n) for n in (
        "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
        "LlamaForCausalLM")] + [
    ("models.bert", n) for n in (
        "BertEmbeddings", "BertModel", "BertForMaskedLM")] + [
    ("vision.models", n) for n in (
        "BasicBlock", "BottleneckBlock", "ResNet", "MobileNetV2", "LeNet",
        "AlexNet", "VGG", "DenseNet", "SqueezeNet", "MobileNetV1",
        "MobileNetV3", "ShuffleNetV2", "GoogLeNet", "InceptionV3")] + [
    ("optimizer", "Optimizer"), ("distributed", "Group"),
    ("distributed", "DataParallel"),
    ("distributed", "HybridCommunicateGroup")]


def _public_methods(cls):
    return {n for n in dir(cls) if not n.startswith("_")
            and callable(getattr(cls, n, None))}


@pytest.mark.parametrize("module,name", MODEL_CLASSES,
                         ids=[n for _, n in MODEL_CLASSES])
def test_port_class_has_every_reference_method(module, name):
    import importlib
    ref = getattr(importlib.import_module(f"paddle_tpu.{module}"), name)
    port = getattr(importlib.import_module(f"paddle_tpu_torch.{module}"),
                   name)
    missing = _public_methods(ref) - _public_methods(port)
    assert not missing, f"{name} lacks {sorted(missing)}"
    if module.startswith(("models", "vision")):
        assert issubclass(port, ptt.nn.Layer)
