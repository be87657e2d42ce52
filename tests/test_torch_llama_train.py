"""Training paddle_tpu_torch's LLaMA against paddle_tpu's.

The loss is the reference's own test form (tests/test_models.py:89-100):
``cross_entropy(logits[:, :-1], ids[:, 1:])`` of LlamaForCausalLM's
logits, in f32 or under bf16 O1 auto_cast. Models come from
``twin_llamas``: llama_tiny (4 heads, 2 kv heads, head_dim 32; flash
attention takes the composite in both packages at head_dim 32) and its
head_dim 64 variants, GQA 4/2 and MHA, whose flash path runs B1/B2's
plain versions on the CPU (``_FlashCore``), against the reference's
composite. Batch 2, ids from a numpy seed.

Recompute: the reference's LlamaConfig has no recompute option, so a
caller recomputes each decoder layer by wrapping it
(``RecomputedLayer`` below, as chip_smoke.py's LLaMA phase does)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import llama as jllama
from paddle_tpu.optimizer import AdamW as JAdamW
import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed.meta_parallel import recompute
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import jax_state_numpy, twin_llamas
from torch_port_helpers import tnamed, tparams, tstate

LR, STEPS = 1e-3, 3
# (twin_llamas config, use_flash_attention, seq)
CASES = {
    "tiny_gqa": ("tiny_gqa", False, 16),
    "tiny_gqa_flash": ("tiny_gqa", True, 16),
    "d64_gqa": ("d64_gqa", False, 128),
    "d64_gqa_flash": ("d64_gqa", True, 128),
    "d64_mha_flash": ("d64_mha", True, 128),
}
# loss: f32, the same math summed in other orders (measured <= 4.8e-7 of
# ~6.9); bf16 O1, white ops rounded to bf16 at places an ulp apart
# between XLA and torch (measured <= 1.3e-4; GPT's limit,
# tests/test_torch_train_step.py)
LOSS_TOL = {False: dict(rtol=1e-5, atol=0), True: dict(rtol=0, atol=2e-3)}
# each gradient's largest error over its largest element. f32: summation
# order only (measured <= 1.9e-6). bf16 O1: the same ulp-apart roundings
# carried through the backward (measured 0.84-1.22 %, about one bf16
# ulp): 2^-5
GRAD_TOL = {False: 1e-5, True: 2.0 ** -5}


class RecomputedLayer(nn.Module):
    """A decoder layer whose forward the backward recomputes
    (``distributed.meta_parallel.recompute``) while training."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *args):
        if self.training:
            return recompute(self.layer, *args)
        return self.layer(*args)


def _recompute_every_layer(model):
    layers = model.llama.layers
    for i, layer in enumerate(layers):
        layers[i] = RecomputedLayer(layer)
    return model


def _ids(seq, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1024, (2, seq)).astype(np.int32)


def _ref_loss(m, ids, amp_on):
    with pt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        logits = m(ids)
    return pt.ops.cross_entropy(logits[:, :-1], ids[:, 1:])


def _port_loss(m, ids, amp_on):
    with ptt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        logits = m(ids)
    return F.cross_entropy(logits[:, :-1], ids[:, 1:])


def _port_grads(model, ids, amp_on):
    """(loss, [gradient of each parameter, in order]) of one backward."""
    loss = _port_loss(model, torch.as_tensor(ids), amp_on)
    params = list(tparams(model))
    return loss.detach(), torch.autograd.grad(loss, params)


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_reference(case, amp_on):
    name, flash, seq = CASES[case]
    jm, tm = twin_llamas(name, use_flash_attention=flash)
    jm.train()
    tm.train()
    ids = _ids(seq)
    jloss = _ref_loss(jm, pt.to_tensor(ids), amp_on)
    jloss.backward()
    n0 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    loss, grads = _port_grads(tm, ids, amp_on)
    n1 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    # the flash path at head_dim 64 runs B1/B2's plain versions, once a
    # layer each
    calls = tm.config.num_layers if flash and name != "tiny_gqa" else 0
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (calls, calls)
    np.testing.assert_allclose(float(loss), float(jloss.numpy()),
                               **LOSS_TOL[amp_on])
    named = dict(jm.named_parameters())
    names = [n for n, _ in tnamed(tm)]
    assert sorted(names) == sorted(named)
    for n, g in zip(names, grads):
        w = np.asarray(named[n].grad.numpy(), np.float32)
        g = g.float().numpy()
        assert np.isfinite(g).all(), n
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL[amp_on], (n, err)


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
@pytest.mark.parametrize("case", ["tiny_gqa", "d64_gqa_flash"])
def test_train_steps_match_reference(case, amp_on):
    """3 TrainStep calls (AdamW, weight decay 0.01) against the
    reference's TrainStep, held as tests/test_torch_train_step.py holds
    GPT's."""
    name, flash, seq = CASES[case]
    jm, tm = twin_llamas(name, use_flash_attention=flash)
    init = jax_state_numpy(jm)
    jm.train()
    tm.train()
    ids = _ids(seq, seed=1)
    jstep = JTrainStep(jm, JAdamW(learning_rate=LR, weight_decay=0.01,
                                  parameters=jm.parameters()),
                       lambda m, i: _ref_loss(m, i, amp_on))
    want_losses = [float(jstep(ids).numpy()) for _ in range(STEPS)]
    jstep.sync()
    want = jax_state_numpy(jm)
    tstep = ptt.TrainStep(tm, AdamW(learning_rate=LR, weight_decay=0.01,
                                    parameters=tnamed(tm)),
                          lambda m, i: _port_loss(m, i, amp_on))
    got_losses = [float(tstep(ids)) for _ in range(STEPS)]
    got = {k: v.detach().numpy() for k, v in tstate(tm).items()}
    assert all(np.isfinite(got_losses))
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL[amp_on])
    assert sorted(got) == sorted(want)
    bound = 2 * LR * STEPS
    far, moved = 0, 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        # a sign flip of a near-zero gradient moves an Adam parameter by
        # up to ~2 lr a step: nothing may differ by more
        assert d.max() <= bound, (k, d.max())
        far += int((d > 1e-3 * LR).sum())
        moved = max(moved, float(np.abs(w - init[k]).max()))
    assert moved > 0.5 * LR * STEPS
    if not amp_on:
        n = sum(w.size for w in want.values())
        assert far / n < 2e-3, far / n


@pytest.fixture
def one_thread():
    """Bit-equal results need torch's CPU kernels on one thread: with
    several, some sum in an order that depends on the threads
    (tests/test_torch_recompute.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
@pytest.mark.parametrize("case", ["tiny_gqa", "d64_gqa_flash"])
def test_recomputed_layers_equal_the_port_without(case, amp_on, one_thread):
    """Every decoder layer run through recompute: the loss and every
    gradient equal the run without recompute bit for bit (the
    recomputation runs under the forward's AMP state); on the flash path
    B1 runs again in each recomputation, B2 once a layer."""
    name, flash, seq = CASES[case]
    ids = _ids(seq, seed=2)
    _, plain_model = twin_llamas(name, use_flash_attention=flash)
    plain = _port_grads(plain_model.train(), ids, amp_on)
    _, tm = twin_llamas(name, use_flash_attention=flash)
    tm = _recompute_every_layer(tm).train()
    n0 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    loss, grads = _port_grads(tm, ids, amp_on)
    n1 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    layers = tm.config.num_layers if flash else 0
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (2 * layers, layers)
    assert torch.equal(loss, plain[0])
    assert len(grads) == len(plain[1])
    for g, w in zip(grads, plain[1]):
        assert torch.equal(g, w)
    # eval: the wrapper calls the layer itself
    tm.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm(torch.as_tensor(ids)).numpy(),
            plain_model.eval()(torch.as_tensor(ids)).detach().numpy())


def test_llama2_13b_parameter_count():
    """llama2_13b's widths (hidden 5120, 40 heads, FFN 13824, vocab
    32000) at 4 layers, counted on the meta device: 1,596,503,040, the
    count of the reference's module structure (embedding, per layer
    q/k/v/o, gate/up/down and two RMSNorm weights, the final norm, an
    untied head), which the reference's llama_tiny confirms."""
    def formula(c):
        h, kv = c.hidden_size, c.num_kv_heads * c.head_dim
        layer = 2 * h * h + 2 * h * kv + 3 * h * c.intermediate_size + 2 * h
        return 2 * c.vocab_size * h + c.num_layers * layer + h

    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())
    assert formula(jllama.llama_tiny()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())
    cfg = dataclasses.replace(tllama.llama2_13b(), num_layers=4)
    meta = {"device": torch.device("meta"), "dtype": torch.float32}
    model = tllama.LlamaModel(cfg, **meta)
    head = Linear(cfg.hidden_size, cfg.vocab_size, bias_attr=False, **meta)
    count = sum(p.numel() for p in tparams(model)) + \
        head.weight._data.numel()
    assert count == formula(cfg) == formula(dataclasses.replace(
        jllama.llama2_13b(), num_layers=4)) == 1_596_503_040
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (40, 40, 128)
