"""The LSTM language model's TrainStep and flash_attn_unpadded on the
card, at small sizes (chip_smoke.py's phases 24 and 25 run them at full
width). Every test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_rnn_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_HERE = Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", _HERE.parent / "chip_smoke.py")
LM = _load("lstm_lm_script", _HERE / "lstm_lm_script.py")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels and graphs have "
                    "no CPU mode)")
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._current_place
    P.set_device("gpu:0")
    yield P
    tdevice._current_place = saved


V, LAYERS, H, B, S = 1000, 2, 256, 8, 35


@pytest.mark.cuda
def test_lstm_lm_graph_steps_equal_eager_steps(card):
    """3 TrainStep calls through one captured graph (the states carried
    in the tensors each step writes) against 3 of the same step run
    eagerly, f32 with TF32 off, dropout 0: phase 7's rule."""
    P = card
    weights = LM.lm_weights(V, H, LAYERS, seed=0)
    batches = [tuple(torch.as_tensor(a, device="cuda") for a in b)
               for b in LM.lm_batches(V, B, S, 3, seed=0)]
    from paddle_tpu_torch.jit import cuda_graph
    runs = {}
    with cs._f32_exact():
        for eager in (False, True):
            model = LM.lm_from_weights(P, weights, LAYERS, 0.0)
            step, carry = cs.lstm_train_step(model, 1.0, LAYERS, B, H)
            step._eager = eager
            cuda_graph.reset_counters()
            losses = [float(step(*b)) for b in batches]
            runs[eager] = (losses, cs._lm_state(model),
                           dict(cuda_graph.captures), carry[0].clone())
    (gl, gp, gcap, gh), (el, ep, ecap, eh) = runs[False], runs[True]
    assert gcap == {"train_step": 1} and ecap == {}
    assert cs._held_to(gl, el, gp, ep, 1.0, 3)["ok"]
    assert float(gh.abs().sum()) > 0
    torch.testing.assert_close(gh, eh, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_lstm_matches_cudnn_lstm(card):
    """The port's recurrence against torch.nn.LSTM (cuDNN) with the same
    weights, f32 with TF32 off (the gate orders are paddle's and
    torch's alike)."""
    P = card
    port = P.nn.LSTM(64, 128, num_layers=2, time_major=True)
    lib = torch.nn.LSTM(64, 128, num_layers=2).cuda()
    with torch.no_grad():
        for n, p in lib.named_parameters():
            p.copy_(port._parameters[n])
    x = torch.randn(20, 4, 64, device="cuda")
    with cs._f32_exact():
        got, (h, c) = port(x)
        want, (wh, wc) = lib(x)
    for a, b in ((got, want), (h, wh), (c, wc)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded_launches_b1_b2(card, causal):
    """A packed call launches one sm90 B1 and one sm90 B2 with segment
    ids; padding rows and their gradients are exactly 0; the results
    within phase 3's bf16 limit of B1/B2's plain versions (B2's from
    B1's own o and lse, as phase 3 holds them)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    lens = [130, 300, 77, 200]
    cu = np.cumsum([0] + lens).astype(np.int32)
    total = 768
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((total, 12, 64), generator=g, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    cu_t = torch.as_tensor(cu, device="cuda")
    fa.reset_counters()
    out, soft = F.flash_attn_unpadded(qg, kg, vg, cu_t, cu_t, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    assert soft is None
    assert fa.flash_fwd.design_launches == {"sm90": 1, "simple": 0}
    assert fa.flash_bwd.design_launches == {"sm90": 1, "simple": 0}
    assert (fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls) == (0, 0)
    end = int(cu[-1])
    for t in (out, qg.grad, kg.grad, vg.grad):
        assert not bool(t[end:].any())
    sc = 64 ** -0.5
    qs = (q * float(torch.tensor(sc, dtype=q.dtype)))[None]
    seg = F._segments_of(cu_t, total, q.device)
    segs = (seg[None], torch.where(seg < 0, -2, seg)[None])
    o1, lse1 = fa._fwd_cuda(qs, k[None], v[None], causal, segs)
    assert torch.equal(o1[0], out.detach())
    wo, _ = fa.flash_fwd(qs, k[None], v[None], causal, segs, path="torch")
    wdq, wdk, wdv = fa.flash_bwd(qs, k[None], v[None], o1, lse1, do[None],
                                 sc, causal, segs, path="torch")
    for got, want in ((out.detach(), wo), (qg.grad, wdq), (kg.grad, wdk),
                      (vg.grad, wdv)):
        assert cs._norm_err(got[None], want) <= cs.FLASH_TOL["bf16"]
