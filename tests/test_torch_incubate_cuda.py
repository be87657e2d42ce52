"""incubate on the card (marked cuda: skips without one): the registered
fused functionals, memory_efficient_attention and fused_multi_transformer
on CUDA Tensors against their plain versions (the same calls on CPU
tensors), with the kernels' launch counters read around each call. This
file imports no JAX: the card's machine has none."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.incubate.nn import attn_bias
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import norms

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _pair(a, grad=False):
    """(CUDA Tensor, CPU Tensor) of the same array."""
    out = []
    for dev in ("cuda", "cpu"):
        t = torch.from_numpy(a).to(dev)
        out.append(Tensor._wrap(t.requires_grad_() if grad else t))
    return out


def _counts():
    return (fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches,
            norms.layer_norm_fwd.kernel_launches,
            norms.rms_norm_fwd.kernel_launches, fa.flash_fwd.plain_calls,
            fa.flash_bwd.plain_calls, norms.layer_norm_fwd.plain_calls,
            norms.rms_norm_fwd.plain_calls)


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counts()))


def test_fused_norms_on_tensors_launch_b4_and_b5():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 768)).astype(np.float32)
    w, b = (rng.standard_normal(768).astype(np.float32) for _ in range(2))
    (xg, xc), (wg, wc), (bg, bc) = _pair(x), _pair(w), _pair(b)
    n = _counts()
    got = (IF.fused_layer_norm(xg, wg, bg), IF.fused_rms_norm(xg, wg))
    assert _delta(n)[:8] == (0, 0, 1, 1, 0, 0, 0, 0)
    want = (IF.fused_layer_norm(xc, wc, bc), IF.fused_rms_norm(xc, wc))
    for g, w_ in zip(got, want):
        assert isinstance(g, Tensor) and g._data.is_cuda
        torch.testing.assert_close(g._data.cpu(), w_._data, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_flash_attention_tensor_call_launches_b1_and_b2(dtype):
    """bf16 takes the sm90 designs, f32 the simple ones; forward and
    grads against the CPU's plain versions (f32 1e-4; bf16 2^-6 of the
    values' scale, both sides rounding p to bf16 differently)."""
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal((2, 256, 4, 64)) * 0.5).astype(
        np.float32) for _ in range(4)]
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    outs = []
    n = _counts()
    for dev in ("cuda", "cpu"):
        q, k, v = (Tensor._wrap(torch.from_numpy(a).to(dev, getattr(
            torch, dtype)).requires_grad_()) for a in arrays[:3])
        out = IF.fused_flash_attention(q, k, v, causal=True)
        (out * Tensor._wrap(torch.from_numpy(arrays[3]).to(
            dev, out._data.dtype))).sum().backward()
        outs.append([out._data] + [t.grad._data for t in (q, k, v)])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _delta(n)[:2] == (1, 1) and _delta(n)[4:6] == (0, 0)
    for g, w in zip(*outs):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float().cpu(), w.float(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("kind", ["none", "lower", "block_causal",
                                  "block_causal_kv"])
def test_memory_efficient_attention_on_the_card(kind):
    """f32 (B1/B2's simple designs, or the composite for a materialised
    mask) against the CPU within 1e-4: B1 runs except where the mask is
    materialised (different q and kv packings)."""
    rng = np.random.default_rng(2)
    q, k, v, cot = ((rng.standard_normal((1, 256, 2, 64)) * 0.5).astype(
        np.float32) for _ in range(4))
    bias = {"none": None, "lower": attn_bias.LowerTriangularMask(),
            "block_causal": attn_bias.BlockDiagonalCausalMask.from_seqlens(
                [100, 28, 128]),
            "block_causal_kv": attn_bias.BlockDiagonalCausalMask
            .from_seqlens([100, 28, 128], [128, 64, 64])}[kind]
    outs = []
    n = _counts()
    for dev in ("cuda", "cpu"):
        ts = [Tensor._wrap(torch.from_numpy(a).to(dev).requires_grad_())
              for a in (q, k, v)]
        out = P.incubate.nn.memory_efficient_attention(*ts, attn_bias=bias)
        (out * Tensor._wrap(torch.from_numpy(cot).to(dev))).sum() \
            .backward()
        outs.append([out._data] + [t.grad._data for t in ts])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _delta(n)[0] == (0 if kind == "block_causal_kv" else 1)
            assert _delta(n)[4:6] == (0, 0)
    for g, w in zip(*outs):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def _mt_weights(rng, layers, dm, heads, ffn, dtype):
    hd = dm // heads
    g = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(
        np.float32)).to(dtype)
    return dict(
        ln_scales=[1 + g(dm) for _ in range(layers)],
        ln_biases=[g(dm) for _ in range(layers)],
        qkv_weights=[g(3, heads, hd, dm) for _ in range(layers)],
        qkv_biases=[g(3, heads, hd) for _ in range(layers)],
        linear_weights=[g(dm, dm) for _ in range(layers)],
        linear_biases=[g(dm) for _ in range(layers)],
        ffn_ln_scales=[1 + g(dm) for _ in range(layers)],
        ffn_ln_biases=[g(dm) for _ in range(layers)],
        ffn1_weights=[g(dm, ffn) for _ in range(layers)],
        ffn1_biases=[g(ffn) for _ in range(layers)],
        ffn2_weights=[g(ffn, dm) for _ in range(layers)],
        ffn2_biases=[g(dm) for _ in range(layers)])


def _on(w, dev):
    return {k: [t.to(dev) for t in v] for k, v in w.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_multi_transformer_on_the_card(dtype):
    """2 layers, d_model 256, 4 heads of 64: a prefill and 3 decode
    steps on the card against the same calls on the CPU (the bf16
    weights' products give f32 on both: cuBLAS's f32-output GEMM on the
    card, the f32 product of the same values on the CPU), and the card's
    decode steps against its own full forward; the caches written in
    place. f32 within 1e-4 (TF32 off); bf16 within 2^-6 of the values'
    scale."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    w = _mt_weights(rng, 2, 256, 4, 512, tdt)
    x = torch.from_numpy(rng.standard_normal((2, 9, 256)).astype(
        np.float32)).to(tdt)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    runs = {}
    for dev in ("cuda", "cpu"):
        wd, xd = _on(w, dev), x.to(dev)
        caches = [torch.zeros((2, 2, 4, 12, 64), dtype=tdt, device=dev)
                  for _ in range(2)]
        out, got = IF.fused_multi_transformer(xd[:, :6], cache_kvs=caches,
                                              **wd)
        assert all(g is c for g, c in zip(got, caches))
        dec = []
        for t in range(6, 9):
            o, caches = IF.fused_multi_transformer(
                xd[:, t:t + 1], cache_kvs=caches, time_step=torch.tensor(t),
                **wd)
            dec.append(o[:, 0])
        full = IF.fused_multi_transformer(xd, **wd)
        runs[dev] = (out, torch.stack(dec, 1), full, caches)
    out, dec, full, caches = runs["cuda"]
    scale = float(full.float().abs().max())
    for g, w_ in ((out, full[:, :6]), (dec, full[:, 6:])):
        torch.testing.assert_close(g.float(), w_.float(), rtol=tol,
                                   atol=tol * scale)
    for g, w_ in zip(runs["cuda"][:3], runs["cpu"][:3]):
        torch.testing.assert_close(g.float().cpu(), w_.float(), rtol=tol,
                                   atol=tol * scale)
    for g, w_ in zip(caches, runs["cpu"][3]):
        torch.testing.assert_close(g.float().cpu(), w_.float(), rtol=tol,
                                   atol=tol * 4)


def test_encoder_layer_training_step_on_tensors_launches_the_kernels():
    """One eager step of a bf16 O1 FusedTransformerEncoderLayer on CUDA
    Tensors (attention dropout 0): B1, B2 once, B4 twice, all sm90, no
    plain version; the update through LookAhead(AdamW) and asp."""
    from paddle_tpu_torch.incubate import asp
    layer = P.incubate.nn.FusedTransformerEncoderLayer(
        256, 4, 512, dropout_rate=0.1, attn_dropout_rate=0.0,
        device="cuda", init_generator=torch.Generator("cuda").manual_seed(0),
        generator=torch.Generator("cuda").manual_seed(1))
    asp.reset_excluded_layers()
    asp.set_excluded_layers([n for n, _ in layer.named_parameters()
                             if "fused_attn" in n])
    masks = asp.prune_model(layer)
    opt = asp.decorate(P.incubate.LookAhead(P.optimizer.AdamW(
        learning_rate=1e-3, parameters=layer.parameters()), k=1))
    x = Tensor._wrap(torch.randn(2, 256, 256, device="cuda"))
    fa.reset_counters()
    n = _counts()
    with P.amp.auto_cast(level="O1"):
        loss = P.incubate.identity_loss((layer(x) - 1.0) ** 2, "mean")
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    assert _delta(n) == (1, 1, 2, 0, 0, 0, 0, 0)
    assert fa.flash_fwd.design_launches["sm90"] == 1
    assert fa.flash_bwd.design_launches["sm90"] == 1
    for name in masks:
        p = dict(layer.named_parameters())[name]._data
        assert bool(((p.reshape(-1, 4) != 0).sum(-1) <= 2).all())
    asp.reset_excluded_layers()
    asp._masks.clear()
