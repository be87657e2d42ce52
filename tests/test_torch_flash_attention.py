"""paddle_tpu_torch flash attention against paddle_tpu's.

The port's plain versions of B1 (forward) and B2 (FA2 backward) are
held to paddle_tpu's composite `_xla_attention` (and `jax.vjp` of it)
and to its Pallas kernels `_flash_fwd_fused` / `_flash_bwd_fused` run in
interpret mode, on the same numpy inputs. The CUDA kernels themselves
are held to the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as F

jfa = importlib.import_module("paddle_tpu.kernels.pallas.flash_attention")

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# f32: XLA and torch sum in different orders (~1e-6 at these sizes).
# bf16: both sides round p (and the output) to bf16, at different points
# (the composite normalises before the cast, the flash math after), so
# outputs of order 1 differ by a few bf16 ulps (2^-8 = 3.9e-3 each).
# f16: the same roundings with 3 more mantissa bits, a few f16 ulps
# (2^-11 = 4.9e-4 each)
TOL = {"f32": dict(rtol=1e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2),
       "f16": dict(rtol=2.5e-3, atol=2.5e-3)}
# gradients in bf16 carry the cast of p and ds before each product and
# the rounding of dk/dv/dq themselves, on values of order 1-10; f16 the
# same casts 8x finer
GTOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=4e-2, atol=8e-2),
        "f16": dict(rtol=5e-3, atol=1e-2)}


def _inputs(b, sq, sk, h, hk, d, seed=0, seg=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    segs = None
    if seg:
        # batch 0: two packed sequences and padding (-1); batch 1: one
        # sequence whose last keys belong to no query (rows fully masked
        # at the tail of the queries)
        def ids(n, cuts):
            out = np.full(n, -1, np.int32)
            lo = 0
            for i, c in enumerate(cuts):
                out[lo:c] = i
                lo = c
            return out
        qs = np.stack([ids(sq, [sq * 2 // 5, sq * 3 // 4]),
                       ids(sq, [sq // 2])])
        ks = np.stack([ids(sk, [sk * 2 // 5, sk * 3 // 4]),
                       np.concatenate([np.zeros(sk // 2, np.int32),
                                       np.full(sk - sk // 2, 7, np.int32)])])
        segs = (qs, ks)
    return q, k, v, do, segs


def _j(a, dt):
    return jnp.asarray(a, JDT[dt])


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = {
    # name: (b, sq, sk, h, hk, causal, seg)
    "causal": (2, 256, 256, 4, 4, True, False),
    "noncausal": (2, 128, 128, 4, 4, False, False),
    "gqa_hk2": (2, 256, 256, 4, 2, True, False),
    "mqa_hk1": (1, 128, 128, 4, 1, False, False),
    "segments": (2, 256, 256, 2, 2, True, True),
    "cross_sq_lt_sk": (1, 128, 256, 2, 2, True, False),
    "cross_sq_gt_sk": (1, 256, 128, 2, 2, True, False),   # rows fully masked
}


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_composite_and_vjp(name, dt):
    """The port's flash_attention on CPU (its plain B1/B2 behind
    _FlashCore) against paddle_tpu's composite and jax.vjp of it."""
    b, sq, sk, h, hk, causal, seg = CASES[name]
    d = 64
    q, k, v, do, segs = _inputs(b, sq, sk, h, hk, d, seed=len(name), seg=seg)
    sc = 1.0 / np.sqrt(d)
    jseg = None if segs is None else tuple(jnp.asarray(s) for s in segs)

    def comp(q_, k_, v_):
        return jfa._xla_attention(q_, k_, v_, None, causal, sc,
                                  segment_ids=jseg)

    want, vjp = jax.vjp(comp, _j(q, dt), _j(k, dt), _j(v, dt))
    wq, wk, wv = vjp(_j(do, dt))
    tq, tk, tv = (_t(a, dt).requires_grad_() for a in (q, k, v))
    assert tfa.attention_path(tq.shape, tk.shape, device="cpu")[0] == "torch"
    n0 = tfa.flash_fwd.plain_calls
    got = tfa.flash_attention(tq, tk, tv, causal=causal, segment_ids=segs)
    assert tfa.flash_fwd.plain_calls == n0 + 1
    got.backward(_t(do, dt))
    assert got.dtype == TDT[dt] and tq.grad.dtype == TDT[dt]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])
    for g, w in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        np.testing.assert_allclose(_np(g), _np(w), **GTOL[dt])
    if name == "cross_sq_gt_sk":
        # queries 0..127 see no key: zero output and zero gradients
        assert (got[:, :sq - sk] == 0).all()
        assert (tq.grad[:, :sq - sk] == 0).all()


# the interpret-mode Pallas kernels, the same inputs
IN_CASES = {
    "s128_causal": (2, 128, 128, 4, 4, True, False),
    "s256_noncausal": (1, 256, 256, 4, 4, False, False),
    "s256_gqa_hk2_causal": (1, 256, 256, 4, 2, True, False),
    "s128_mqa_hk1": (1, 128, 128, 4, 1, False, False),
    "s256_segments_causal": (2, 256, 256, 2, 2, True, True),
    "cross_128_256_causal": (1, 128, 256, 2, 2, True, False),
    "cross_256_128_causal": (1, 256, 128, 2, 2, True, False),
}


def _fused(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(IN_CASES))
def test_plain_kernels_match_pallas_interpret(name, dt):
    b, sq, sk, h, hk, causal, seg = IN_CASES[name]
    d = 64
    q, k, v, do, segs = _inputs(b, sq, sk, h, hk, d, seed=3 + len(name),
                                seg=seg)
    sc = 1.0 / np.sqrt(d)
    jseg = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    jq = _j(q, dt)
    jqs = (jq * sc).astype(jq.dtype)
    jo, jlse = jfa._flash_fwd_fused(
        _fused(jqs), _fused(_j(k, dt)), _fused(_j(v, dt)), h, causal,
        interpret=True, Hk=hk, segment_ids=jseg)
    jdq, jdk, jdv = jfa._flash_bwd_fused(
        _fused(jqs), _fused(_j(k, dt)), _fused(_j(v, dt)), jo, jlse,
        _fused(_j(do, dt)), h, causal, interpret=True, Hk=hk,
        segment_ids=jseg)
    jdq = (jdq * sc).astype(jq.dtype)

    tq = _t(q, dt)
    tqs = tq * torch.tensor(sc, dtype=tq.dtype)
    # the same pre-scaled q on both sides (bit for bit)
    np.testing.assert_array_equal(_np(tqs), _np(jqs))
    tseg = None if segs is None else tuple(torch.from_numpy(s) for s in segs)
    to, tlse = tfa.flash_fwd(tqs, _t(k, dt), _t(v, dt), causal, tseg,
                             path="torch")
    assert to.dtype == TDT[dt] and tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo).reshape(b, sq, h, d),
                               **TOL[dt])
    # the reference copies each lse row over 8 sublanes
    np.testing.assert_allclose(tlse.numpy(), _np(jlse)[:, ::8, :],
                               rtol=1e-5, atol=1e-4)
    # backward from the reference's own (o, lse), so only B2 differs
    tdq, tdk, tdv = tfa.flash_bwd(
        tqs, _t(k, dt), _t(v, dt), _t(_np(jo).reshape(b, sq, h, d), dt),
        torch.from_numpy(_np(jlse)[:, ::8, :].copy()), _t(do, dt), sc,
        causal, tseg, path="torch")
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert got.dtype == TDT[dt]
        np.testing.assert_allclose(_np(got), _np(want).reshape(got.shape),
                                   **GTOL[dt])


@pytest.mark.parametrize("kind", ["causal", "cross_sq_gt_sk",
                                  "cross_sq_lt_sk", "gqa_segments"])
def test_flash_core_gradcheck_f64(kind):
    """_FlashCore's backward (the plain B2) against finite differences
    of its forward (the plain B1), in f64 at a tiny shape (the plain
    versions take any shape; the kernels' gates live in
    flash_attention)."""
    sq, sk, h, hk, seg, causal = {
        "causal": (4, 4, 2, 2, False, True),
        "cross_sq_gt_sk": (5, 3, 2, 1, False, True),
        "cross_sq_lt_sk": (3, 5, 2, 2, False, True),
        "gqa_segments": (4, 4, 4, 2, True, False)}[kind]
    rng = np.random.default_rng(5)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()
    q, k, v = mk(1, sq, h, 3), mk(1, sk, hk, 3), mk(1, sk, hk, 3)
    qseg = kseg = None
    if seg:
        qseg = torch.tensor([[0, 0, 1, 2]], dtype=torch.int32)
        kseg = torch.tensor([[0, 1, 1, 1]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: tfa._FlashCore.apply(q_, k_, v_, qseg, kseg,
                                                causal, 0.7),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_attention_path_gates():
    cuda, cpu = "cuda", "cpu"
    assert tfa.attention_path((16, 1024, 12, 64), (16, 1024, 12, 64),
                              device=cuda) == ("cuda", "")
    path, why = tfa.attention_path((2, 256, 4, 64), (2, 256, 4, 64),
                                   device=cpu)
    assert path == "torch" and "CPU" in why
    path, why = tfa.attention_path((2, 256, 4, 64), (2, 256, 4, 64),
                                   masked=True)
    assert path == "composite" and "attn_mask" in why
    for qs, ks, word in (((2, 256, 4, 32), (2, 256, 4, 32), "head_dim"),
                         ((2, 100, 4, 64), (2, 100, 4, 64), "seq"),
                         ((2, 256, 4, 64), (2, 384, 4, 64), None),
                         ((2, 256, 4, 64), (2, 256, 3, 64), "kv heads")):
        path, why = tfa.attention_path(qs, ks, device=cuda)
        if word is None:            # cross-length multiples of 128: kernel
            assert path == "cuda"
            continue
        assert path == "composite" and word in why
        # the reference refuses the same shapes
        assert jfa._shape_reject_reason(qs, ks)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "simple"), (torch.float32, 64, "simple"),
    (torch.float32, 128, "simple"), (torch.float32, 256, "simple"),
    (torch.float16, 64, "sm90"), (torch.float16, 128, "sm90"),
    (torch.float16, 256, "simple")])
def test_b1_design_selection(dtype, d, want):
    """B1's sm90 kernel takes bf16 and f16 at head_dim 64 and 128, the
    simple kernel (flash_attention.cu) the rest; `design` forces the
    simple kernel anywhere, refuses sm90 where it does not apply, and
    raises on an unknown name."""
    assert tfa._fwd_design(dtype, d) == want
    assert tfa._fwd_design(dtype, d, "simple") == "simple"
    if want == "sm90":
        assert tfa._fwd_design(dtype, d, "sm90") == "sm90"
    else:
        with pytest.raises(ValueError, match="sm90"):
            tfa._fwd_design(dtype, d, "sm90")
    with pytest.raises(ValueError, match="unknown B1 design"):
        tfa._fwd_design(dtype, d, "wgmma")


def test_b1_counters_reset_per_design():
    """reset_counters zeroes every B1/B2 counter, B1's per design too."""
    tfa.flash_fwd.design_launches["sm90"] += 3
    tfa.flash_bwd.kernel_launches += 1
    tfa.reset_counters()
    assert tfa.flash_fwd.design_launches == {"sm90": 0, "simple": 0}
    assert (tfa.flash_fwd.kernel_launches, tfa.flash_bwd.kernel_launches,
            tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls) == (0,) * 4


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "simple"), (torch.float32, 64, "simple"),
    (torch.float32, 128, "simple"), (torch.float32, 256, "simple"),
    (torch.float16, 64, "sm90"), (torch.float16, 128, "sm90"),
    (torch.float16, 256, "simple")])
def test_b2_design_selection(dtype, d, want):
    """B2's sm90 kernel (flash_bwd_sm90.cu) takes bf16 and f16 at
    head_dim 64 and 128, the simple kernels (flash_attention.cu) the rest;
    `design` forces the simple kernels anywhere, refuses sm90 where it
    does not apply, and raises on an unknown name."""
    assert tfa._bwd_design(dtype, d) == want
    assert tfa._bwd_design(dtype, d, "simple") == "simple"
    if want == "sm90":
        assert tfa._bwd_design(dtype, d, "sm90") == "sm90"
    else:
        with pytest.raises(ValueError, match="B2's sm90"):
            tfa._bwd_design(dtype, d, "sm90")
    with pytest.raises(ValueError, match="unknown B2 design"):
        tfa._bwd_design(dtype, d, "wgmma")


def test_b2_counters_reset_per_design():
    """reset_counters zeroes B2's launches per design too."""
    tfa.flash_bwd.design_launches["sm90"] += 2
    tfa.flash_bwd.design_launches["simple"] += 1
    tfa.reset_counters()
    assert tfa.flash_bwd.design_launches == {"sm90": 0, "simple": 0}
    assert tfa.flash_fwd.design_launches == {"sm90": 0, "simple": 0}


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (1, 256, 2, 128)])
def test_delta_plain_form_matches_reference_einsum(shape, dt):
    """delta = rowsum(do·o) in f32, laid out like lse [b, H, sq]: the
    port's plain form (what flash_bwd_sm90.cu's delta kernel is held to
    on the card) against the reference's jnp.einsum over f32 copies
    (flash_attention.py:521-523). Both sum the same f32 products of the
    same values in other orders."""
    rng = np.random.default_rng(11)
    do = rng.standard_normal(shape).astype(np.float32)
    o = rng.standard_normal(shape).astype(np.float32)
    jdo, jo = (jnp.asarray(x, JDT[dt]) for x in (do, o))
    want = jnp.einsum("bshd,bshd->bhs", jdo.astype(jnp.float32),
                      jo.astype(jnp.float32))
    tdo, to = (torch.from_numpy(x).to(TDT[dt]) for x in (do, o))
    got = tfa._delta_reference(tdo, to)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_delta_kernel_refuses_mismatched_operands():
    """The delta kernel's wrapper checks do and o against each other
    before it passes a pointer (raised here before any build)."""
    with pytest.raises(ValueError, match="differ"):
        tfa._delta_cuda(torch.zeros(1, 128, 2, 64),
                        torch.zeros(1, 128, 2, 128))


@pytest.mark.parametrize("qs,ks", [((2, 256, 3, 64), (2, 256, 3, 64)),
                                   ((2, 256, 8, 64), (2, 256, 1, 64))])
def test_tpu_lane_rule_is_dropped(qs, ks):
    """(h*d) % 128 and (hk*d) % 128 are TPU lane rules: the reference
    refuses these shapes, the CUDA kernels take them."""
    assert "lane" in jfa._shape_reject_reason(qs, ks)
    assert tfa._shape_reject_reason(qs, ks) is None


SDPA_CALLS = [
    # (q shape, k shape, mask, dropout_p, training)
    ((2, 256, 4, 64), (2, 256, 4, 64), False, 0.0, True),
    ((2, 256, 4, 64), (2, 256, 4, 64), False, 0.1, True),
    ((2, 256, 4, 64), (2, 256, 4, 64), False, 0.1, False),
    ((2, 256, 4, 64), (2, 256, 4, 64), True, 0.0, True),
    ((2, 192, 4, 64), (2, 192, 4, 64), False, 0.0, True),
    ((2, 256, 4, 32), (2, 256, 4, 32), False, 0.0, True),
    ((2, 128, 2, 128), (2, 256, 2, 128), False, 0.0, False),
]


@pytest.mark.parametrize("call", range(len(SDPA_CALLS)))
def test_sdpa_routing_matches_reference(monkeypatch, call):
    """The routing of nn_ops.py:869-874: the reference's decision is read
    by running its op with the TPU kernel reported available and a spy in
    the kernel's place (its op body, so no cached executable stands in
    between); the port's is the test its SDPA applies to CUDA tensors."""
    qs, ks, masked, p, training = SDPA_CALLS[call]
    from paddle_tpu.kernels import pallas as pk
    from paddle_tpu.ops import nn_ops
    taken = []

    def spy(q, k, v, causal=False, **kw):
        taken.append(True)
        return q

    monkeypatch.setattr(jfa, "_pallas_available", lambda: True)
    monkeypatch.setattr(pk, "flash_attention", spy)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal(qs), jnp.float32)
    k = jnp.asarray(rng.standard_normal(ks), jnp.float32)
    mask = jnp.ones((qs[1], ks[1]), bool) if masked else None
    nn_ops.scaled_dot_product_attention.raw_fn(
        q, k, k, attn_mask=mask, dropout_p=p, is_causal=True,
        training=training)
    port = F._sdpa_takes_kernel(qs, ks, mask, p, training)
    assert port == bool(taken)


def test_sdpa_on_cpu_keeps_the_composite():
    """CPU tensors never reach the kernels' plain versions through SDPA
    (the reference runs its composite off the TPU too)."""
    q, k, v, _, _ = _inputs(1, 128, 128, 2, 2, 64)
    n0 = tfa.flash_fwd.plain_calls
    out = F.scaled_dot_product_attention(_t(q, "f32"), _t(k, "f32"),
                                         _t(v, "f32"), is_causal=True)
    assert tfa.flash_fwd.plain_calls == n0
    want = jfa._xla_attention(_j(q, "f32"), _j(k, "f32"), _j(v, "f32"),
                              None, True, 1 / 8.0)
    np.testing.assert_allclose(_np(out), _np(want), **TOL["f32"])
