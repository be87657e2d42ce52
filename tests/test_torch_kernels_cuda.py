"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention)
from paddle_tpu_torch.nn import functional as F


# chip_smoke.py, for its phase 2 checks (B3's limits and planted faults)
# and its phase 3 cases
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _packed_case(H=4, Hk=2, D=128, bs=8, NB=16, int8=False, dtype=np.float32,
                 interleave=False, seed=0, spec=None, T=64):
    """Rows of every kind the engine ships (fresh prefill, one decode
    token, a short window, a prefix-resume tail, an empty slot) on
    randomly placed pages, with dead padding at the end; `interleave`
    shuffles the packed tokens so rows are not contiguous. `spec`:
    (cached, new) tokens per row in place of those."""
    rng = np.random.default_rng(seed)
    spec = spec or [(0, 20), (24, 1), (10, 5), (16, 7), (0, 0)]
    B = len(spec)
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    c = 0
    for b, (cached, m) in enumerate(spec):
        if not m:
            continue
        rows[c:c + m] = b
        pos[c:c + m] = cached + np.arange(m)
        kv_start[b] = cached
        pages = [free.pop() for _ in range(-(-(cached + m) // bs))]
        off[b, pages] = np.arange(len(pages)) * bs
        c += m
    if interleave:
        order = rng.permutation(T)
        rows, pos = rows[order], pos[order]

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    case = dict(q=rnd(T, H, D), k_new=rnd(T, Hk, D), v_new=rnd(T, Hk, D),
                rows=rows, pos=pos, kv_start=kv_start, off=off, kdq=None,
                vdq=None)
    if int8:
        for k in ("kpool", "vpool"):
            case[k] = rng.integers(-127, 128, (NB * bs, Hk, D)).astype(
                np.int8)
        case["kdq"] = rng.uniform(0.01, 0.05, (Hk,)).astype(np.float32)
        case["vdq"] = rng.uniform(0.01, 0.05, (Hk,)).astype(np.float32)
    else:
        case["kpool"] = rnd(NB * bs, Hk, D)
        case["vpool"] = rnd(NB * bs, Hk, D)
    return case, dict(block_size=bs, scale=1.0 / np.sqrt(D))


_ARR = ("q", "k_new", "v_new", "kpool", "vpool", "rows", "pos",
        "kv_start", "off")


def _args(case, dev, torch_dtype, upcast=False):
    def t(a):
        x = torch.as_tensor(a.astype(np.float32) if a.dtype.kind == "f"
                            else a, device=dev)
        if a.dtype.kind == "f" and a.ndim == 3:
            x = x.to(torch.float32 if upcast else torch_dtype)
        return x
    args = [t(case[k]) for k in _ARR]
    dq = {k: None if case[k] is None else t(case[k]) for k in ("kdq", "vdq")}
    return args, dq


def _run(case, kw, dev, path, torch_dtype, with_pool=True, upcast=False,
         design=None):
    args, dq = _args(case, dev, torch_dtype, upcast)
    if design is not None:
        return rpa._ragged_cuda(*args, **kw, **dq, with_pool=with_pool,
                                design=design)
    return ragged_paged_attention(*args, **kw, **dq, with_pool=with_pool,
                                  path=path)


def _rounded(case, tdt):
    """The case with its float tensors rounded to `tdt` (what the kernel
    reads), for the plain version in f32 on the same values."""
    return {k: (torch.as_tensor(v).to(tdt).float().numpy()
                if isinstance(v, np.ndarray) and v.dtype.kind == "f"
                and v.ndim == 3 else v) for k, v in case.items()}


def _sm90_limit(case, kw, dev, with_pool=True, tdt=torch.bfloat16):
    """(the plain version in f32 on the values rounded to `tdt` (bf16 or
    f16), the sm90 design's limit): KERNEL_ATOL, or twice the reference's
    own rounding (the plain version in its cast order, q·scale and p cast
    to `tdt`, against f32) where that is larger. The kernel keeps q exact
    and rounds only p, so it may be no further from exact than twice the
    reference."""
    want = _run(_rounded(case, tdt), kw, dev, "torch", tdt, with_pool,
                upcast=True)
    ref = _run(case, kw, dev, "torch", tdt, with_pool)
    return want, max(cs.KERNEL_ATOL, 2 * float((ref - want).abs().max()))


KINDS = {
    "f32": dict(dtype=torch.float32),
    "bf16": dict(dtype=torch.bfloat16),
    "bf16_int8_pool": dict(dtype=torch.bfloat16, int8=True),
    "f16": dict(dtype=torch.float16),
    "f16_int8_pool": dict(dtype=torch.float16, int8=True),
    "f16_gqa_d64": dict(dtype=torch.float16, H=8, Hk=2, D=64),
    "f32_int8_pool": dict(dtype=torch.float32, int8=True),
    "gqa_d64": dict(dtype=torch.bfloat16, H=8, Hk=2, D=64),
    "mqa_d256": dict(dtype=torch.bfloat16, H=4, Hk=1, D=256),
    "interleaved": dict(dtype=torch.bfloat16, interleave=True),
    "no_pool": dict(dtype=torch.bfloat16, with_pool=False),
}
# the kinds the sm90 design takes: bf16 or f16 q over pools of its dtype
# at head_dim 64 / 128
SM90_KINDS = {"bf16", "gqa_d64", "interleaved", "no_pool", "f16",
              "f16_gqa_d64"}


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["sm90", "simple"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ragged_kernel_matches_plain(cuda_device, kind, design):
    """Each design, forced through the private design argument, against
    the plain version in f32 on the same (bf16- or f16-rounded) values.
    The simple design computes in f32 too, so only the summation order
    differs (1e-4); the sm90 design rounds p to the input dtype before
    P·V and is held to _sm90_limit. Forcing sm90 on a kind it does not take
    raises."""
    spec = dict(KINDS[kind])
    tdt = spec.pop("dtype")
    with_pool = spec.pop("with_pool", True)
    case, kw = _packed_case(**spec)
    if design == "sm90" and kind not in SM90_KINDS:
        with pytest.raises(ValueError, match="sm90 design takes"):
            _run(case, kw, cuda_device, "cuda", tdt, with_pool,
                 design=design)
        return
    n0 = ragged_paged_attention.kernel_launches
    d0 = dict(ragged_paged_attention.design_launches)
    got = _run(case, kw, cuda_device, "cuda", tdt, with_pool, design=design)
    torch.cuda.synchronize()
    assert ragged_paged_attention.kernel_launches == n0 + 1
    assert {d: n - d0[d] for d, n in
            ragged_paged_attention.design_launches.items()} == {
        d: int(d == design) for d in d0}
    want = _run(_rounded(case, tdt), kw, cuda_device, "torch", tdt,
                with_pool, upcast=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if design == "simple":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _, lim = _sm90_limit(case, kw, cuda_device, with_pool, tdt)
        assert float((got - want).abs().max()) <= lim
    dead = torch.as_tensor(case["rows"] < 0, device=cuda_device)
    assert (got[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS) + ["unaligned"])
def test_ragged_design_by_kind(cuda_device, kind):
    """The dispatcher runs sm90 for bf16 or f16 q over pools of its dtype
    at head_dim 64 and 128 with 16-byte aligned token rows, and the
    simple design for every other kind: f32, int8 pools, head_dim 256,
    and q/k/v views whose token stride is not a multiple of 16 bytes."""
    spec = dict(KINDS["bf16" if kind == "unaligned" else kind])
    tdt = spec.pop("dtype")
    with_pool = spec.pop("with_pool", True)
    case, kw = _packed_case(**spec)
    args, dq = _args(case, cuda_device, tdt)
    if kind == "unaligned":
        # views into a projection with 2 extra columns a token
        for i in range(3):
            x = args[i]
            wide = torch.zeros((x.shape[0], x.shape[1] * x.shape[2] + 2),
                               dtype=x.dtype, device=cuda_device)
            wide[:, :-2] = x.reshape(x.shape[0], -1)
            args[i] = wide[:, :-2].reshape(x.shape)
    d0 = dict(ragged_paged_attention.design_launches)
    ragged_paged_attention(*args, **kw, **dq, with_pool=with_pool,
                           path="cuda")
    torch.cuda.synchronize()
    want = "sm90" if kind in SM90_KINDS else "simple"
    assert {d: n - d0[d] for d, n in
            ragged_paged_attention.design_launches.items()} == {
        d: int(d == want) for d in d0}


# the engine's head counts (gpt3_1p3b 16/16, llama2_7b 32/32 and its GQA
# variant 32/8 at D 128, gpt2_small 12/12 at D 64), rows long enough for
# several q tiles and pool key tiles, partial last pages
ENGINE_HEADS = [(16, 16, 128), (32, 32, 128), (32, 8, 128), (12, 12, 64)]
LONG_SPEC = [(0, 150), (130, 70), (0, 0), (37, 1), (64, 33), (200, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("heads", ENGINE_HEADS, ids=str)
def test_ragged_sm90_engine_shapes_strided_views(cuda_device, heads, bs,
                                                 dtype):
    """sm90 at the engine's head counts on q/k/v views of one fused qkv
    projection (as LLMEngine hands them), interleaved packing, block
    sizes 16 and 64, bf16 and f16, against the plain version within
    _sm90_limit."""
    tdt = LOWP[dtype]
    H, Hk, D = heads
    case, kw = _packed_case(H=H, Hk=Hk, D=D, bs=bs, NB=64, spec=LONG_SPEC,
                            T=384, interleave=True, seed=H + bs)
    T = case["q"].shape[0]
    qkv = torch.as_tensor(np.concatenate(
        [case["q"].reshape(T, -1), case["k_new"].reshape(T, -1),
         case["v_new"].reshape(T, -1)], axis=1),
        device=cuda_device).to(tdt)
    q = qkv[:, :H * D].reshape(T, H, D)
    k = qkv[:, H * D:(H + Hk) * D].reshape(T, Hk, D)
    v = qkv[:, (H + Hk) * D:].reshape(T, Hk, D)
    assert not q.is_contiguous() and not k.is_contiguous()
    rest = [torch.as_tensor(case[n], device=cuda_device)
            for n in _ARR[3:]]
    rest[:2] = [x.to(tdt) for x in rest[:2]]
    d0 = ragged_paged_attention.design_launches["sm90"]
    got = ragged_paged_attention(q, k, v, *rest, **kw, path="cuda")
    torch.cuda.synchronize()
    assert ragged_paged_attention.design_launches["sm90"] == d0 + 1
    want, lim = _sm90_limit(case, kw, cuda_device, tdt=tdt)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= lim
    dead = torch.as_tensor(case["rows"] < 0, device=cuda_device)
    assert (got[dead] == 0).all()


@pytest.mark.cuda
def test_ragged_sm90_check_rejects_planted_faults(cuda_device):
    """The limit that holds sm90 to the plain version rejects its result
    with one page's valid slots dropped, and with one fresh key past the
    diagonal let in (chip_smoke.py's planted faults)."""
    case, kw = _packed_case(H=16, Hk=16, D=128, bs=16, NB=64,
                            spec=LONG_SPEC, T=384, seed=3)
    got = _run(case, kw, cuda_device, "cuda", torch.bfloat16,
               design="sm90")
    want, lim = _sm90_limit(case, kw, cuda_device)
    assert float((got - want).abs().max()) <= lim
    f32, _ = _args(_rounded(case, torch.bfloat16), cuda_device,
                   torch.float32, upcast=True)
    meta = dict(rows=case["rows"], pos=case["pos"],
                kv_start=case["kv_start"], off=case["off"],
                bs=kw["block_size"], with_pool=True)
    planted = cs._ragged_planted(
        rpa, f32, dict(kw, kdq=None, vdq=None, with_pool=True), meta, want)
    assert sorted(planted) == sorted(cs.RAGGED_PLANTED)
    for what, delta in planted.items():
        assert float((got + delta - want).abs().max()) > lim, what


@pytest.mark.cuda
def test_ragged_kernel_reads_strided_token_views(cuda_device):
    """The engine hands q/k/v as views into the fused qkv projection."""
    case, kw = _packed_case()
    T, H, D = case["q"].shape
    Hk = case["k_new"].shape[1]
    qkv = torch.as_tensor(np.concatenate(
        [case["q"].reshape(T, -1), case["k_new"].reshape(T, -1),
         case["v_new"].reshape(T, -1)], axis=1), device=cuda_device)
    q = qkv[:, :H * D].reshape(T, H, D)
    k = qkv[:, H * D:(H + Hk) * D].reshape(T, Hk, D)
    v = qkv[:, (H + Hk) * D:].reshape(T, Hk, D)
    assert not q.is_contiguous()
    rest = [torch.as_tensor(case[n], device=cuda_device)
            for n in _ARR[3:]]
    got = ragged_paged_attention(q, k, v, *rest, **kw, path="cuda")
    want = ragged_paged_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), *rest, **kw,
                                  path="torch")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# flash attention: B1 (forward) and B2 (backward) against their plain
# versions
# ---------------------------------------------------------------------------
FLASH = {
    # name: (b, sq, sk, H, Hk, D, causal, segments)
    "causal_d64": (2, 256, 256, 4, 4, 64, True, False),
    "noncausal_d128": (1, 128, 256, 2, 2, 128, False, False),
    "gqa_d128": (1, 256, 256, 8, 2, 128, True, False),
    "mqa_d256": (1, 128, 128, 4, 1, 256, True, False),
    "segments": (2, 256, 256, 2, 2, 64, True, True),
    "cross_sq_lt_sk": (1, 128, 384, 2, 2, 64, True, False),
    "cross_sq_gt_sk": (1, 384, 128, 2, 2, 64, True, False),  # masked rows
}
# f32: the kernels compute in f32 like the plain version; only the
# summation order differs. bf16: both round p (and ds) to bf16 before the
# products, the kernel relative to its running row max, which moves a
# row by ~2^-9 of its rms; outputs are bf16 (ulp 2^-8..2^-7 relative):
# 2^-6 is 2-4 ulps. f16 keeps 3 more mantissa bits (p's rounding ~2^-12
# of the row's rms, output ulp 2^-11..2^-10 relative): 2^-9 is the same
# 2-4 ulps
F32_TOL = dict(rtol=1e-4, atol=1e-4)
LOWP = {"bf16": torch.bfloat16, "f16": torch.float16}
LOWP_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}


def _lowp_close(got, want, what):
    """|got - want| <= tol * (|want| + rms of want's row + rms of want)
    element by element, tol by got's dtype (LOWP_TOL), a row being the
    head_dim axis: a late query row, far smaller than the first rows, is
    held to about its own size; the tensor's rms covers rows that are 0
    only by cancellation."""
    tol = LOWP_TOL[got.dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    row = want.pow(2).mean(-1, keepdim=True).sqrt()
    bad = err > tol * (want.abs() + row + want.pow(2).mean().sqrt())
    assert not bad.any(), (what, err[bad].max().item(), int(bad.sum()))


def _flash_case(name, dtype, dev):
    b, sq, sk, H, Hk, D, causal, seg = FLASH[name]
    rng = np.random.default_rng(len(name))
    mk = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32), device=dev).to(dtype)
    q, do = mk(b, sq, H, D), mk(b, sq, H, D)
    k, v = mk(b, sk, Hk, D), mk(b, sk, Hk, D)
    segs = None
    if seg:
        qs = np.zeros((b, sq), np.int32)
        ks = np.zeros((b, sk), np.int32)
        qs[0, sq // 3:] = 1
        ks[0, sk // 3:] = 1
        qs[1, sq // 2:] = 5          # no key carries 5: rows fully masked
        segs = (torch.as_tensor(qs, device=dev),
                torch.as_tensor(ks, device=dev))
    return q * torch.tensor(D ** -0.5, dtype=dtype, device=dev), k, v, do, \
        causal, segs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_kernels_match_plain(cuda_device, name, dtype):
    dt = {"f32": torch.float32, **LOWP}[dtype]
    qs, k, v, do, causal, segs = _flash_case(name, dt, cuda_device)
    sc = qs.shape[-1] ** -0.5
    n_f, n_b = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
    o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
    dq, dk, dv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs,
                              path="cuda")
    torch.cuda.synchronize()
    assert fa.flash_fwd.kernel_launches == n_f + 1
    assert fa.flash_bwd.kernel_launches == n_b + 1
    wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
    # B2 from the same (o, lse) on both sides, so only B2 differs
    wdq, wdk, wdv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs,
                                 path="torch")
    torch.testing.assert_close(lse, wlse, **F32_TOL)
    for what, got, want in (("o", o, wo), ("dq", dq, wdq), ("dk", dk, wdk),
                            ("dv", dv, wdv)):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.isfinite(got).all(), what
        if dt == torch.float32:
            torch.testing.assert_close(got, want, **F32_TOL)
        else:
            _lowp_close(got, want, what)
    dead = wlse < -1e29                                  # [b, H, sq]
    if dead.any():
        rows = dead.transpose(1, 2)                      # [b, sq, H]
        assert (o[rows] == 0).all() and (dq[rows] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_read_strided_qkv_views(cuda_device, D):
    """GPT and the fused encoder hand q/k/v as views of the fused qkv
    projection [b, s, 3, H, D] (token stride 3*H*D): read in place, no
    copy, by B1's sm90 design at both of its head_dims."""
    b, s, H = 2, 256, 4
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((b, s, 3, H, D)).astype(
        np.float32), device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    assert not k.is_contiguous()
    n0 = fa.flash_fwd.design_launches["sm90"]
    o, lse = fa.flash_fwd(q, k, v, True, None, path="cuda")
    assert fa.flash_fwd.design_launches["sm90"] == n0 + 1
    wo, wlse = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                            True, None, path="cuda")
    torch.testing.assert_close(o, wo, rtol=0, atol=0)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=0)
    po, plse = fa.flash_fwd(q, k, v, True, None, path="torch")
    _lowp_close(o, po, "o")
    torch.testing.assert_close(lse, plse, **F32_TOL)


# B1's sm90 design (bf16 and f16, head_dim 64 and 128) on the FLASH cases
# it takes
# and three edges: one 128-row q tile over three k tiles with the causal
# offset (and GQA, at D 128), and segments that leave rows 40-90 of a
# 128-row tile with no valid key beside live rows
SM90_EDGES = {
    # name: (b, sq, sk, H, Hk, D, causal, segments)
    "one_q_tile_sk384_causal_d128": (2, 128, 384, 4, 2, 128, True, False),
    "dead_rows_inside_a_tile": (2, 256, 256, 2, 2, 64, True, "dead"),
    "dead_rows_inside_a_tile_d128": (1, 256, 256, 2, 1, 128, False, "dead"),
}
SM90_CASES = sorted([n for n, c in FLASH.items() if c[5] in (64, 128)]
                    + list(SM90_EDGES))


def _sm90_case(name, dev, dt=torch.bfloat16):
    if name in FLASH:
        qs, k, v, _do, causal, segs = _flash_case(name, dt, dev)
        return qs, k, v, causal, segs
    b, sq, sk, H, Hk, D, causal, seg = SM90_EDGES[name]
    rng = np.random.default_rng(7)
    mk = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32), device=dev).to(dt)
    qs = mk(b, sq, H, D) * torch.tensor(D ** -0.5, dtype=dt, device=dev)
    k, v = mk(b, sk, Hk, D), mk(b, sk, Hk, D)
    segs = None
    if seg:
        q_ids = np.zeros((b, sq), np.int32)
        k_ids = np.zeros((b, sk), np.int32)
        q_ids[:, 40:91] = 7                  # no key carries 7
        q_ids[:, 160:] = k_ids[:, 150:] = 1
        segs = (torch.as_tensor(q_ids, device=dev),
                torch.as_tensor(k_ids, device=dev))
    return qs, k, v, causal, segs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("name", SM90_CASES)
def test_sm90_fwd_matches_plain_and_simple(cuda_device, name, dtype):
    """B1's sm90 kernel against the plain version and against the
    simple kernel on the same bf16 (or f16) inputs; each design's launch
    counter moves by one for its own call only."""
    dt = LOWP[dtype]
    qs, k, v, causal, segs = _sm90_case(name, cuda_device, dt)
    n0 = dict(fa.flash_fwd.design_launches)
    o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
    n1 = dict(fa.flash_fwd.design_launches)
    so, slse = fa._fwd_cuda(qs, k, v, causal, segs, design="simple")
    torch.cuda.synchronize()
    assert (n1["sm90"] - n0["sm90"], n1["simple"] - n0["simple"]) == (1, 0)
    assert fa.flash_fwd.design_launches["simple"] == n1["simple"] + 1
    wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
    assert o.dtype == dt and o.shape == wo.shape
    assert lse.dtype == torch.float32 and lse.shape == wlse.shape
    assert torch.isfinite(o).all()
    _lowp_close(o, wo, "o vs plain")
    _lowp_close(o, so, "o vs simple")
    torch.testing.assert_close(lse, wlse, **F32_TOL)
    torch.testing.assert_close(lse, slse, **F32_TOL)
    dead = wlse < -1e29                                  # [b, H, sq]
    assert (lse[dead] == wlse[dead]).all()
    if dead.any():
        assert (o[dead.transpose(1, 2)] == 0).all()
    if name.startswith("dead_rows"):
        assert dead[:, :, 40:91].all() and not dead[:, :, :40].any()


# chip_smoke.py's phase 3 cases (its inputs, at their full size), for B2's
# sm90 design on every bf16 case at head_dim 64 and 128
B2_PHASE3 = [name for name, spec in cs.FLASH_CASES if spec[5] in (64, 128)]
B2_CASES = B2_PHASE3 + sorted(SM90_EDGES)


def _b2_case(name, dev, dt=torch.bfloat16):
    """(qs, k, v, do, causal, segs) in `dt` (bf16 or f16): a phase 3 case
    by its name, or one of B1's sm90 edges with a do of its own."""
    if name in B2_PHASE3:
        i = [n for n, _ in cs.FLASH_CASES].index(name)
        spec = cs.FLASH_CASES[i][1]
        qs, k, v, do, segs = cs._flash_inputs(spec, dt, seed=i)
        return qs, k, v, do, spec[6], segs
    qs, k, v, causal, segs = _sm90_case(name, dev, dt)
    rng = np.random.default_rng(8)
    do = torch.as_tensor(rng.standard_normal(qs.shape).astype(np.float32),
                         device=dev).to(dt)
    return qs, k, v, do, causal, segs


def _b2_run(name, dev, dt=torch.bfloat16):
    """B2's sm90 design and the simple kernels on one case, from the same
    (o, lse): (sm90's, simple's, the plain version's) (dq, dk, dv), with
    the design counters checked, and the plain forward's lse."""
    qs, k, v, do, causal, segs = _b2_case(name, dev, dt)
    sc = qs.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
    n0 = dict(fa.flash_bwd.design_launches)
    got = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs, path="cuda")
    n1 = dict(fa.flash_bwd.design_launches)
    simple = fa._bwd_cuda(qs, k, v, o, lse, do, causal, segs, sc,
                          design="simple")
    torch.cuda.synchronize()
    assert (n1["sm90"] - n0["sm90"], n1["simple"] - n0["simple"]) == (1, 0)
    assert fa.flash_bwd.design_launches["simple"] == n1["simple"] + 1
    want = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs, path="torch")
    return got, simple, want, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("name", B2_CASES)
def test_sm90_bwd_matches_plain_and_simple(cuda_device, name, dtype):
    """B2's sm90 kernel (flash_bwd_sm90.cu) against the plain version and
    against the simple kernels on the same bf16 (or f16) inputs and
    (o, lse), at
    phase 3's full-size cases (GQA, segments with fully masked rows,
    non-causal, cross lengths both ways, the encoder's packed-qkv views)
    and B1's sm90 edges; each design's counter moves by one for its own
    call only. Rows with no valid key get dq = 0, and keys no query sees
    dk = dv = 0."""
    got, simple, want, lse = _b2_run(name, cuda_device, LOWP[dtype])
    for what, g, sg, w in zip(("dq", "dk", "dv"), got, simple, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.isfinite(g).all(), what
        _lowp_close(g, w, f"{what} vs plain")
        _lowp_close(g, sg, f"{what} vs simple")
    dead = (lse < -1e29).transpose(1, 2)                 # [b, sq, H]
    if dead.any():
        assert (got[0][dead] == 0).all()
    for g, w in zip(got[1:], want[1:]):
        unseen = (w == 0).all(-1)                        # [b, sk, Hk]
        assert (g[unseen] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_sm90_bwd_check_rejects_planted_faults(cuda_device, dtype):
    """The limit that holds B2 to its plain version rejects a dq 5 % off
    on the late query rows and a dv whose last 64-key tile is zeroed."""
    got, _simple, want, _lse = _b2_run("a gpt2_small train", cuda_device,
                                       LOWP[dtype])
    dq = got[0].clone()
    dq[:, dq.shape[1] // 2:] *= 1.05
    dv = got[2].clone()
    dv[:, -64:] = 0
    for what, bad, w in (("dq", dq, want[0]), ("dv", dv, want[2])):
        with pytest.raises(AssertionError):
            _lowp_close(bad, w, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_delta_kernel_matches_plain(cuda_device, D, dtype):
    """delta = rowsum(do·o) by flash_bwd_sm90.cu's delta kernel against
    its plain form, on do given as a strided view (a packed projection's
    slice) and o dense: f32 sums of the same products in another order."""
    dt = {"f32": torch.float32, **LOWP}[dtype]
    rng = np.random.default_rng(D)
    b, s, H = 2, 384, 3
    packed = torch.as_tensor(rng.standard_normal((b, s, 2, H, D)).astype(
        np.float32), device=cuda_device).to(dt)
    do = packed[:, :, 1]
    o = torch.as_tensor(rng.standard_normal((b, s, H, D)).astype(
        np.float32), device=cuda_device).to(dt)
    assert not do.is_contiguous()
    got = fa._delta_cuda(do, o)
    torch.cuda.synchronize()
    want = fa._delta_reference(do, o)
    assert got.shape == (b, H, s) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_training_shape_backward_launches_sm90(cuda_device, dtype):
    """gpt2_small's training call (b 16, s 1024, 12 heads, D 64, causal)
    through flash_attention and autograd, in bf16 and f16: B2 runs once,
    on the sm90 design, and its gradients equal the plain version's from
    the same forward."""
    b, s, H, D = 16, 1024, 12, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((b, s, H, D)).astype(
        np.float32), device=cuda_device).to(LOWP[dtype])
        for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n0 = dict(fa.flash_bwd.design_launches)
    out = fa.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.flash_bwd.design_launches["sm90"] == n0["sm90"] + 1
    assert fa.flash_bwd.design_launches["simple"] == n0["simple"]
    sc = D ** -0.5
    qs = (q * torch.tensor(sc, dtype=q.dtype, device=cuda_device)).detach()
    o, lse = fa.flash_fwd(qs, k.detach(), v.detach(), True, path="cuda")
    torch.testing.assert_close(o, out.detach(), rtol=0, atol=0)
    want = fa.flash_bwd(qs, k.detach(), v.detach(), o, lse, do, sc, True,
                        path="torch")
    for what, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _lowp_close(g, w, what)


@pytest.mark.cuda
def test_sdpa_on_cuda_routes_into_the_kernels(cuda_device):
    """An eligible SDPA call on CUDA tensors launches B1 and, through
    autograd, B2 (the routing of nn_ops.py:869-874); a masked one does
    not."""
    b, s, H, D = 1, 256, 2, 64
    rng = np.random.default_rng(4)
    x = [torch.as_tensor(rng.standard_normal((b, s, H, D)).astype(
        np.float32), device=cuda_device).requires_grad_() for _ in range(3)]
    n_f, n_b = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
    out = F.scaled_dot_product_attention(*x, is_causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_fwd.kernel_launches == n_f + 1
    assert fa.flash_bwd.kernel_launches == n_b + 1
    mask = torch.ones((s, s), dtype=torch.bool, device=cuda_device).tril()
    want = F.scaled_dot_product_attention(*x, attn_mask=mask)
    assert fa.flash_fwd.kernel_launches == n_f + 1
    torch.testing.assert_close(out, want, **F32_TOL)


# ---------------------------------------------------------------------------
# B4 (layer norm) and B5 (RMS norm) against their plain versions
# ---------------------------------------------------------------------------
# element by element, |got - want| <= tol * (|want| + floor * row rms of
# want): both sides compute the f32 value (sums in other orders, rsqrtf
# within 2 ulps) and round it once, so they differ by at most one ulp of
# the output dtype, or, for a value near 0 after centring, by f32 noise
# of the row's size. bf16 ulp <= 2^-7 relative, f16 <= 2^-10.
NORM_TOL = {torch.float32: (1e-5, 1.0), torch.bfloat16: (2.0 ** -7, 2.0 ** -8),
            torch.float16: (2.0 ** -10, 2.0 ** -8)}
# (7, 1001): rows not 16-byte aligned, so the scalar path with a
# multi-warp reduction; (1, 1001): one aligned row, so 16-byte vectors
# in and out and a scalar tail
NORM_SHAPES = [(64, 4096), (7, 1001), (1, 1001), (3, 5, 768), (2, 16384),
               (1, 1), (33, 8)]


def _norm_err(got, want, dtype):
    """The largest |got - want| / limit over the elements (> 1 fails)."""
    tol, floor = NORM_TOL[dtype]
    got, want = got.float(), want.float()
    row = want.pow(2).mean(-1, keepdim=True).sqrt()
    lim = tol * (want.abs() + floor * row)
    d = (got - want).abs()
    return float(torch.where(lim > 0, d / lim,
                             torch.where(d > 0, float("inf"), 0.0)).max())


def _norm_case(shape, dtype, affine, dev, seed=0, wdtype=None):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    x = torch.as_tensor((rng.standard_normal(shape) * 2 + 1).astype(
        np.float32), device=dev).to(dtype)
    w = rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    w[-1] = 0.6              # away from 1, so dropping it is a fault
    w = torch.as_tensor(w, device=dev).to(wdtype or dtype)
    b = torch.as_tensor(rng.standard_normal((h,)).astype(np.float32),
                        device=dev).to(wdtype or dtype)
    return x, (w if affine else None), (b if affine else None)


def _run_norm(kind, x, w, b, path):
    from paddle_tpu_torch.kernels import norms
    if kind == "rms_norm":
        return norms.rms_norm_fwd(x, w, 1e-6, path=path)
    return norms.layer_norm_fwd(x, w, b, 1e-5, path=path)


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_kernels_match_plain(cuda_device, kind, shape, dtype, affine):
    from paddle_tpu_torch.kernels import norms
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}[dtype]
    x, w, b = _norm_case(shape, dt, affine, cuda_device)
    fwd = norms.rms_norm_fwd if kind == "rms_norm" else norms.layer_norm_fwd
    n0 = fwd.kernel_launches
    got = _run_norm(kind, x, w, b, "cuda")
    torch.cuda.synchronize()
    assert fwd.kernel_launches == n0 + 1
    want = _run_norm(kind, x, w, b, "torch")
    assert got.dtype == dt and got.shape == x.shape
    assert torch.isfinite(got).all()
    assert _norm_err(got, want, dt) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_kernels_take_mixed_param_dtypes_and_row_views(cuda_device,
                                                            kind):
    """bf16 rows with f32 weight and bias (the kernel form keeps x's
    dtype), read in place from a row-strided view."""
    x, w, b = _norm_case((40, 3000), torch.bfloat16, True, cuda_device,
                         wdtype=torch.float32)
    view = x[:, 8:8 + 1024]
    assert not view.is_contiguous()
    w, b = w[:1024].contiguous(), b[:1024].contiguous()
    got = _run_norm(kind, view, w, b, "cuda")
    want = _run_norm(kind, view.contiguous(), w, b, "torch")
    assert got.dtype == torch.bfloat16
    assert _norm_err(got, want, torch.bfloat16) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_kernels_take_aligned_rows_with_a_tail(cuda_device, kind,
                                                    dtype):
    """x[:, :1001] of a [n, 1008] tensor: 16-byte aligned rows whose
    width is not a multiple of the vector, so the kernel reads whole
    vectors, then the scalar tail (the output, [n, 1001], is stored by
    element)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, w, b = _norm_case((37, 1008), dt, True, cuda_device)
    view = x[:, :1001]
    w, b = w[:1001].contiguous(), b[:1001].contiguous()
    got = _run_norm(kind, view, w, b, "cuda")
    want = _run_norm(kind, view.contiguous(), w, b, "torch")
    assert got.shape == view.shape and got.dtype == dt
    assert _norm_err(got, want, dt) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_check_rejects_planted_faults(cuda_device, kind):
    """The check above would catch a kernel whose late row is off by
    2^-5, or which drops the weight of its last column."""
    x, w, b = _norm_case((64, 4096), torch.bfloat16, True, cuda_device)
    got = _run_norm(kind, x, w, b, "cuda")
    want = _run_norm(kind, x, w, b, "torch")
    assert _norm_err(got, want, torch.bfloat16) <= 1.0
    late = got.clone()
    late[-3] = (late[-3].float() * (1 + 2 ** -5)).to(late.dtype)
    assert _norm_err(late, want, torch.bfloat16) > 1.0
    no_w = got.float().clone()      # float() of f32 is the tensor itself
    shift = b[-1].float() if kind == "layer_norm" else 0.0
    no_w[:, -1] = (no_w[:, -1] - shift) / w[-1].float() + shift
    assert _norm_err(no_w.to(got.dtype), want, torch.bfloat16) > 1.0


@pytest.mark.cuda
def test_fused_norms_on_cuda_launch_the_kernels(cuda_device):
    """The incubate entry points take B4/B5 on CUDA tensors, and the
    autograd backward (the reference's off-TPU form) still runs."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import norms
    x, w, b = _norm_case((16, 512), torch.float32, True, cuda_device)
    x.requires_grad_()
    n0 = (norms.layer_norm_fwd.kernel_launches,
          norms.rms_norm_fwd.kernel_launches)
    y = IF.fused_layer_norm(x, w, b) + IF.fused_rms_norm(x, w)
    y.sum().backward()
    torch.cuda.synchronize()
    assert (norms.layer_norm_fwd.kernel_launches,
            norms.rms_norm_fwd.kernel_launches) == (n0[0] + 1, n0[1] + 1)
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.cuda
def test_fused_encoder_refuses_shapes_b1_does_not_take(cuda_device):
    """On the card the fused encoder's attention is B1 or an error: 40
    tokens raise rather than run the composite, while an explicit
    attn_mask is the caller's choice of the composite."""
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    layer = FusedTransformerEncoderLayer(
        128, 2, 256, device=cuda_device,
        init_generator=torch.Generator(cuda_device).manual_seed(0)).eval()
    x = torch.randn((2, 40, 128), device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="B1 does not"):
        layer(x)
    mask = torch.ones((40, 40), dtype=torch.bool, device=cuda_device)
    n0 = fa.flash_fwd.kernel_launches
    with torch.no_grad():
        y = layer(x, src_mask=mask)
    assert y.shape == x.shape and fa.flash_fwd.kernel_launches == n0


# ---------------------------------------------------------------------------
# B3 at the shapes of the speculative verify wave and the int8 engine
# ---------------------------------------------------------------------------
# a verify wave at gpt3_1p3b's heads: 8 rows of 1 + 7 drafts over cached
# contexts, the bucket pinned at 8 * 8 = 64 tokens
VERIFY_SPEC = [(int(c), 8) for c in
               np.random.default_rng(20).integers(128, 256, 8)]
# the int8 engine's prefix-resume wave: 8 rows of 8-32 new tokens over a
# 512-token prefix
INT8_SPEC = [(512, int(m)) for m in
             np.random.default_rng(21).integers(8, 33, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_ragged_verify_wave_shape(cuda_device, dtype):
    """The verify wave takes the sm90 design (each 64-token q tile holds
    one short row) within _sm90_limit, and the simple design within
    1e-4, of the plain version."""
    tdt = LOWP[dtype]
    case, kw = _packed_case(H=16, Hk=16, D=128, bs=64, NB=48,
                            spec=VERIFY_SPEC, T=64, seed=5)
    d0 = dict(ragged_paged_attention.design_launches)
    got = _run(case, kw, cuda_device, None, tdt)
    torch.cuda.synchronize()
    assert {d: n - d0[d] for d, n in
            ragged_paged_attention.design_launches.items()} == \
        {"sm90": 1, "simple": 0}
    want, lim = _sm90_limit(case, kw, cuda_device, tdt=tdt)
    assert float((got - want).abs().max()) <= lim
    simple = _run(case, kw, cuda_device, "cuda", tdt, design="simple")
    torch.testing.assert_close(simple, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ragged_int8_engine_wave_shape(cuda_device):
    """bf16 q over int8 pools with dequant scales at the int8 engine's
    prefix-resume wave: the dispatcher takes the simple design, within
    1e-4 of the plain version; the same wave without a pool (the int8
    engine's fresh wave) takes sm90."""
    case, kw = _packed_case(H=16, Hk=16, D=128, bs=64, NB=80, int8=True,
                            spec=INT8_SPEC, T=256, seed=6)
    d0 = dict(ragged_paged_attention.design_launches)
    got = _run(case, kw, cuda_device, None, torch.bfloat16)
    torch.cuda.synchronize()
    assert {d: n - d0[d] for d, n in
            ragged_paged_attention.design_launches.items()} == \
        {"sm90": 0, "simple": 1}
    want = _run(_rounded(case, torch.bfloat16), kw, cuda_device, "torch",
                torch.bfloat16, upcast=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    d0 = dict(ragged_paged_attention.design_launches)
    _run(case, kw, cuda_device, None, torch.bfloat16, with_pool=False)
    assert ragged_paged_attention.design_launches["sm90"] == d0["sm90"] + 1


# ---------------------------------------------------------------------------
# the eager API on CUDA Tensors
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eager_sdpa_op_launches_b1_and_b2(cuda_device, dtype):
    """The registered scaled_dot_product_attention op on CUDA Tensors
    launches B1 and, through loss.backward(), B2 (bf16 on the sm90
    designs), and equals the torch-level call on the same values."""
    import paddle_tpu_torch as P
    b, s, H, D = 2, 256, 4, 64
    rng = np.random.default_rng(8)
    arrs = [rng.standard_normal((b, s, H, D)).astype(np.float32)
            for _ in range(3)]
    dt = {"f32": "float32", "bf16": "bfloat16"}[dtype]
    ts = [P.to_tensor(a, dtype=dt, place="gpu:0", stop_gradient=False)
          for a in arrs]
    n_f = dict(fa.flash_fwd.design_launches)
    n_b = dict(fa.flash_bwd.design_launches)
    out = P.nn.functional.scaled_dot_product_attention(*ts, is_causal=True)
    out.astype("float32").sum().backward()
    torch.cuda.synchronize()
    design = "sm90" if dtype == "bf16" else "simple"
    assert fa.flash_fwd.design_launches[design] == n_f[design] + 1
    assert fa.flash_bwd.design_launches[design] == n_b[design] + 1
    assert sum(fa.flash_fwd.design_launches.values()) == \
        sum(n_f.values()) + 1
    tq = [t._data.detach().clone().requires_grad_() for t in ts]
    want = F.scaled_dot_product_attention(*tq, is_causal=True)
    want.float().sum().backward()
    torch.testing.assert_close(out._data, want, rtol=0, atol=0)
    for t, w in zip(ts, tq):
        torch.testing.assert_close(t.grad._data, w.grad, rtol=0, atol=0)


@pytest.mark.cuda
def test_op_on_cuda_and_cpu_tensors_raises(cuda_device):
    """A CUDA Tensor and a CPU Tensor in one op raise, and neither moves
    (a 0-d CPU tensor, which torch itself would take, too)."""
    import paddle_tpu_torch as P
    g = P.to_tensor(np.ones((2, 3), np.float32), place="gpu:0")
    c = P.to_tensor(np.ones((2, 3), np.float32), place="cpu")
    c0 = P.to_tensor(np.float32(2.0), place="cpu")
    for fn in (lambda: g + c, lambda: P.add(c, g), lambda: g * c0,
               lambda: P.concat([g, c]),
               lambda: P.nn.functional.linear(g, c)):
        with pytest.raises(RuntimeError, match="move them to one device"):
            fn()
    assert g._data.device.type == "cuda" and c._data.device.type == "cpu"
    assert c0._data.device.type == "cpu"


@pytest.mark.cuda
def test_to_tensor_without_a_card_raises(cuda_device):
    """With no card visible, to_tensor and set_device("gpu") raise until
    set_device("cpu") is called (a process of its own, the card hidden)."""
    import os
    import subprocess
    import sys
    code = (
        "import numpy as np, paddle_tpu_torch as P\n"
        "for f in (lambda: P.to_tensor(np.ones(2)), lambda: P.zeros([2]),\n"
        "          lambda: P.set_device('gpu')):\n"
        "    try:\n"
        "        f()\n"
        "        raise SystemExit('did not raise')\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "P.set_device('cpu')\n"
        "assert P.to_tensor(np.ones(2)).place == P.CPUPlace()\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _op_cases():
    import sys as _sys
    _sys.path.insert(0, str(Path(__file__).resolve().parent))
    import eager_op_cases
    return eager_op_cases


@pytest.mark.cuda
def test_eager_op_sweep_cuda_matches_cpu(cuda_device):
    """Every case of tests/eager_op_cases.py on CUDA Tensors against the
    same case on CPU Tensors (chip_smoke.py phase 22's sweep, whose
    limits it keeps), values and backward() grads, and every op of the
    registry dispatched."""
    sys_path_cases = _op_cases()
    res = cs.eager_op_sweep(sys_path_cases)
    assert not res["failures"], res["failures"]
    assert not res["not_run"], res["not_run"]
