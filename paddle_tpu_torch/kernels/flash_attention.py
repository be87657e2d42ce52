"""Flash attention for the PyTorch port: blockwise forward (B1) and the
FA2 backward (B2), with the plain PyTorch versions beside them.

Counterpart of paddle_tpu/kernels/pallas/flash_attention.py. Its TPU
kernels ``_flash_fwd_fused`` (flash_attention.py:267, kernel
``_fwd_kernel`` :101) and ``_flash_bwd_fused`` (:457, kernel
``_bwd_kernel`` :364) become hand-written CUDA kernels: B1 in two
designs, ``csrc/flash_fwd_sm90.cu`` for bf16 and f16 at head_dim 64 and
128 (the main paths' calls) and ``csrc/flash_attention.cu``'s
``flash_fwd_kernel`` for f32 and head_dim 256 (``_fwd_design`` picks
one), B2 likewise in ``csrc/flash_bwd_sm90.cu`` (bf16 and f16 at
head_dim 64 and 128, the training path's calls) and
``csrc/flash_attention.cu``'s ``flash_bwd_dkdv_kernel`` /
``flash_bwd_dq_kernel`` (``_bwd_design``), both after
``flash_bwd_sm90.cu``'s delta kernel; ``_flash_core`` (:664, a
jax.custom_vjp) becomes ``_FlashCore``, a ``torch.autograd.Function``;
the composite ``_xla_attention`` (:606) is ported as it is.

Public layout [batch, seq, heads, head_dim]; k and v may carry fewer
heads (GQA/MQA: q head h reads kv head h // (H / Hk)). Causal masking is
bottom-right aligned (query i sees keys <= i + sk - sq, FA2 semantics),
segment ids mask attention to equal ids, and a row with no valid key
outputs 0 (its lse is -1e30 and its gradients are 0).

Cast order (kept by the plain versions, so the CPU tests can hold them
to paddle_tpu): q is pre-scaled and cast back to its dtype,
``(q * sm_scale).astype(q.dtype)`` (:677), and that q_scaled is what the
backward reads; scores, softmax statistics and every accumulation are
f32; probabilities are cast to v's dtype before p·v (:149), p to do's
dtype before dv, ds to q's dtype before dk and to k's before dq
(:413-429); dq is scaled by sm_scale in f32 and cast to q's dtype (:697).

Dispatch: CPU tensors take the plain versions; CUDA tensors take the
kernels, or raise when the kernel refuses the call. Under a trace
(``torch.export``, ``make_fx``: fake tensors) B1 goes through its
operator ``torch.ops.paddle_tpu_torch.flash_fwd`` (kernels/__init__.py),
whose implementation is this dispatch; B2 stays ``_FlashCore``'s
backward, which no export needs. Shapes that
``attention_path`` rejects never reach either: ``flash_attention``
routes them to the composite, as the reference does, and
``attention_path`` says why. Nothing falls back silently.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..utils.build import load_cuda
from . import autotune, tracing

__all__ = ["flash_attention", "attention_path", "flash_fwd", "flash_bwd"]

_NEG_INF = -1e30
_SUPPORTED_D = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# B1's and B2's designs: "sm90" (flash_fwd_sm90.cu, flash_bwd_sm90.cu)
# takes bf16 and f16 at these head_dims, "simple" (flash_attention.cu)
# every call the kernels take
_SM90_DTYPES = (torch.bfloat16, torch.float16)
_FWD_DESIGNS = _BWD_DESIGNS = ("sm90", "simple")
_SM90_D = (64, 128)


def _wide(t):
    """Low-precision values widened to f32 (exact) for f32 products and
    sums, as the reference's preferred_element_type=float32 contractions
    are; f32 and f64 stay as they are."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


# ---------------------------------------------------------------------------
# the composite (counterpart of _xla_attention :606)
# ---------------------------------------------------------------------------
def _mask(sq, sk, causal, segment_ids, device):
    """Bool validity [b | 1, 1, sq, sk] from bottom-right causal masking
    and segment equality, or None when nothing is masked."""
    ok = None
    if causal:
        qpos = (sk - sq) + torch.arange(sq, device=device)[:, None]
        ok = (qpos >= torch.arange(sk, device=device)[None, :])[None, None]
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        seg = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
        ok = seg if ok is None else ok & seg
    return ok


def _xla_attention(q, k, v, attn_mask, causal, sm_scale, segment_ids=None):
    """The reference composite ([b, s, h, d] in and out): GQA by repeating
    k/v heads, f32 scores, bottom-right causal and segment masks at
    -1e30, a boolean or additive mask, softmax cast to q's dtype, rows
    with no valid key zeroed. Used for a dense attn_mask and for shapes
    the kernel refuses; autograd differentiates it."""
    h, hk = q.shape[2], k.shape[2]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(qt), _wide(kt)) * sm_scale
    ok = _mask(s.shape[-2], s.shape[-1], causal, segment_ids, q.device)
    if ok is not None:
        s = s.masked_fill(~ok, _NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            s = s.masked_fill(~attn_mask, _NEG_INF)
        else:
            s = s + attn_mask.to(s.dtype)
    any_valid = s.amax(dim=-1, keepdim=True) > _NEG_INF / 2
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    o = torch.einsum("bhqk,bhkd->bhqd", _wide(p), _wide(vt))
    return o.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions of B1 and B2 (CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------
def _grouped(t, hk):
    """[b, s, H, D] -> [b, Hk, G, s, D] (q head h = kv head h // G)."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, hk, h // hk, s, d)


def _scores(qs, k, causal, segment_ids):
    """f32 scores [b, Hk, G, sq, sk] of the pre-scaled q against k, and
    the validity mask broadcastable to them (or None)."""
    hk = k.shape[2]
    s = torch.matmul(_wide(_grouped(qs, hk)),
                     _wide(k.permute(0, 2, 3, 1)[:, :, None]))
    ok = _mask(qs.shape[1], k.shape[1], causal, segment_ids, qs.device)
    if ok is not None:
        ok = ok[:, :, None]                          # [b|1, 1, 1, sq, sk]
    return s, ok


def _flash_fwd_reference(qs, k, v, causal=False, segment_ids=None):
    """B1's plain version. qs [b, sq, H, D] pre-scaled; k, v [b, sk, Hk, D].
    Returns (o [b, sq, H, D] in qs's dtype, lse [b, H, sq] f32): an f32
    softmax with masked scores at -1e30 and masked probabilities 0, p
    cast to v's dtype before p·v, rows with no valid key giving o = 0 and
    lse = -1e30 (the kernel's finalize, flash_attention.py:166-180)."""
    b, sq, h, d = qs.shape
    hk = k.shape[2]
    s, ok = _scores(qs, k, causal, segment_ids)
    if ok is not None:
        s = s.masked_fill(~ok, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.matmul(_wide(p.to(v.dtype)),
                       _wide(v.permute(0, 2, 1, 3)[:, :, None]))
    o = (acc / safe_l).to(qs.dtype)                  # [b, Hk, G, sq, D]
    lse = (m + torch.log(safe_l))[..., 0]            # [b, Hk, G, sq]
    return (o.reshape(b, h, sq, d).permute(0, 2, 1, 3).contiguous(),
            lse.reshape(b, h, sq).contiguous())


def _delta_reference(do, o):
    """The plain delta: rowsum(do·o) in f32 as [b, H, sq], laid out like
    lse (the reference's einsum, :521-525)."""
    return (_wide(do) * _wide(o)).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd_reference(qs, k, v, o, lse, do, causal=False,
                         segment_ids=None):
    """B2's plain version: the FA2 backward from (q_scaled, k, v, o, lse,
    do), the math of _bwd_kernel (:364-430). p = exp(s - lse) (masked to
    0), delta = rowsum(do·o) in f32 (:521-525), dv = Σ cast(p)ᵀ·do,
    dp = do·vᵀ, ds = p·(dp - delta), dk = Σ cast(ds)ᵀ·q_scaled,
    dq = cast(ds)·k. Sums over the G q heads of a kv head run in f32.
    Returns (dq_scaled f32 [b, sq, H, D], dk, dv in k's/v's dtype); the
    caller scales dq by sm_scale."""
    b, sq, h, d = qs.shape
    hk = k.shape[2]
    s, ok = _scores(qs, k, causal, segment_ids)
    p = torch.exp(s - lse.reshape(b, hk, h // hk, sq, 1))
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    dog = _grouped(do, hk)                           # [b, Hk, G, sq, D]
    kt = k.permute(0, 2, 1, 3)[:, :, None]           # [b, Hk, 1, sk, D]
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    delta = _delta_reference(do, o).reshape(b, hk, h // hk, sq, 1)
    dv = torch.matmul(_wide(p.to(do.dtype)).transpose(-1, -2),
                      _wide(dog)).sum(2)
    dp = torch.matmul(_wide(dog), _wide(vt).transpose(-1, -2))
    ds = p * (dp - delta)
    dk = torch.matmul(_wide(ds.to(qs.dtype)).transpose(-1, -2),
                      _wide(_grouped(qs, hk))).sum(2)
    dq = torch.matmul(_wide(ds.to(k.dtype)), _wide(kt))
    return (dq.reshape(b, h, sq, d).permute(0, 2, 1, 3).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# CUDA kernels: build and launch
# ---------------------------------------------------------------------------
_LIB = None
_SM90_LIB = None
_SM90_BWD_LIB = None
_LIB_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (q, k, v, q_seg, kv_seg, o, lse, b, sq, sk, H, Hk, D, causal, dtype,
#  q_sb, q_st, k_sb, k_st, v_sb, v_st, stream): both B1 entries
_FWD_ARGTYPES = [_P] * 7 + [_I] * 8 + [_L] * 6 + [_P]
# (q, k, v, do, lse, delta, q_seg, kv_seg, dq, dk, dv, b, sq, sk, H, Hk, D,
#  causal, dtype, sm_scale, q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb,
#  do_st, stream): both B2 entries
_BWD_ARGTYPES = [_P] * 11 + [_I] * 8 + [ctypes.c_float] + [_L] * 8 + [_P]
# (do, o, delta, b, sq, H, D, dtype, do_sb, do_st, o_sb, o_st, stream)
_DELTA_ARGTYPES = [_P] * 3 + [_I] * 5 + [_L] * 4 + [_P]
# the Hopper sources' shared helpers, hashed with them
_SM90_HEADERS = ("sm90_wgmma.cuh",)


def _bind(fn, argtypes):
    fn.restype, fn.argtypes = _I, argtypes


def _load_kernel():
    """Build and load flash_attention.cu (B1's and B2's simple design)
    at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load_cuda("flash_attention")
            _bind(lib.flash_attention_fwd_launch, _FWD_ARGTYPES)
            _bind(lib.flash_attention_bwd_launch, _BWD_ARGTYPES)
            _LIB = lib
    return _LIB


def _load_sm90(extra_flags=()):
    """Build and load flash_fwd_sm90.cu (B1's sm90 design), its own
    library, at first use. `extra_flags` (-D tile sizes) builds and
    returns a variant without installing it."""
    global _SM90_LIB
    with _LIB_LOCK:
        if _SM90_LIB is None or extra_flags:
            lib = load_cuda("flash_fwd_sm90", _SM90_HEADERS, extra_flags)
            _bind(lib.flash_fwd_sm90_launch, _FWD_ARGTYPES)
            if extra_flags:
                return lib
            _SM90_LIB = lib
    return _SM90_LIB


def _load_sm90_bwd(extra_flags=()):
    """Build and load flash_bwd_sm90.cu (B2's sm90 design and the delta
    kernel both designs run), its own library, at first use.
    `extra_flags` as for _load_sm90."""
    global _SM90_BWD_LIB
    with _LIB_LOCK:
        if _SM90_BWD_LIB is None or extra_flags:
            lib = load_cuda("flash_bwd_sm90", _SM90_HEADERS, extra_flags)
            _bind(lib.flash_bwd_sm90_launch, _BWD_ARGTYPES)
            _bind(lib.flash_bwd_delta_launch, _DELTA_ARGTYPES)
            if extra_flags:
                return lib
            _SM90_BWD_LIB = lib
    return _SM90_BWD_LIB


# the block-config cache (kernels/autotune.py): B1's and B2's sm90 tile
# knobs per head_dim, and the build variants a sweep times, the
# sources' own defaults first (the reference's candidates are
# {block_q, block_k} pairs, flash_attention.py:244-247)
_FWD_VARIANTS = autotune.BuildVariants(
    {64: ("FA90_D64_BN", "FA90_D64_STAGES"),
     128: ("FA90_D128_BN", "FA90_D128_STAGES")},
    [{64: (64, 3), 128: (64, 3)},
     {64: (64, 2), 128: (64, 2)},
     {64: (128, 2), 128: (128, 2)}],
    lambda flags: _load_sm90(flags))
_BWD_VARIANTS = autotune.BuildVariants(
    {64: ("FB90_D64_BQ", "FB90_D64_BN", "FB90_D64_KV_STAGES",
          "FB90_D64_DQ_STAGES"),
     128: ("FB90_D128_BQ", "FB90_D128_BN", "FB90_D128_KV_STAGES",
           "FB90_D128_DQ_STAGES")},
    [{64: (128, 128, 3, 3), 128: (64, 128, 3, 2)},
     {64: (128, 128, 2, 2), 128: (64, 128, 2, 2)},
     {64: (64, 128, 3, 3), 128: (64, 64, 3, 3)}],
    lambda flags: _load_sm90_bwd(flags))


def _tune_key(kind, qs, k, causal, segmented):
    """The reference's cache key (flash_attention.py:231-232): the shape
    class without the batch, which only multiplies the grid."""
    b, sq, h, d = qs.shape
    return (kind, sq, k.shape[1], h, k.shape[2], d,
            str(qs.dtype).removeprefix("torch."), int(causal),
            int(segmented))


def _kernel_operand(name, t, dev, dtype, heads, d):
    """t as the kernels read it: on `dev`, of `dtype`, [b, s, heads, d]
    with dense heads and head_dim and 16-byte aligned rows. A view whose
    rows are not aligned is copied once (the kernels load 16 bytes at a
    time); any other mismatch raises."""
    if t.device != dev or t.dtype != dtype or t.dim() != 4 \
            or t.shape[2:] != (heads, d):
        raise ValueError(f"flash attention CUDA kernel: {name} must be "
                         f"{dtype} [b, s, {heads}, {d}] on {dev}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    es = t.element_size()
    if t.stride(3) != 1 or t.stride(2) != d or t.data_ptr() % 16 \
            or (t.stride(1) * es) % 16 or (t.stride(0) * es) % 16:
        t = t.contiguous()
    return t


def _seg_operands(segment_ids, b, sq, sk, dev):
    if segment_ids is None:
        return None, None
    q_seg, kv_seg = (torch.as_tensor(x, device=dev).to(torch.int32)
                     .contiguous() for x in segment_ids)
    if q_seg.shape != (b, sq) or kv_seg.shape != (b, sk):
        raise ValueError(f"segment_ids must be ([{b}, {sq}], [{b}, {sk}])")
    return q_seg, kv_seg


def _check_kernel_call(qs, k):
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if qs.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention CUDA kernel: q must be bf16, "
                        f"f16 or f32, got {qs.dtype}")
    reason = _shape_reject_reason(qs.shape, k.shape)
    if reason:
        raise ValueError(f"flash attention CUDA kernel: {reason}")


def _design(kernel, dtype, d, design):
    auto = "sm90" if dtype in _SM90_DTYPES and d in _SM90_D else "simple"
    if design is None:
        return auto
    if design not in _FWD_DESIGNS:
        raise ValueError(f"unknown {kernel} design {design!r}, not in "
                         f"{_FWD_DESIGNS}")
    if design == "sm90" and auto != "sm90":
        raise ValueError(f"{kernel}'s sm90 design takes bf16 or f16 at "
                         f"head_dim {_SM90_D}, got {dtype} at {d}")
    return design


def _fwd_design(dtype, d, design=None):
    """B1's design for q of `dtype` and head_dim `d`: "sm90" for bf16 or
    f16 at head_dim 64 or 128, "simple" otherwise. `design` forces one (the
    same-run comparison of the two); it raises for an unknown name, and
    for "sm90" on a call that design does not take."""
    return _design("B1", dtype, d, design)


def _bwd_design(dtype, d, design=None):
    """B2's design, by _fwd_design's rule: "sm90" (flash_bwd_sm90.cu) for
    bf16 or f16 at head_dim 64 or 128, "simple" (flash_attention.cu)
    otherwise."""
    return _design("B2", dtype, d, design)


def _fwd_cuda(qs, k, v, causal, segment_ids, design=None):
    """Launch B1 on the current stream. Returns (o, lse [b, H, sq]).
    `design` is private: it forces a design (see _fwd_design); nothing on
    a main path passes it."""
    _check_kernel_call(qs, k)
    b, sq, h, d = qs.shape
    design = _fwd_design(qs.dtype, d, design)
    sk, hk = k.shape[1], k.shape[2]
    dev = qs.device
    qs = _kernel_operand("q", qs, dev, qs.dtype, h, d)
    k = _kernel_operand("k", k, dev, qs.dtype, hk, d)
    v = _kernel_operand("v", v, dev, qs.dtype, hk, d)
    q_seg, kv_seg = _seg_operands(segment_ids, b, sq, sk, dev)
    o = torch.empty((b, sq, h, d), dtype=qs.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    args = (
        qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, sq, sk, h, hk, d, int(causal),
        _DTYPE_CODE[qs.dtype], qs.stride(0), qs.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1),
        torch.cuda.current_stream(dev).cuda_stream)
    if design == "sm90":
        key = _tune_key("fwd", qs, k, causal, q_seg is not None)
        launch = _FWD_VARIANTS.select(key, d, lambda lib: autotune.time_launch(
            lib.flash_fwd_sm90_launch, args)).flash_fwd_sm90_launch
    else:
        launch = _load_kernel().flash_attention_fwd_launch
    rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel ({design}) "
                           f"launch failed: error {rc}")
    flash_fwd.kernel_launches += 1
    flash_fwd.design_launches[design] += 1
    return o, lse


def _delta_cuda(do, o):
    """delta = rowsum(do·o) in f32 [b, H, sq] by flash_bwd_sm90.cu's
    delta kernel, on the current stream. do and o are CUDA tensors of
    one shape [b, sq, H, D] and one dtype, read through their batch and
    token strides (_kernel_operand)."""
    if o.shape != do.shape:
        raise ValueError(f"delta: o {list(o.shape)} and do "
                         f"{list(do.shape)} differ")
    b, sq, h, d = do.shape
    do = _kernel_operand("do", do, do.device, do.dtype, h, d)
    o = _kernel_operand("o", o, do.device, do.dtype, h, d)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=do.device)
    rc = _load_sm90_bwd().flash_bwd_delta_launch(
        do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, sq, h, d,
        _DTYPE_CODE[do.dtype], do.stride(0), do.stride(1), o.stride(0),
        o.stride(1), torch.cuda.current_stream(do.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention delta kernel launch failed: "
                           f"error {rc}")
    return delta


def _bwd_cuda(qs, k, v, o, lse, do, causal, segment_ids, sm_scale,
              design=None):
    """Launch B2 on the current stream: the delta kernel, then the dk/dv
    kernel and the dq kernel of its design. Returns (dq in q's dtype,
    scaled by sm_scale; dk; dv). `design` is private, as for _fwd_cuda."""
    _check_kernel_call(qs, k)
    b, sq, h, d = qs.shape
    design = _bwd_design(qs.dtype, d, design)
    sk, hk = k.shape[1], k.shape[2]
    dev = qs.device
    qs = _kernel_operand("q", qs, dev, qs.dtype, h, d)
    k = _kernel_operand("k", k, dev, qs.dtype, hk, d)
    v = _kernel_operand("v", v, dev, qs.dtype, hk, d)
    do = _kernel_operand("do", do, dev, qs.dtype, h, d)
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{b}, {h}, {sq}]")
    lse = lse.contiguous()
    q_seg, kv_seg = _seg_operands(segment_ids, b, sq, sk, dev)
    delta = _delta_cuda(do, o)
    dq = torch.empty((b, sq, h, d), dtype=qs.dtype, device=dev)
    dk = torch.empty((b, sk, hk, d), dtype=qs.dtype, device=dev)
    dv = torch.empty((b, sk, hk, d), dtype=qs.dtype, device=dev)
    args = (
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hk, d,
        int(causal), _DTYPE_CODE[qs.dtype], float(sm_scale),
        qs.stride(0), qs.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), do.stride(0), do.stride(1),
        torch.cuda.current_stream(dev).cuda_stream)
    if design == "sm90":
        key = _tune_key("bwd", qs, k, causal, q_seg is not None)
        launch = _BWD_VARIANTS.select(key, d, lambda lib: autotune.time_launch(
            lib.flash_bwd_sm90_launch, args)).flash_bwd_sm90_launch
    else:
        launch = _load_kernel().flash_attention_bwd_launch
    rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"flash attention backward kernel ({design}) "
                           f"launch failed: error {rc}")
    flash_bwd.kernel_launches += 1
    flash_bwd.design_launches[design] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def flash_fwd(qs, k, v, causal=False, segment_ids=None, path=None):
    """B1: (o [b, sq, H, D] in q's dtype, lse [b, H, sq] f32) from the
    pre-scaled q. path: None = by device (the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors); "cuda" | "torch" force
    one (tests and the kernel-vs-plain comparison)."""
    if path is None:
        if tracing(qs):
            q_seg, kv_seg = segment_ids or (None, None)
            return torch.ops.paddle_tpu_torch.flash_fwd(qs, k, v, q_seg,
                                                        kv_seg, bool(causal))
        path = "cuda" if qs.device.type == "cuda" else "torch"
    if path == "cuda":
        return _fwd_cuda(qs, k, v, causal, segment_ids)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    flash_fwd.plain_calls += 1
    return _flash_fwd_reference(qs, k, v, causal, segment_ids)


def flash_bwd(qs, k, v, o, lse, do, sm_scale, causal=False,
              segment_ids=None, path=None):
    """B2: (dq, dk, dv) from (q_scaled, k, v, o, lse, do); dq is the
    gradient of the unscaled q (scaled by sm_scale in f32, cast to q's
    dtype, :697). path as for flash_fwd."""
    if path is None:
        path = "cuda" if qs.device.type == "cuda" else "torch"
    if path == "cuda":
        return _bwd_cuda(qs, k, v, o, lse, do, causal, segment_ids,
                         sm_scale)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    flash_bwd.plain_calls += 1
    dq, dk, dv = _flash_bwd_reference(qs, k, v, o, lse, do, causal,
                                      segment_ids)
    return (dq * sm_scale).to(qs.dtype), dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_seg: Optional[torch.Tensor],
                  kv_seg: Optional[torch.Tensor],
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 as an operator (kernels/__init__.py): the launcher on CUDA
    tensors, the plain version on CPU tensors, counted as flash_fwd
    counts them."""
    seg = None if q_seg is None else (q_seg, kv_seg)
    return flash_fwd(qs, k, v, causal, seg,
                     path="cuda" if qs.device.type == "cuda" else "torch")


@_flash_fwd_op.register_fake
def _flash_fwd_fake(qs, k, v, q_seg, kv_seg, causal):
    b, sq, h, _ = qs.shape
    return qs.new_empty(qs.shape), qs.new_empty((b, h, sq),
                                                dtype=torch.float32)


# launches of the CUDA kernels (one per call: B2's call launches its delta,
# dk/dv and dq kernels), each kernel's launches by design, and calls of the
# plain versions through the dispatchers: a run reads them to show which
# implementation it went through
flash_fwd.kernel_launches = 0
flash_fwd.design_launches = dict.fromkeys(_FWD_DESIGNS, 0)
flash_fwd.plain_calls = 0
flash_bwd.kernel_launches = 0
flash_bwd.design_launches = dict.fromkeys(_BWD_DESIGNS, 0)
flash_bwd.plain_calls = 0


def reset_counters():
    """Set every launch and plain-call counter of B1 and B2 to 0."""
    for f, designs in ((flash_fwd, _FWD_DESIGNS), (flash_bwd, _BWD_DESIGNS)):
        f.kernel_launches = f.plain_calls = 0
        f.design_launches = dict.fromkeys(designs, 0)


class _FlashCore(torch.autograd.Function):
    """Counterpart of _flash_core / _flash_core_fwd / _flash_core_bwd
    (:664-707): [b, s, h, d] in and out, k/v may carry fewer heads.
    Forward pre-scales q and casts it back to its dtype, runs B1 and saves
    (q_scaled, k, v, o, lse) for B2."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale):
        seg = None if q_seg is None else (q_seg, kv_seg)
        # the scale is rounded to q's dtype first, as jax's weak-typed
        # python float is: (q * sm_scale).astype(q.dtype) (:677); rounded
        # on the host, so a CUDA graph can capture the product
        qs = q * float(torch.tensor(sm_scale, dtype=q.dtype))
        o, lse = flash_fwd(qs, k, v, causal, seg)
        ctx.save_for_backward(qs, k, v, o, lse, q_seg, kv_seg)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        seg = None if q_seg is None else (q_seg, kv_seg)
        dq, dk, dv = flash_bwd(qs, k, v, o, lse, do, ctx.sm_scale,
                               ctx.causal, seg)
        return dq, dk, dv, None, None, None, None


def _shapes_ok(q_shape, k_shape):
    return not _shape_reject_reason(q_shape, k_shape)


def _shape_reject_reason(q_shape, k_shape):
    """None if the kernels take these [b, s, h, d] shapes, else why not.

    The reference's TPU lane rule ((h*d) % 128 == 0, h <= 128, :723-727)
    is dropped: the CUDA kernels slice one head per CTA, so no head count
    or fused width is special to them. The rules kept are the kernels'
    own contract: head_dim in (64, 128, 256), sequence lengths multiples
    of 128, kv heads dividing q heads."""
    sq, sk, h, d = q_shape[1], k_shape[1], q_shape[2], q_shape[-1]
    hk = k_shape[2]
    if d not in _SUPPORTED_D:
        return f"head_dim {d} not in {_SUPPORTED_D}"
    if sq < 128 or sk < 128 or sq % 128 or sk % 128:
        return (f"seq lengths ({sq}, {sk}) must be >=128 multiples of 128 "
                "(pad or pack, e.g. via segment_ids)")
    if hk < 1 or h % hk:
        return f"kv heads {hk} must divide q heads {h}"
    return None


def attention_path(q_shape, k_shape, masked=False, device="cuda"):
    """('cuda' | 'torch' | 'composite', reason): which implementation
    flash_attention takes for these shapes on tensors of `device`, and
    why. 'cuda' is the kernel pair; 'torch' their plain versions (CPU
    tensors); 'composite' the _xla_attention fallback that a dense
    attn_mask or a shape the kernels refuse is routed to (segment-id
    masking stays on the kernel path)."""
    if masked:
        return ("composite", "dense attn_mask forces the composite — use "
                "segment_ids or causal for the kernel path")
    reason = _shape_reject_reason(q_shape, k_shape)
    if reason:
        return ("composite", reason)
    if torch.device(device).type != "cuda":
        return ("torch", "CPU tensors take the plain version")
    return ("cuda", "")


def flash_attention(q, k, v, attn_mask=None, causal=False,
                    softmax_scale=None, segment_ids=None):
    """[b, s, h, d] in and out; k/v may have fewer heads (GQA/MQA).

    segment_ids: (q_seg [b, sq], kv_seg [b, sk]) int — attention is
    masked to equal ids (stays on the kernel path). A dense attn_mask,
    or shapes the kernels refuse (attention_path says why), take the
    composite. Causal masking is bottom-right aligned when sq != sk."""
    d = q.shape[-1]
    sm_scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(d)
    if attn_mask is not None or not _shapes_ok(q.shape, k.shape):
        return _xla_attention(q, k, v, attn_mask, causal, sm_scale,
                              segment_ids=segment_ids)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = (torch.as_tensor(x, device=q.device).to(torch.int32)
                         for x in segment_ids)
    return _FlashCore.apply(q, k, v, q_seg, kv_seg, bool(causal),
                            float(sm_scale))
