"""Ragged paged attention for the PyTorch port: one launch computes
attention for a packed stream of tokens from rows of any length (fresh
prefill suffixes, prefix-resume tails, single decode tokens).

Counterpart of paddle_tpu/kernels/pallas/ragged_paged_attention.py.
Its TPU kernel ``_ragged_pallas`` (ragged_paged_attention.py:313,
kernel ``_ragged_kernel`` :166) becomes the hand-written CUDA kernel in
``csrc/ragged_paged_attention.cu``; its jnp reference
``_ragged_reference`` (:101) becomes the plain PyTorch version below.

  * each packed query token attends to (a) its row's already-cached
    context, read from the token-major paged KV pool through the
    per-row block-ownership map, and (b) the packed fresh k/v of its
    OWN row at positions <= its own (causal within the row);
  * fp (bf16/f32) and int8 pools (per-kv-head dequant scales fold into
    the scores and the output);
  * GQA/MQA: packed k/v carry kv_heads <= heads; q head h reads kv head
    h // (H / Hk);
  * a token of a dead row (-1), or with no valid key, outputs 0.

Layout contract: q [T, H, D]; k_new/v_new [T, Hk, D]; pools
[T_pool, Hk, D] token-major (block b's slot s at row b*block_size+s —
PagedKVCache layout="token"); rows [T] int32 (-1 = dead padding);
pos [T] int32 absolute positions; kv_start [B] int32 tokens already
in the pool per row; off [B, NB] int32 block -> start position in the
row's sequence, -1 when not owned. Output [T, H, D] float32.

Dispatch: CPU tensors take the plain version; CUDA tensors take the
kernel, or raise when the kernel refuses the shape. Nothing falls back.

The CUDA kernel does not walk the pool or the packed stream the way
the Pallas kernel does (every pool tile and every packed tile for every
q tile). The wrapper first prepares compact operands on the device
(``_prep_operands``): per row, its owned pages sorted by start position
with the count of valid slots in each, and the [first, last] index span
of its packed tokens. The kernel reads only those, and keeps the
row/position test inside the span, so any packing stays right.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

__all__ = ["ragged_paged_attention", "ragged_attention_path"]

_SUPPORTED_D = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------
def _masks_reference(rows, pos, kv_start, off, block_size, with_pool):
    """(pool_ok [T, T_pool] | None, pack_ok [T, T]) bool validity masks
    from the packed metadata."""
    B, NB = off.shape
    live = rows >= 0
    rc = rows.clamp(0, B - 1).long()
    pool_ok = None
    if with_pool:
        toff = off.repeat_interleave(block_size, dim=1)      # [B, T_pool]
        gpos = toff + torch.arange(block_size, dtype=off.dtype,
                                   device=off.device).repeat(NB)[None, :]
        ok_rows = (toff >= 0) & (gpos < kv_start[:, None])
        pool_ok = ok_rows[rc] & live[:, None]                # [T, T_pool]
    pack_ok = (rows[None, :] == rows[:, None]) \
        & (pos[None, :] <= pos[:, None]) \
        & live[:, None] & live[None, :]                      # [T, T]
    return pool_ok, pack_ok


def _mm32(spec, a, b):
    """einsum with f32 products and sums: a low-precision operand is
    upcast first, which is exact for the products, as the reference's
    preferred_element_type=float32 contractions are."""
    return torch.einsum(spec, a.float(), b.float())


def _ragged_reference(q, k_new, v_new, kpool, vpool, rows, pos, kv_start,
                      off, block_size, scale, kdq=None, vdq=None,
                      with_pool=True):
    """Masked dense ragged attention with the reference's cast order:
    q scaled in f32 and cast back to its dtype for the packed scores,
    to the pool dtype for fp pool scores (kept f32 against an int8
    pool); softmax in f32 over [pool, packed]; probabilities cast to
    the value dtype before each value product; f32 output."""
    T, H, D = q.shape
    Hk = k_new.shape[1]
    rep = H // Hk
    pool_ok, pack_ok = _masks_reference(rows, pos, kv_start, off,
                                        block_size, with_pool)
    qs = q.float() * scale                                   # [T, H, D]
    kr = k_new.repeat_interleave(rep, dim=1) if rep > 1 else k_new
    vr = v_new.repeat_interleave(rep, dim=1) if rep > 1 else v_new
    ss = _mm32("qhd,khd->hqk", qs.to(q.dtype), kr)           # [H, T, T]
    ss = ss.masked_fill(~pack_ok[None], float("-inf"))
    if with_pool:
        cdtype = kpool.dtype
        T_pool = kpool.shape[0]
        q4 = qs.reshape(T, Hk, rep, D)
        qop = q4 if cdtype == torch.int8 else q4.to(cdtype)
        sp = _mm32("qkrd,tkd->krqt", qop, kpool)
        if kdq is not None:
            sp = sp * kdq.float()[:, None, None, None]
        sp = sp.reshape(H, T, T_pool)
        sp = sp.masked_fill(~pool_ok[None], float("-inf"))
        s = torch.cat([sp, ss], dim=-1)
    else:
        T_pool = 0
        s = ss
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)                         # dead rows
    pp, psf = p[..., :T_pool], p[..., T_pool:]
    if with_pool:
        pp = pp.reshape(Hk, rep, T, T_pool)
        ppo = pp if cdtype == torch.int8 else pp.to(cdtype)
        o = _mm32("krqt,tkd->qkrd", ppo, vpool)
        if vdq is not None:
            o = o * vdq.float()[None, :, None, None]
        o = o.reshape(T, H, D)
    else:
        o = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    return o + _mm32("hqk,khd->qhd", psf.to(vr.dtype), vr)


# ---------------------------------------------------------------------------
# CUDA kernel: operand prep, build and launch
# ---------------------------------------------------------------------------
def _prep_operands(rows, pos, kv_start, off, block_size, with_pool):
    """Compact per-row operands the kernel walks instead of the whole
    pool and the whole packed stream (all torch ops on rows' device):

      span_lo/span_hi [B] int32: first/last packed index of each row
        (lo > hi when the row has no packed token);
      page_ids [B, NB] int32: the row's owned pages sorted by start
        position; page_cnt [B, NB] int32: valid slots of each
        (min(kv_start - start, block_size), 0 past the valid ones);
      npages [B] int32: how many leading entries have page_cnt > 0.

    Pages with valid slots sort first, because a page is valid exactly
    when its start lies below kv_start."""
    B, NB = off.shape
    T = rows.shape[0]
    dev = rows.device
    ridx = torch.where(rows >= 0, rows, B).long()
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    span_lo = torch.full((B + 1,), T, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, ridx, ar, "amin")[:B]
    span_hi = torch.full((B + 1,), -1, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, ridx, ar, "amax")[:B]
    out = {"span_lo": span_lo.contiguous(), "span_hi": span_hi.contiguous()}
    if with_pool:
        key = torch.where(off >= 0, off, _INT32_MAX)
        start, order = torch.sort(key, dim=1, stable=True)
        cnt = (kv_start[:, None] - start).clamp(0, block_size)
        cnt = torch.where(start == _INT32_MAX, 0, cnt)
        out["page_ids"] = order.to(torch.int32).contiguous()
        out["page_cnt"] = cnt.to(torch.int32).contiguous()
        out["npages"] = (cnt > 0).sum(dim=1).to(torch.int32).contiguous()
    return out


_LIB = None
_LIB_LOCK = threading.Lock()


def _load_kernel():
    """Build (nvcc, sm_90a) and load the kernel library at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ..utils.build import NVCC_FLAGS, build_shared, nvcc_path
            src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "csrc", "ragged_paged_attention.cu")
            lib = ctypes.CDLL(build_shared("ragged_paged_attention", [src],
                                           nvcc_path(), NVCC_FLAGS))
            fn = lib.ragged_paged_attention_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 15
                           + [ctypes.c_int] * 9
                           + [ctypes.c_longlong] * 3
                           + [ctypes.c_float, ctypes.c_void_p])
            _LIB = lib
    return _LIB


def _shape_reject_reason(T, T_pool, H, Hk, D, block_size, with_pool):
    """None if the CUDA kernel takes this launch shape, else why not."""
    if T < 1:
        return "the packed stream is empty"
    if D not in _SUPPORTED_D:
        return f"head_dim {D} must be one of {_SUPPORTED_D}"
    if Hk < 1 or H % Hk:
        return f"kv heads {Hk} must divide q heads {H}"
    if with_pool:
        if block_size < 1:
            return f"block_size {block_size} must be positive"
        if T_pool % block_size:
            return "pool length must be a multiple of block_size"
    return None


def ragged_attention_path(T, T_pool, H, Hk, D, block_size, with_pool=True,
                          device="cuda"):
    """('cuda' | 'torch' | None, reason): which implementation the
    dispatcher takes for tensors on `device` at this launch shape.
    None means CUDA tensors the kernel refuses: the dispatcher raises."""
    if torch.device(device).type != "cuda":
        return ("torch", "CPU tensors take the plain version")
    reason = _shape_reject_reason(T, T_pool, H, Hk, D, block_size,
                                  with_pool)
    return (None, reason) if reason else ("cuda", "")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ragged_cuda(q, k_new, v_new, kpool, vpool, rows, pos, kv_start, off,
                 block_size, scale, kdq=None, vdq=None, with_pool=True):
    """Launch the CUDA kernel on the current stream. q/k_new/v_new may be
    views with any token stride (the engine slices them out of the fused
    qkv projection); heads and head_dim must be dense."""
    T, H, D = q.shape
    Hk = k_new.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.dtype != q.dtype or t.shape != (T, Hk, D):
            raise ValueError(f"{name} must be {q.dtype} [{T}, {Hk}, {D}]")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.device != dev or t.stride(2) != 1 or t.stride(1) != D \
                or t.stride(0) % 2 or t.data_ptr() % 4:
            raise ValueError(
                f"{name} must lie on {dev} with dense [heads, head_dim] "
                "and an even token stride")
    B, NB = off.shape
    for name, t, n in (("rows", rows, (T,)), ("pos", pos, (T,)),
                       ("kv_start", kv_start, (B,)), ("off", off, (B, NB))):
        if t.dtype != torch.int32 or t.shape != n or t.device != dev:
            raise ValueError(f"{name} must be int32 {list(n)} on {dev}")
    if with_pool:
        if kpool.dtype not in (q.dtype, torch.int8) \
                or vpool.dtype != kpool.dtype:
            raise TypeError(
                f"pools must both be {q.dtype} or int8, got "
                f"{kpool.dtype}/{vpool.dtype}")
        for name, t in (("kpool", kpool), ("vpool", vpool)):
            if t.device != dev or not t.is_contiguous() \
                    or t.shape[1:] != (Hk, D):
                raise ValueError(
                    f"{name} must be a contiguous [T_pool, {Hk}, {D}] "
                    f"tensor on {dev}")
        T_pool = kpool.shape[0]
    else:
        T_pool = 0
    reason = _shape_reject_reason(T, T_pool, H, Hk, D, block_size,
                                  with_pool)
    if reason:
        raise ValueError(f"ragged_paged_attention CUDA kernel: {reason}")
    prep = _prep_operands(rows, pos, kv_start, off, block_size, with_pool)
    dq = [None, None]
    if with_pool:
        for i, s in enumerate((kdq, vdq)):
            if s is not None:
                dq[i] = s.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((T, H, D), dtype=torch.float32, device=dev)
    lib = _load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ragged_paged_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        _ptr(kpool) if with_pool else None,
        _ptr(vpool) if with_pool else None,
        rows.data_ptr(), pos.data_ptr(),
        _ptr(prep.get("page_ids")), _ptr(prep.get("page_cnt")),
        _ptr(prep.get("npages")),
        prep["span_lo"].data_ptr(), prep["span_hi"].data_ptr(),
        _ptr(dq[0]), _ptr(dq[1]), out.data_ptr(),
        T, H, Hk, D, NB, block_size, int(bool(with_pool)),
        _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[kpool.dtype] if with_pool else _DTYPE_CODE[q.dtype],
        q.stride(0), k_new.stride(0), v_new.stride(0),
        float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: error {rc}")
    ragged_paged_attention.kernel_launches += 1
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def ragged_paged_attention(q, k_new, v_new, kpool, vpool, rows, pos,
                           kv_start, off, *, block_size, scale,
                           kdq=None, vdq=None, with_pool=True, path=None):
    """Mixed prefill/decode attention over the paged pool for a packed
    token stream (the module docstring has the layout contract).

    path: None = auto (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors); "cuda" | "torch" force one (tests and the
    kernel-vs-plain comparison)."""
    T, H, D = q.shape
    Hk = k_new.shape[1]
    T_pool = kpool.shape[0] if (with_pool and kpool is not None) else 0
    if path is None:
        path, why = ragged_attention_path(T, T_pool, H, Hk, D, block_size,
                                          with_pool, q.device)
        if path is None:
            raise ValueError(f"ragged_paged_attention CUDA kernel: {why}")
    if path == "cuda":
        return _ragged_cuda(q, k_new, v_new, kpool, vpool, rows, pos,
                            kv_start, off, block_size, scale, kdq=kdq,
                            vdq=vdq, with_pool=with_pool)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    ragged_paged_attention.plain_calls += 1
    return _ragged_reference(q, k_new, v_new, kpool, vpool, rows, pos,
                             kv_start, off, block_size, scale, kdq=kdq,
                             vdq=vdq, with_pool=with_pool)


# launches of the CUDA kernel, and calls of the plain version through the
# dispatcher: a run reads them to show which implementation it went through
ragged_paged_attention.kernel_launches = 0
ragged_paged_attention.plain_calls = 0
