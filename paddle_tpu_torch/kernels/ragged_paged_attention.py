"""Ragged paged attention for the PyTorch port: one launch computes
attention for a packed stream of tokens from rows of any length (fresh
prefill suffixes, prefix-resume tails, single decode tokens).

Counterpart of paddle_tpu/kernels/pallas/ragged_paged_attention.py.
Its TPU kernel ``_ragged_pallas`` (ragged_paged_attention.py:313,
kernel ``_ragged_kernel`` :166) becomes two hand-written CUDA kernels,
``csrc/ragged_paged_attention_sm90.cu`` and
``csrc/ragged_paged_attention.cu`` (below); its jnp reference
``_ragged_reference`` (:101) becomes the plain PyTorch version below.

  * each packed query token attends to (a) its row's already-cached
    context, read from the token-major paged KV pool through the
    per-row block-ownership map, and (b) the packed fresh k/v of its
    OWN row at positions <= its own (causal within the row);
  * fp (bf16/f16/f32) and int8 pools (per-kv-head dequant scales fold into
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

Dispatch: CPU tensors take the plain version; CUDA tensors take a
kernel, or raise when no kernel takes the call. Nothing falls back.

The kernels do not walk the pool or the packed stream the way the
Pallas kernel does (every pool tile and every packed tile for every q
tile). ``ragged_plan`` first builds compact index operands on the
device, once for all the calls that share a wave's metadata (the
engine's layers): per row, its owned pages sorted by start position
with the count of valid slots in each, and the [first, last] index span
of its packed tokens (the simple design); the live tokens sorted by
(row, position) and cut into q tiles of one row each (the tiled
design). Two designs (``_rpa_design`` picks one, ``design_launches``
counts each):

  * "sm90", ``csrc/ragged_paged_attention_sm90.cu``: bf16 or f16 q/k/v
    over pools of the same type at head_dim 64 or 128 with 16-byte
    aligned token rows (the engine's case). A q tile of 64 sorted
    tokens walks its row's pool pages, then its row's packed tokens, in
    key tiles of 64 gathered by cp.async, with S and P·V on wgmma.
  * "simple", ``csrc/ragged_paged_attention.cu``: everything else (f32,
    int8 pools, head_dim 256, unaligned strides). One warp per
    (packed token, q head) walks the row's valid pages and its packed
    span, keeping the row/position test inside the span.

Both are right for any packing.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.build import load_cuda

__all__ = ["ragged_paged_attention", "ragged_attention_path", "ragged_plan"]

_SUPPORTED_D = (64, 128, 256)
# q tile of the tiled design: 64 sorted tokens, one warpgroup
_Q_TILE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float16: 3}
# q dtypes the kernels take; a pool is of q's dtype or int8
_Q_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
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
    """Compact per-row operands the simple design walks instead of the
    whole pool and the whole packed stream (all torch ops on rows'
    device):

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


def _tile_operands(rows, pos, B, pool_keys, pool_full):
    """The q tiles of the tiled design (torch ops on rows' device, no
    host sync): the live tokens sorted by (row, position) into `perm`,
    dead tokens after them, and each row's run cut into tiles of at
    most _Q_TILE tokens.

      perm [T] int32, spos [T] int32: packed index and position of each
        sorted token;
      tiles [NT, 8] int32, one per tile slot: (row, first sorted index,
        tokens, packed keys it needs, the row's first sorted index, the
        row's packed tokens, the row's leading pool slots that are all
        valid (pool_full [B]), 0). A tile needs the row's keys up to
        the last one at or below its largest position. Dead tokens come
        in tiles of row -1 (their outputs are zeroed); unused slots
        have 0 tokens. NT = T // _Q_TILE + B + 2 bounds both for any
        packing. Slots are ordered by the keys they walk (pool_keys
        [B] of the row's plus the packed ones), largest first, so the
        longest tiles start first.
    """
    T = rows.shape[0]
    dev = rows.device
    i64 = torch.int64
    q_tile = _Q_TILE
    live = rows >= 0
    # pos + 2^31 keeps the (row, pos) key increasing for any int32 pos
    key = torch.where(live, rows.to(i64) * 2 ** 32 + pos.to(i64) + 2 ** 31,
                      2 ** 62)
    skey, perm = torch.sort(key, stable=True)
    spos = pos[perm]
    ridx = torch.where(live, rows, B).long()
    cnt = torch.zeros(B + 1, dtype=i64, device=dev).scatter_add_(
        0, ridx, torch.ones(T, dtype=i64, device=dev))[:B]
    rs = torch.cumsum(cnt, 0) - cnt
    n_live = cnt.sum()
    nt = (cnt + q_tile - 1) // q_tile
    tend = torch.cumsum(nt, 0)
    NT = T // q_tile + B + 2
    slot = torch.arange(NT, dtype=i64, device=dev)
    trow = torch.searchsorted(tend, slot, right=True)
    is_live = trow < B
    tr = trow.clamp(max=B - 1)
    j = slot - (tend - nt)[tr]
    lo = rs[tr] + j * q_tile
    n = torch.minimum(cnt[tr] - j * q_tile, torch.full_like(j, q_tile))
    last = (lo + n - 1).clamp(0, T - 1)
    kend = torch.searchsorted(skey, skey[last], right=True) - rs[tr]
    # dead tokens: tiles after the live ones
    k = slot - tend[-1]
    dead_n = (T - n_live - k * q_tile).clamp(0, q_tile)
    zero = torch.zeros_like(slot)
    tiles = torch.stack([
        torch.where(is_live, tr, -1),
        torch.where(is_live, lo, n_live + k * q_tile),
        torch.where(is_live, n, torch.where(k >= 0, dead_n, 0)),
        torch.where(is_live, kend, zero),
        torch.where(is_live, rs[tr], zero),
        torch.where(is_live, cnt[tr], zero),
        torch.where(is_live, pool_full.to(i64)[tr], zero), zero], dim=1)
    work = torch.where(is_live, pool_keys.to(i64)[tr] + kend, zero)
    order = torch.sort(work, descending=True, stable=True).indices
    return {"perm": perm.to(torch.int32).contiguous(),
            "spos": spos.to(torch.int32).contiguous(),
            "tiles": tiles[order].to(torch.int32).contiguous()}


def ragged_plan(rows, pos, kv_start, off, block_size, with_pool):
    """Every index operand the kernels need for one packed launch,
    built by torch ops on rows' device (no host sync). The metadata of
    a packed wave is the same for each of its layers, so the engine
    builds the plan once a wave and passes it to every layer's call
    (``_plan=``). It holds both designs' operands (_prep_operands,
    _tile_operands) and the shapes it was built for; the wrapper
    raises if a call's differ."""
    B, NB = off.shape
    plan = _prep_operands(rows, pos, kv_start, off, block_size, with_pool)
    if with_pool:
        # the row's pages in start order, each block_size virtual slots:
        # the slots before the first page that is not full are all valid
        cnt = plan["page_cnt"]
        j = torch.arange(NB, dtype=torch.int32, device=rows.device)
        pool_keys = cnt.sum(dim=1)
        pool_full = torch.where(cnt < block_size, j * block_size + cnt,
                                NB * block_size).amin(dim=1)
    else:
        pool_keys = pool_full = torch.zeros(B, dtype=torch.int32,
                                            device=rows.device)
    plan.update(_tile_operands(rows, pos, B, pool_keys, pool_full))
    plan["shape"] = (rows.shape[0], B, NB, int(block_size), bool(with_pool),
                     rows.device)
    ragged_paged_attention.plan_builds += 1
    return plan


def _check_plan(plan, T, B, NB, block_size, with_pool, device):
    want = (T, B, NB, int(block_size), bool(with_pool), device)
    if plan["shape"] != want:
        raise ValueError(
            f"ragged_paged_attention: the plan was built for (T, B, NB, "
            f"block_size, with_pool, device) = {plan['shape']}, the call "
            f"is {want}")


_LIB = None
_SM90_LIB = None
_LIB_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the Hopper sources' shared helpers, hashed with them
_SM90_HEADERS = ("sm90_wgmma.cuh",)


def _load_kernel():
    """Build and load ragged_paged_attention.cu (the simple design) at
    first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load_cuda("ragged_paged_attention")
            fn = lib.ragged_paged_attention_launch
            fn.restype = _I
            fn.argtypes = [_P] * 15 + [_I] * 9 + [_L] * 3 + [
                ctypes.c_float, _P]
            _LIB = lib
    return _LIB


def _load_sm90(extra_flags=()):
    """Build and load ragged_paged_attention_sm90.cu (the tiled design),
    its own library, at first use. `extra_flags` (-D ring depths) builds
    and returns a variant without installing it."""
    global _SM90_LIB
    with _LIB_LOCK:
        if _SM90_LIB is None or extra_flags:
            lib = load_cuda("ragged_paged_attention_sm90", _SM90_HEADERS,
                            extra_flags)
            fn = lib.ragged_paged_attention_sm90_launch
            fn.restype = _I
            fn.argtypes = [_P] * 12 + [_I] * 9 + [_L] * 3 + [
                ctypes.c_float, _P]
            if extra_flags:
                return lib
            _SM90_LIB = lib
    return _SM90_LIB


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


_RPA_DESIGNS = ("sm90", "simple")
_SM90_D = (64, 128)
_SM90_DTYPES = (torch.bfloat16, torch.float16)


def _aligned16(*ts):
    """Every tensor starts on 16 bytes and has a 16-byte token stride
    (the tiled design copies 16 bytes a lane)."""
    return all(t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size())
               % 16 == 0 for t in ts)


def _rpa_design(dtype, pool_dtype, d, aligned, design=None, dequant=False):
    """B3's design for q of `dtype` over pools of `pool_dtype` (None
    without a pool) at head_dim `d`; `aligned`: q/k_new/v_new and the
    pools start on 16 bytes with 16-byte token strides; `dequant`: the
    call carries pool dequant scales. "sm90"
    (ragged_paged_attention_sm90.cu) for bf16 or f16 q over pools of
    the same dtype at head_dim 64 or 128 when aligned; "simple"
    (ragged_paged_attention.cu) for the rest: f32, int8 pools (and
    dequant scales), head_dim 256, unaligned token strides.
    `design` forces one (the same-run comparison of the designs); it
    raises for an unknown name, and for "sm90" on a call that design
    does not take."""
    auto = "sm90" if (dtype in _SM90_DTYPES and pool_dtype in (None, dtype)
                      and d in _SM90_D and aligned and not dequant) \
        else "simple"
    if design is None:
        return auto
    if design not in _RPA_DESIGNS:
        raise ValueError(f"unknown B3 design {design!r}, not in "
                         f"{_RPA_DESIGNS}")
    if design == "sm90" and auto != "sm90":
        raise ValueError(
            f"B3's sm90 design takes bf16 or f16 q over pools of its dtype "
            f"at head_dim {_SM90_D} with 16-byte aligned token rows, got "
            f"{dtype} over {pool_dtype} at {d} (aligned: {aligned})")
    return design


def _ragged_cuda(q, k_new, v_new, kpool, vpool, rows, pos, kv_start, off,
                 block_size, scale, kdq=None, vdq=None, with_pool=True,
                 _plan=None, design=None):
    """Launch the CUDA kernel on the current stream. q/k_new/v_new may be
    views with any token stride (the engine slices them out of the fused
    qkv projection); heads and head_dim must be dense. `_plan` is
    ragged_plan's result for this call's metadata (built here when
    None). `design` is private: it forces a design (see _rpa_design);
    nothing on a main path passes it."""
    T, H, D = q.shape
    Hk = k_new.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q must be bf16, f16 or f32, got {q.dtype}")
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
    pools = (kpool, vpool) if with_pool else ()
    design = _rpa_design(q.dtype, kpool.dtype if with_pool else None, D,
                         _aligned16(q, k_new, v_new, *pools), design,
                         dequant=with_pool and (kdq is not None
                                                or vdq is not None))
    if _plan is None:
        _plan = ragged_plan(rows, pos, kv_start, off, block_size, with_pool)
    _check_plan(_plan, T, B, NB, block_size, with_pool, dev)
    out = torch.empty((T, H, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if design == "sm90":
        tiles = _plan["tiles"]
        rc = _load_sm90().ragged_paged_attention_sm90_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            _ptr(kpool) if with_pool else None,
            _ptr(vpool) if with_pool else None,
            _plan["perm"].data_ptr(), _plan["spos"].data_ptr(),
            tiles.data_ptr(), _ptr(_plan.get("page_ids")),
            _ptr(_plan.get("page_cnt")), _ptr(_plan.get("npages")),
            out.data_ptr(), tiles.shape[0], H, Hk, D, NB,
            block_size, T_pool // block_size if with_pool else 0,
            int(bool(with_pool)), _DTYPE_CODE[q.dtype], q.stride(0),
            k_new.stride(0), v_new.stride(0), float(scale), stream)
    else:
        dq = [None, None]
        if with_pool:
            for i, s in enumerate((kdq, vdq)):
                if s is not None:
                    dq[i] = s.to(device=dev,
                                 dtype=torch.float32).contiguous()
        rc = _load_kernel().ragged_paged_attention_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            _ptr(kpool) if with_pool else None,
            _ptr(vpool) if with_pool else None,
            rows.data_ptr(), pos.data_ptr(),
            _ptr(_plan.get("page_ids")), _ptr(_plan.get("page_cnt")),
            _ptr(_plan.get("npages")),
            _plan["span_lo"].data_ptr(), _plan["span_hi"].data_ptr(),
            _ptr(dq[0]), _ptr(dq[1]), out.data_ptr(),
            T, H, Hk, D, NB, block_size, int(bool(with_pool)),
            _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[kpool.dtype] if with_pool else _DTYPE_CODE[q.dtype],
            q.stride(0), k_new.stride(0), v_new.stride(0),
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel ({design}) launch failed: "
            f"error {rc}")
    ragged_paged_attention.kernel_launches += 1
    ragged_paged_attention.design_launches[design] += 1
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def ragged_paged_attention(q, k_new, v_new, kpool, vpool, rows, pos,
                           kv_start, off, *, block_size, scale,
                           kdq=None, vdq=None, with_pool=True, path=None,
                           _plan=None):
    """Mixed prefill/decode attention over the paged pool for a packed
    token stream (the module docstring has the layout contract).

    path: None = auto (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors); "cuda" | "torch" force one (tests and the
    kernel-vs-plain comparison). `_plan` is private: ragged_plan's
    result for this metadata, built once for many calls (the engine's
    layers); the plain version ignores it."""
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
                            vdq=vdq, with_pool=with_pool, _plan=_plan)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    ragged_paged_attention.plain_calls += 1
    return _ragged_reference(q, k_new, v_new, kpool, vpool, rows, pos,
                             kv_start, off, block_size, scale, kdq=kdq,
                             vdq=vdq, with_pool=with_pool)


# launches of the CUDA kernel, calls of the plain version through the
# dispatcher, and plans built: a run reads them to show which
# implementation it went through, and that a wave built its plan once
ragged_paged_attention.kernel_launches = 0
ragged_paged_attention.plain_calls = 0
ragged_paged_attention.design_launches = dict.fromkeys(_RPA_DESIGNS, 0)
ragged_paged_attention.plan_builds = 0


def reset_counters():
    """Set B3's launch, plain-call and plan counters to 0."""
    f = ragged_paged_attention
    f.kernel_launches = f.plain_calls = f.plan_builds = 0
    f.design_launches = dict.fromkeys(_RPA_DESIGNS, 0)
