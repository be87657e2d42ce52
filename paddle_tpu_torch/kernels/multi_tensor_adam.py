"""Adam / AdamW over many tensors in one launch, with its plain PyTorch
version beside it.

Counterpart of paddle_tpu/optimizer/optimizer.py::_fused_step_apply
(:317-458), which traces the Adam rule of every parameter
(optimizers.py:100-121; AdamW's decoupled decay :150-154) into one XLA
executable. That is no Pallas kernel: on the card it becomes the
hand-written CUDA kernel ``csrc/multi_tensor_adam.cu``, one launch over a
table of tensors of unequal sizes.

An ``AdamSlot`` names one tensor's update: the f32 work array ``w`` (the
parameter, or its f32 master), its gradient ``g`` (f32, bf16 or f16,
widened to f32 first as the reference's ``garr.astype`` does), the
moments ``m`` and ``v`` (f32, bf16 or f16; the math in f32, rounded on
the store), the bias-correction powers (f32 scalars, advanced once), the
group's decay ``wd`` (Adam: coupled L2 into the gradient; AdamW:
``lr * wd * w_old`` subtracted after the step), and ``out``: None, or
the bf16/f16 parameter that receives the cast of the new master. Every
array is updated in place, so a CUDA graph that captured the update
replays it on the same storage.

Dispatch (``multi_tensor_adam``): CUDA tensors take the kernel, or the
call raises; CPU tensors take the plain version, the per-tensor rule op
for op (optimizers.py's ``_update_rule``). Nothing falls back.

The statistics variant (``stats=``, the numerics plane's bundle): the
same update, and each slot's five sums (``STATS_COLS``: its gradient's
square-norm and nonfinite count, widened to f32 and taken before Adam's
L2 term, its pre-update square-norm, its update's square-norm and its
new value's nonfinite count) written into a row of an f32 [P, 5] table.
On the card the update kernel itself sums them from the values it holds
in registers (``mta_launch_stats``); the plain version computes them
with ``numerics.pack_stats`` over the one tensor, whose bundle for one
tensor is that row. On the card the launch also needs ``scratch``, an
f32 buffer of ``scratch_floats`` of the slots' sizes (one row a chunk,
which the kernel folds into the table), which the caller owns beside the
table, so a CUDA graph that captured the launch replays on both.
``pack_rows`` lays the table out as ``pack_stats`` lays out its bundle,
in torch ops on either device. Both variants run the same update
arithmetic, so parameters and moments are bit-equal with the statistics
on and off.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..observability.numerics import pack_stats

__all__ = ["AdamSlot", "multi_tensor_adam", "pack_rows", "scratch_floats",
           "STATS_COLS"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NONE_CODE = 3
# a statistics row: g^2, g nonfinite, w^2, (new w - w)^2, new w nonfinite
# (pack_stats' bundle of one tensor)
STATS_COLS = 5
# the elements of one tensor a block of the kernel takes (MTA_CHUNK)
CHUNK = 16384


class AdamSlot(NamedTuple):
    w: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    beta1_pow: torch.Tensor
    beta2_pow: torch.Tensor
    wd: float = 0.0
    out: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# the plain version: the per-tensor rule, written into the slot's arrays
# ---------------------------------------------------------------------------
def _adam_plain(s: AdamSlot, lr, beta1, beta2, eps, decoupled, row=None):
    """One tensor's update, op for op as Adam._update_rule computes it
    (optimizers.py:100-121 and :150-154), then stored in place; with
    `row` (a [STATS_COLS] view) its statistics written there."""
    grad = s.g if s.g.dtype == s.w.dtype else s.g.to(s.w.dtype)
    if s.wd and not decoupled:
        grad = grad + s.wd * s.w
    m = s.m.float()
    v = s.v.float()
    grad32 = grad.float()
    b1p = s.beta1_pow * beta1
    b2p = s.beta2_pow * beta2
    m = beta1 * m + (1 - beta1) * grad32
    v = beta2 * v + (1 - beta2) * torch.square(grad32)
    m_hat = m / (1 - b1p)
    v_hat = v / (1 - b2p)
    upd = (lr * m_hat / (torch.sqrt(v_hat) + eps)).to(s.w.dtype)
    new_w = s.w - upd
    if s.wd and decoupled:
        new_w = new_w - lr * s.wd * s.w
    if row is not None:
        row.copy_(pack_stats([s.w], [s.g], [new_w]))
    s.w.copy_(new_w)
    s.m.copy_(m)
    s.v.copy_(v)
    s.beta1_pow.copy_(b1p)
    s.beta2_pow.copy_(b2p)
    if s.out is not None:
        s.out.copy_(new_w)


# ---------------------------------------------------------------------------
# the CUDA kernel: build and launch
# ---------------------------------------------------------------------------
_LIB = None
_LIB_LOCK = threading.Lock()


def _load_kernel():
    """Build (nvcc, sm_90a) and load the kernel library at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ..utils.build import load_cuda
            lib = load_cuda("multi_tensor_adam")
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.mta_launch.restype = I
            lib.mta_launch.argtypes = [I, P, P, P, P, P, F, F, F, F, F, I,
                                       P]
            lib.mta_launch_stats.restype = I
            lib.mta_launch_stats.argtypes = [I, P, P, P, P, P, P, F, F, F,
                                             F, F, I, P, P, P]
            for fn in (lib.mta_max_tensors, lib.mta_chunk,
                       lib.mta_stats_cols):
                fn.restype = I
            if (lib.mta_stats_cols(), lib.mta_chunk()) != (STATS_COLS,
                                                           CHUNK):
                raise RuntimeError("multi_tensor_adam: the kernel's "
                                   "statistics row or chunk disagrees "
                                   "with STATS_COLS / CHUNK")
            _LIB = lib
    return _LIB


def _check_slot(i, s: AdamSlot, dev):
    """Raise on what the kernel does not take: every array on `dev`, w
    f32, m and v of one type, the written arrays dense, one size."""
    n = s.w.numel()
    for what, t, dtypes, written in (
            ("w", s.w, (torch.float32,), True),
            ("g", s.g, tuple(_DTYPE_CODE), False),
            ("m", s.m, tuple(_DTYPE_CODE), True),
            ("v", s.v, (s.m.dtype,), True),
            ("out", s.out, (torch.bfloat16, torch.float16), True)):
        if t is None:
            continue
        if t.device != dev or t.dtype not in dtypes or t.numel() != n \
                or (written and not t.is_contiguous()):
            raise ValueError(
                f"multi_tensor_adam: tensor {i}'s {what} must be a "
                f"{'dense ' if written else ''}{n}-element tensor of "
                f"{[str(d) for d in dtypes]} on {dev}, got {t.dtype} "
                f"{list(t.shape)} on {t.device}")
    for what, t in (("beta1_pow", s.beta1_pow), ("beta2_pow", s.beta2_pow)):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"multi_tensor_adam: tensor {i}'s {what} must "
                             f"be an f32 scalar on {dev}")


def _chunks(numel: int) -> int:
    return (numel + CHUNK - 1) // CHUNK


def scratch_floats(numels: Sequence[int]) -> int:
    """The f32 elements of the statistics variant's scratch for tensors
    of these sizes: one [STATS_COLS] row for each chunk of each."""
    return STATS_COLS * sum(_chunks(int(n)) for n in numels)


def _check_table(stats, rows, dev):
    if stats.device != dev or stats.dtype != torch.float32 \
            or stats.dim() != 2 or stats.shape[1] != STATS_COLS \
            or not stats.is_contiguous():
        raise ValueError(f"multi_tensor_adam: stats must be a dense f32 "
                         f"[P, {STATS_COLS}] tensor on {dev}, got "
                         f"{stats.dtype} {list(stats.shape)} on "
                         f"{stats.device}")
    if rows and not 0 <= min(rows) <= max(rows) < stats.shape[0]:
        raise ValueError(f"multi_tensor_adam: a position lies outside "
                         f"the {stats.shape[0]}-row statistics table")


def _launch(slots: Sequence[AdamSlot], lr, beta1, beta2, eps, decoupled,
            stats=None, positions=None, scratch=None):
    """The kernel over `slots` on the current stream: one launch for each
    MTA_MAX_TENSORS of them (the statistics variant with `stats`, each
    launch's rows at its own offset of `scratch`)."""
    dev = slots[0].w.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"multi_tensor_adam: lr must be an f32 scalar on "
                         f"{dev}")
    if stats is not None:
        need = scratch_floats(s.w.numel() for s in slots)
        if scratch is None or scratch.device != dev \
                or scratch.dtype != torch.float32 \
                or not scratch.is_contiguous() or scratch.numel() < need:
            raise ValueError(f"multi_tensor_adam: the statistics need a "
                             f"dense f32 scratch of {need} elements on "
                             f"{dev}")
    lib = _load_kernel()
    per = lib.mta_max_tensors()
    offset = 0          # the launch's first row of `scratch`, in floats
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(slots), per):
        part = slots[lo:lo + per]
        ptrs = np.zeros((len(part), 7), np.uint64)
        n = np.zeros(len(part), np.int64)
        wd = np.zeros(len(part), np.float32)
        codes = np.zeros(len(part), np.int32)
        grads = []      # dense copies of strided gradients, kept alive
        for i, s in enumerate(part):
            _check_slot(lo + i, s, dev)
            g = s.g if s.g.is_contiguous() else s.g.contiguous()
            grads.append(g)
            ptrs[i] = (s.w.data_ptr(), g.data_ptr(), s.m.data_ptr(),
                       s.v.data_ptr(),
                       0 if s.out is None else s.out.data_ptr(),
                       s.beta1_pow.data_ptr(), s.beta2_pow.data_ptr())
            n[i] = s.w.numel()
            wd[i] = s.wd
            codes[i] = (_DTYPE_CODE[g.dtype] | _DTYPE_CODE[s.m.dtype] << 2
                        | (_NONE_CODE if s.out is None
                           else _DTYPE_CODE[s.out.dtype]) << 4)
        hyper = (lr.data_ptr(), beta1, 1 - beta1, beta2, 1 - beta2, eps,
                 int(decoupled))
        if stats is None:
            rc = lib.mta_launch(
                len(part), ptrs.ctypes.data, n.ctypes.data, wd.ctypes.data,
                codes.ctypes.data, *hyper, stream)
        else:
            pos = np.asarray(positions[lo:lo + per], np.int32)
            rc = lib.mta_launch_stats(
                len(part), ptrs.ctypes.data, n.ctypes.data, wd.ctypes.data,
                codes.ctypes.data, pos.ctypes.data, *hyper,
                scratch.data_ptr() + 4 * offset, stats.data_ptr(), stream)
            offset += scratch_floats(n)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_adam kernel launch failed: "
                               f"error {rc}")
        multi_tensor_adam.kernel_launches += 1
        if stats is not None:
            multi_tensor_adam.stats_launches += 1


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@torch.no_grad()
def multi_tensor_adam(slots: Sequence[AdamSlot], lr: torch.Tensor, *,
                      beta1: float, beta2: float, eps: float,
                      decoupled: bool, path: Optional[str] = None,
                      stats: Optional[torch.Tensor] = None,
                      positions: Optional[Sequence[int]] = None,
                      scratch: Optional[torch.Tensor] = None):
    """Update every slot in place: Adam (``decoupled=False``: each slot's
    ``wd`` is coupled L2) or AdamW (``decoupled=True``). `lr` is an f32
    scalar tensor on the slots' device. path: None = by device (the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors); "cuda"
    | "torch" force one (tests and the kernel-vs-plain comparison).

    `stats`: an f32 [P, STATS_COLS] table on the slots' device; slot i's
    statistics go to its row `positions[i]` (default i). `scratch`: the
    kernel's per-chunk rows, a dense f32 tensor of at least
    ``scratch_floats`` of the slots' sizes (the card needs it with
    `stats`; the plain version takes none)."""
    slots = list(slots)
    if not slots:
        return
    if path is None:
        path = "cuda" if slots[0].w.device.type == "cuda" else "torch"
    if stats is not None:
        positions = list(range(len(slots)) if positions is None
                         else positions)
        if len(positions) != len(slots):
            raise ValueError("multi_tensor_adam: one position a slot")
        _check_table(stats, positions, slots[0].w.device)
    if path == "cuda":
        return _launch(slots, lr, beta1, beta2, eps, decoupled, stats,
                       positions, scratch)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    multi_tensor_adam.plain_calls += 1
    for i, s in enumerate(slots):
        _adam_plain(s, lr, beta1, beta2, eps, decoupled,
                    None if stats is None else stats[positions[i]])


# launches of the CUDA kernel (one a table of up to MTA_MAX_TENSORS
# tensors; the statistics variant's counted again in stats_launches) and
# calls of the plain version: a run reads them to show which
# implementation it went through
multi_tensor_adam.kernel_launches = 0
multi_tensor_adam.stats_launches = 0
multi_tensor_adam.plain_calls = 0


@torch.no_grad()
def pack_rows(stats: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The [P, STATS_COLS] statistics table laid out as the reference's
    pack_stats bundle: [P grad square-norms, P grad nonfinite counts,
    pre-update square-norm, update square-norm, new nonfinite count], f32
    [2P + 3], written into `out` when given (a few torch ops over a
    [P, 5] table, on either device, captured with the update)."""
    packed = torch.cat([stats[:, 0], stats[:, 1], stats[:, 2:].sum(0)])
    return packed if out is None else out.copy_(packed)
