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
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["AdamSlot", "multi_tensor_adam"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NONE_CODE = 3


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
def _adam_plain(s: AdamSlot, lr, beta1, beta2, eps, decoupled):
    """One tensor's update, op for op as Adam._update_rule computes it
    (optimizers.py:100-121 and :150-154), then stored in place."""
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
            lib.mta_max_tensors.restype = I
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


def _launch(slots: Sequence[AdamSlot], lr, beta1, beta2, eps, decoupled):
    """The kernel over `slots` on the current stream: one launch for each
    MTA_MAX_TENSORS of them."""
    dev = slots[0].w.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"multi_tensor_adam: lr must be an f32 scalar on "
                         f"{dev}")
    lib = _load_kernel()
    per = lib.mta_max_tensors()
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
        rc = lib.mta_launch(
            len(part), ptrs.ctypes.data, n.ctypes.data, wd.ctypes.data,
            codes.ctypes.data, lr.data_ptr(), beta1, 1 - beta1, beta2,
            1 - beta2, eps, int(decoupled), stream)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_adam kernel launch failed: "
                               f"error {rc}")
        multi_tensor_adam.kernel_launches += 1


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@torch.no_grad()
def multi_tensor_adam(slots: Sequence[AdamSlot], lr: torch.Tensor, *,
                      beta1: float, beta2: float, eps: float,
                      decoupled: bool, path: Optional[str] = None):
    """Update every slot in place: Adam (``decoupled=False``: each slot's
    ``wd`` is coupled L2) or AdamW (``decoupled=True``). `lr` is an f32
    scalar tensor on the slots' device. path: None = by device (the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors); "cuda"
    | "torch" force one (tests and the kernel-vs-plain comparison)."""
    slots = list(slots)
    if not slots:
        return
    if path is None:
        path = "cuda" if slots[0].w.device.type == "cuda" else "torch"
    if path == "cuda":
        return _launch(slots, lr, beta1, beta2, eps, decoupled)
    if path != "torch":
        raise ValueError(f"unknown path {path!r}")
    multi_tensor_adam.plain_calls += 1
    for s in slots:
        _adam_plain(s, lr, beta1, beta2, eps, decoupled)


# launches of the CUDA kernel (one a table of up to MTA_MAX_TENSORS
# tensors) and calls of the plain version: a run reads them to show which
# implementation it went through
multi_tensor_adam.kernel_launches = 0
multi_tensor_adam.plain_calls = 0
