"""Fused row norms for the PyTorch port: layer norm (B4) and RMS norm
(B5), with the plain PyTorch versions beside them.

Counterpart of paddle_tpu/kernels/pallas/norms.py. Its TPU kernels
``_ln_pallas`` (norms.py:68, kernel ``_ln_kernel`` :17) and
``_rms_pallas`` (:88, kernel ``_rms_kernel`` :30) become the
hand-written CUDA kernels in ``csrc/norms.cu``; ``_ln_core`` and
``_rms_core`` (:127-180, jax.custom_vjp) become ``_LayerNormCore`` and
``_RMSNormCore``, ``torch.autograd.Function``s.

The reference computes two different functions under one name, and the
port keeps both:

  * the kernels' own math (``_ln_plain``/``_rms_plain`` here, of
    ``_ln_kernel`` :17-27 and ``_rms_kernel`` :30-36): f32 statistics,
    the weight and bias applied in f32, then ONE cast to x's dtype. The
    CUDA kernels compute this, and are held to these plain versions;
  * the reference's off-TPU forms (``_ln_xla`` :105-115, ``_rms_xla``
    :118-124): the normalised value is cast to x's dtype FIRST and the
    affine applied after, in the promoted dtype. ``_ln_core`` takes these
    off the TPU (:132-134, :162-164), so the port's CPU path does too,
    and both packages' backward differentiates them (:141-147,
    :171-177).

In bf16 the two differ by up to about 2 bf16 ulps of the output.

Dispatch (``layer_norm_fwd``, ``rms_norm_fwd``): CUDA tensors take the
kernel, or raise when it refuses the call; CPU tensors take the
``_xla`` form. Nothing falls back. The reference's gate (rows % 8 == 0
and h % 128 == 0, :132, :162) is a TPU tiling rule and is dropped: the
kernels take any n >= 1 rows of any width h >= 1. The reference has no
backward kernel, so the port has none: the backward is torch autograd
through the ``_xla`` form, and a missing weight or bias gets no
gradient.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

__all__ = ["layer_norm", "rms_norm", "layer_norm_fwd", "rms_norm_fwd"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _wide(t):
    """Low-precision values widened to f32 (exact), as the reference's
    ``astype(float32)``; f32 and f64 stay as they are (f64 for gradcheck)."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


# ---------------------------------------------------------------------------
# plain versions of the kernels' math (their yardstick on the card)
# ---------------------------------------------------------------------------
def _ln_plain(x, w, b, eps):
    """_ln_kernel (:17-27): mean, variance as the mean of (x - mean)^2,
    normalise, the affine in f32, one cast to x's dtype."""
    x32 = _wide(x)
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * _wide(w)
    if b is not None:
        y = y + _wide(b)
    return y.to(x.dtype)


def _rms_plain(x, w, eps):
    """_rms_kernel (:30-36): x * rsqrt(mean(x^2) + eps) in f32, the
    weight in f32, one cast to x's dtype."""
    x32 = _wide(x)
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * _wide(w)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# the reference's off-TPU forms (the CPU path, and what the backward
# differentiates)
# ---------------------------------------------------------------------------
def _ln_xla(x, w, b, eps, axes=(-1,)):
    """_ln_xla (:105-115): f32 statistics over `axes` (the last one by
    default), the normalised value cast to x's dtype, then the affine in
    the promoted dtype."""
    x32 = _wide(x)
    mean = x32.mean(dim=axes, keepdim=True)
    var = x32.var(dim=axes, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


def _rms_xla(x, w, eps):
    """_rms_xla (:118-124): x * rsqrt(mean(x^2) + eps) in f32, cast to
    x's dtype, then the weight in the promoted dtype."""
    x32 = _wide(x)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    if w is not None:
        y = y * w
    return y


# ---------------------------------------------------------------------------
# CUDA kernels: build and launch
# ---------------------------------------------------------------------------
_LIB = None
_LIB_LOCK = threading.Lock()


def _load_kernel():
    """Build (nvcc, sm_90a) and load the kernel library at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ..utils.build import NVCC_FLAGS, build_shared, nvcc_path
            src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "csrc", "norms.cu")
            lib = ctypes.CDLL(build_shared("norms", [src], nvcc_path(),
                                           NVCC_FLAGS))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.norm_launch
            fn.restype = I
            fn.argtypes = ([I, P, P, P, P, L, I, L, L, I, I, I,
                            ctypes.c_float, P])
            _LIB = lib
    return _LIB


def _rows(x):
    """x as [n, h] rows with a dense last axis, viewed where it can be:
    a 2-D view with any row stride is read in place."""
    if x.dim() == 2 and x.stride(1) == 1:
        return x
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(1) == 1 else x2.contiguous()


def _kernel_args(name, x, w, b):
    """(x2d, w, w dtype code, b, b dtype code) as the kernel reads them,
    or raise on what it does not take. Any n >= 0 rows of any width
    h >= 1 are taken: the reference's TPU gate (rows % 8, h % 128) is
    not a rule of this kernel. A 2-D x is read in place with its row
    stride; other shapes are flattened to rows (copied only when the
    last axis is not dense)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} CUDA kernel: x must be f32, bf16 or f16, "
                        f"got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name} CUDA kernel: x must have a last axis of "
                         f"width >= 1, got {list(x.shape)}")
    h = x.shape[-1]
    ops = []
    for what, p in (("weight", w), ("bias", b)):
        if p is None:
            ops.extend((None, 0))
            continue
        if p.device != x.device or p.dtype not in _DTYPE_CODE \
                or p.shape != (h,):
            raise ValueError(
                f"{name} CUDA kernel: {what} must be an f32, bf16 or f16 "
                f"[{h}] tensor on {x.device}, got {p.dtype} "
                f"{list(p.shape)} on {p.device}")
        ops.extend((p.contiguous(), _DTYPE_CODE[p.dtype]))
    x2 = _rows(x)
    if x2.shape[0] > 2 ** 31 - 1:
        raise ValueError(f"{name} CUDA kernel: {x2.shape[0]} rows exceed "
                         "one grid")
    return (x2, *ops)


def _norm_cuda(rms, x, w, b, eps):
    """Launch B5 (rms=True) or B4 on the current stream. Returns a tensor
    of x's shape and dtype."""
    name = "rms_norm" if rms else "layer_norm"
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    x2, wt, wc, bt, bc = _kernel_args(name, x, w, b)
    n, h = x2.shape
    out = torch.empty((n, h), dtype=x.dtype, device=dev)
    if n == 0:
        return out.reshape(x.shape)
    lib = _load_kernel()
    rc = lib.norm_launch(
        int(rms), x2.data_ptr(), None if wt is None else wt.data_ptr(),
        None if bt is None else bt.data_ptr(), out.data_ptr(), n, h,
        x2.stride(0), h, _DTYPE_CODE[x.dtype], wc, bc, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc}")
    (rms_norm_fwd if rms else layer_norm_fwd).kernel_launches += 1
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def layer_norm_fwd(x, weight=None, bias=None, eps=1e-5, path=None):
    """B4's forward over the last axis. path: None = by device (the CUDA
    kernel for CUDA tensors, the ``_xla`` form for CPU tensors, as
    ``_ln_core`` takes it off the TPU); "cuda" | "torch" (the kernel's
    own math: its plain version) force one."""
    if path == "cuda" or (path is None and x.device.type == "cuda"):
        return _norm_cuda(False, x, weight, bias, eps)
    if path not in (None, "torch"):
        raise ValueError(f"unknown path {path!r}")
    layer_norm_fwd.plain_calls += 1
    fn = _ln_plain if path == "torch" else _ln_xla
    return fn(x, weight, bias, eps)


def rms_norm_fwd(x, weight=None, eps=1e-6, path=None):
    """B5's forward over the last axis; path as for layer_norm_fwd."""
    if path == "cuda" or (path is None and x.device.type == "cuda"):
        return _norm_cuda(True, x, weight, None, eps)
    if path not in (None, "torch"):
        raise ValueError(f"unknown path {path!r}")
    rms_norm_fwd.plain_calls += 1
    fn = _rms_plain if path == "torch" else _rms_xla
    return fn(x, weight, eps)


# launches of the CUDA kernels, and calls of the plain versions (either
# form) through the dispatchers: a run reads them to show which
# implementation it went through
layer_norm_fwd.kernel_launches = 0
layer_norm_fwd.plain_calls = 0
rms_norm_fwd.kernel_launches = 0
rms_norm_fwd.plain_calls = 0


def _xla_grads(ctx, fn, g, tensors, extra):
    """Gradients of the ``_xla`` form `fn` at the saved inputs (None for
    an absent input or one that needs none)."""
    need = ctx.needs_input_grad[:len(tensors)]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(tensors, need)]
        y = fn(*leaves, *extra)
        wrt = [t for t, n in zip(leaves, need) if t is not None and n]
        grads = iter(torch.autograd.grad(y, wrt, g.to(y.dtype))
                     if wrt else ())
    return [next(grads) if t is not None and n else None
            for t, n in zip(leaves, need)]


class _LayerNormCore(torch.autograd.Function):
    """_ln_core / _ln_fwd / _ln_bwd (:127-154): the forward by device
    (B4 on the card), the backward through the ``_xla`` form."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return layer_norm_fwd(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_xla_grads(ctx, _ln_xla, g, ctx.saved_tensors, (ctx.eps,)),
                None)


class _RMSNormCore(torch.autograd.Function):
    """_rms_core / _rms_fwd / _rms_bwd (:157-180)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_xla_grads(ctx, _rms_xla, g, ctx.saved_tensors,
                            (ctx.eps,)), None)


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """Layer norm over the last axis (norms.py:183), differentiable."""
    return _LayerNormCore.apply(x, weight, bias, float(eps))


def rms_norm(x, weight=None, eps=1e-6):
    """RMS norm over the last axis (norms.py:187), differentiable."""
    return _RMSNormCore.apply(x, weight, float(eps))
