"""paddle_tpu_torch.fft: the discrete Fourier transform family
(counterpart of paddle_tpu/fft.py).

numpy's conventions, ``norm`` one of backward, ortho and forward, each
function a registered ``fft_*`` op computed by ``torch.fft`` (cuFFT on
the card); gradients come from torch.autograd. ``hfft2``, ``hfftn``,
``ihfft2`` and ``ihfftn`` are the reference's Hermitian composites
(hfft(x) = irfft(conj(x)) with the norm direction swapped), not torch's
own ``hfftn``.

The reference computes without x64; its complex transforms promote
bfloat16 and float16 to complex64, and its real-input ones (the rfft
family) raise on them. cuFFT takes float16 only at power-of-two sizes
and bfloat16 not at all, so the port casts every half-precision input
to float32 before the transform: its outputs' dtypes are the
reference's where the reference has an output.
"""
from __future__ import annotations

import torch

from .core import dtype as dtypes
from .core.device import default_torch_device
from .ops.registry import register_op

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("backward", "ortho", "forward")
_HALF = (torch.float16, torch.bfloat16)


def _check_norm(norm):
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    return norm


def _swap_norm(norm):
    """forward <-> backward: an inverse transform with the norm swapped
    is the unnormalized forward (the Hermitian composites)."""
    return {"backward": "forward", "forward": "backward",
            "ortho": "ortho"}[norm]


def _up(x: torch.Tensor) -> torch.Tensor:
    """x with half precision (and integers) promoted to float32, as
    jnp.fft promotes them."""
    if x.dtype in _HALF or not (x.is_floating_point() or x.is_complex()):
        return x.to(torch.float32)
    return x


def _dims(axes):
    if axes is None or isinstance(axes, int):
        return axes
    return tuple(axes)


def _size(s):
    return None if s is None else tuple(int(v) for v in s)


@register_op("fft_fft")
def fft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.fft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_ifft")
def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ifft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_rfft")
def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.rfft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_irfft")
def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.irfft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_hfft")
def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.hfft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_ihfft")
def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ihfft(_up(x), n=n, dim=axis, norm=_check_norm(norm))


@register_op("fft_fft2")
def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.fft2(_up(x), s=_size(s), dim=_dims(axes),
                          norm=_check_norm(norm))


@register_op("fft_ifft2")
def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.ifft2(_up(x), s=_size(s), dim=_dims(axes),
                           norm=_check_norm(norm))


@register_op("fft_rfft2")
def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.rfft2(_up(x), s=_size(s), dim=_dims(axes),
                           norm=_check_norm(norm))


@register_op("fft_irfft2")
def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.irfft2(_up(x), s=_size(s), dim=_dims(axes),
                            norm=_check_norm(norm))


def _hermitian_n(x, s, axes, norm):
    return torch.fft.irfftn(torch.conj(_up(x)).resolve_conj(), s=_size(s),
                            dim=_dims(axes),
                            norm=_swap_norm(_check_norm(norm)))


def _ihermitian_n(x, s, axes, norm):
    return torch.conj(torch.fft.rfftn(
        _up(x), s=_size(s), dim=_dims(axes),
        norm=_swap_norm(_check_norm(norm)))).resolve_conj()


@register_op("fft_hfft2")
def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _hermitian_n(x, s, axes, norm)


@register_op("fft_ihfft2")
def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _ihermitian_n(x, s, axes, norm)


@register_op("fft_fftn")
def fftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.fftn(_up(x), s=_size(s), dim=_dims(axes),
                          norm=_check_norm(norm))


@register_op("fft_ifftn")
def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.ifftn(_up(x), s=_size(s), dim=_dims(axes),
                           norm=_check_norm(norm))


@register_op("fft_rfftn")
def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.rfftn(_up(x), s=_size(s), dim=_dims(axes),
                           norm=_check_norm(norm))


@register_op("fft_irfftn")
def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.irfftn(_up(x), s=_size(s), dim=_dims(axes),
                            norm=_check_norm(norm))


@register_op("fft_hfftn")
def hfftn(x, s=None, axes=None, norm="backward", name=None):
    return _hermitian_n(x, s, axes, norm)


@register_op("fft_ihfftn")
def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    return _ihermitian_n(x, s, axes, norm)


def _freq_dtype(dtype):
    return torch.float32 if dtype is None else dtypes.to_dtype(dtype)


@register_op("fft_fftfreq")
def fftfreq(n, d=1.0, dtype=None, name=None):
    """The sample frequencies of an n-point transform, on the default
    place (the card unless ``set_device("cpu")``)."""
    return torch.fft.fftfreq(int(n), d=float(d), dtype=torch.float32,
                             device=default_torch_device()).to(
        _freq_dtype(dtype))


@register_op("fft_rfftfreq")
def rfftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.rfftfreq(int(n), d=float(d), dtype=torch.float32,
                              device=default_torch_device()).to(
        _freq_dtype(dtype))


@register_op("fft_fftshift")
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=_dims(axes))


@register_op("fft_ifftshift")
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=_dims(axes))
