"""paddle_tpu_torch.signal: short-time Fourier analysis (counterpart of
paddle_tpu/signal.py).

``frame`` is a strided view of the signal (``Tensor.unfold``),
``overlap_add`` one ``index_add`` over every frame's sample indices, so
duplicate indices add up. ``stft`` and ``istft`` are the reference's
own composites over them and ``torch.fft``, not ``torch.stft`` /
``torch.istft``: the window centred inside ``n_fft``, the COLA
denominator with its 1e-11 guard and the trimming with and without
``length`` are the function. Each is a registered op, differentiable
through torch.autograd.

``pad_mode`` takes the two modes Paddle documents, ``reflect`` and
``constant``; the reference hands any numpy mode to ``jnp.pad``, and the
port raises NotImplementedError for the others.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import fft as _fft
from .core.tensor import Tensor
from .ops.registry import register_op

__all__ = ["frame", "overlap_add", "stft", "istft"]

_PAD_MODES = ("reflect", "constant")


def _frames(x, frame_length, hop_length, axis=-1):
    """[..., n, frame_length] (axis -1) or [n, frame_length, ...] (axis
    0): a view of x, frame i starting at i * hop_length."""
    if frame_length <= 0 or hop_length <= 0:
        raise ValueError("frame_length and hop_length must be positive")
    if axis not in (0, -1):
        raise ValueError("axis must be 0 or -1")
    n_time = x.shape[axis]
    if frame_length > n_time:
        raise ValueError(
            f"frame_length {frame_length} > signal length {n_time}")
    if axis == -1:
        return x.unfold(-1, frame_length, hop_length)
    return x.unfold(0, frame_length, hop_length).movedim(-1, 1)


def _add_frames(x, hop_length):
    """Overlap-add of frames x [..., n, frame_length] at stride
    hop_length: [..., (n - 1) * hop_length + frame_length]."""
    n_frames, frame_length = x.shape[-2], x.shape[-1]
    out_len = (n_frames - 1) * hop_length + frame_length
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop_length
           + torch.arange(frame_length, device=x.device)[None, :])
    lead = x.shape[:-2]
    out = x.new_zeros(lead + (out_len,))
    return out.index_add(-1, idx.reshape(-1),
                         x.reshape(lead + (n_frames * frame_length,)))


@register_op("signal_frame")
def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames; the frame axis sits next to the time axis
    (axis -1: [..., frame_length, n]; axis 0: [n, frame_length, ...])."""
    f = _frames(x, frame_length, hop_length, axis)
    return f.transpose(-1, -2) if axis == -1 else f


@register_op("signal_overlap_add")
def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of frame: frames at stride hop_length add into the
    output signal (x [..., frame_length, n] for axis -1, [n,
    frame_length, ...] for axis 0)."""
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    if axis not in (0, -1):
        raise ValueError("axis must be 0 or -1")
    if axis == -1:
        return _add_frames(x.transpose(-1, -2), hop_length)
    # [n, fl, ...] -> [..., n, fl] -> [..., out] -> [out, ...]
    moved = x.movedim((0, 1), (-2, -1))
    return _add_frames(moved, hop_length).movedim(-1, 0)


def _window(window, win_length, n_fft, dtype, device):
    """The analysis window in `dtype`, centred inside n_fft."""
    if window is None:
        w = torch.ones((win_length,), dtype=dtype, device=device)
    else:
        w = window._data if isinstance(window, Tensor) else \
            torch.as_tensor(window, device=device)
        if tuple(w.shape) != (win_length,):
            raise ValueError(
                f"window must have shape ({win_length},), got "
                f"{tuple(w.shape)}")
        w = w.to(dtype)
    if win_length < n_fft:
        pad_l = (n_fft - win_length) // 2
        w = F.pad(w, (pad_l, n_fft - win_length - pad_l))
    return w


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype if dtype.is_complex \
        else dtype


def _center_pad(data, pad, pad_mode):
    if pad_mode not in _PAD_MODES:
        raise NotImplementedError(
            f"stft pad_mode {pad_mode!r} is not ported; use one of "
            f"{_PAD_MODES}")
    if pad_mode == "constant":
        return F.pad(data, (pad, pad))
    # torch's reflect pad takes a batch of channels: [1, (batch,) time]
    return F.pad(data.unsqueeze(0), (pad, pad), mode="reflect").squeeze(0)


@register_op("signal_stft")
def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False,
         onesided=True, name=None):
    """x [batch?, seq] -> [batch?, n_fft // 2 + 1 (or n_fft), n_frames],
    complex."""
    data = x
    if data.dim() not in (1, 2):
        raise ValueError("stft expects a 1D or 2D input")
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if not (0 < win_length <= n_fft):
        raise ValueError("0 < win_length <= n_fft required")
    is_complex = data.is_complex()
    if onesided and is_complex:
        raise ValueError("onesided is not supported for complex input")
    w = _window(window, win_length, n_fft, _real_dtype(data.dtype),
                data.device)
    if center:
        data = _center_pad(data, n_fft // 2, pad_mode)
    frames = _frames(data, n_fft, hop_length) * w   # [..., n, n_fft]
    frames = _fft._up(frames)
    spec = torch.fft.rfft(frames, dim=-1) if onesided \
        else torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return spec.transpose(-1, -2)


@register_op("signal_istft")
def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT with the COLA window normalization:
    [batch?, n_freq, n_frames] -> [batch?, samples]."""
    spec = x
    if spec.dim() not in (2, 3):
        raise ValueError("istft expects [.., n_freq, n_frames]")
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    n_freq = spec.shape[-2]
    if onesided and n_freq != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} freq bins, "
                         f"got {n_freq}")
    if not onesided and n_freq != n_fft:
        raise ValueError(f"expected {n_fft} freq bins, got {n_freq}")
    spec = _fft._up(spec).transpose(-1, -2)    # [..., n_frames, n_freq]
    if normalized:
        spec = spec * math.sqrt(n_fft)
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, n=n_fft, dim=-1)
        if not return_complex:
            frames = frames.real
    w = _window(window, win_length, n_fft, _real_dtype(frames.dtype),
                frames.device)
    y = _add_frames(frames * w, hop_length)
    # the COLA denominator: the overlap-added squared window
    n_frames = frames.shape[-2]
    denom = _add_frames((w * w).expand(n_frames, n_fft), hop_length)
    y = y / torch.where(denom > 1e-11, denom, torch.ones_like(denom))
    if center:
        pad = n_fft // 2
        # with a length only the left pad is trimmed and the right edge
        # extends into the final frames; without one both pads go
        y = y[..., pad:] if length is not None \
            else y[..., pad:y.shape[-1] - pad]
    if length is not None:
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y
