"""Audio functional ops (counterpart of paddle_tpu/audio/functional.py):
the standard (librosa / HTK) mel and DCT formulas in float32.

The matrices (``mel_frequencies``, ``fft_frequencies``,
``compute_fbank_matrix``, ``create_dct``) and the windows
(``get_window``) are made on the CPU and then moved to `device` (None:
the eager default place, the card unless ``set_device("cpu")``), so a
card and a CPU get the same values. ``get_window`` keeps the
reference's numpy float64 formulas, cast to float32 at the end, so its
windows are bit-equal to the reference's. ``hz_to_mel`` /
``mel_to_hz`` take a Python number (and return one) or a Tensor, and
``power_to_db`` a Tensor, computed on its device."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import NARROW, Tensor
from ..nn.layer import layer_device

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct",
           "get_window"]


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _out(t: torch.Tensor, dtype, device) -> Tensor:
    """A CPU result cast to `dtype` (64-bit types narrowed, as the
    reference computes without x64) on `device`."""
    d = dtypes.to_dtype(dtype)
    return Tensor._wrap(t.to(layer_device(device), NARROW.get(d, d)))


def _f32(x):
    """(x as a float32 torch tensor, whether x was a Python number)."""
    if isinstance(x, Tensor) or isinstance(x, torch.Tensor) or hasattr(
            x, "shape"):
        return torch.as_tensor(_unwrap(x)).to(torch.float32), False
    return torch.tensor(float(x), dtype=torch.float32), True


_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f, htk):
    if htk:
        return 2595.0 * torch.log10(1.0 + f / 700.0)
    mel = f / _F_SP
    return torch.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + torch.log(torch.clamp(f, min=1e-10) / _MIN_LOG_HZ)
        / _LOGSTEP, mel)


def _mel_to_hz(m, htk):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return torch.where(
        m >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * torch.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), _F_SP * m)


def hz_to_mel(freq, htk=False):
    """Hz -> mel: htk 2595 log10(1 + f / 700), else Slaney's (linear
    below 1 kHz, logarithmic above)."""
    f, scalar = _f32(freq)
    mel = _hz_to_mel(f, htk)
    return float(mel) if scalar else Tensor._wrap(mel)


def mel_to_hz(mel, htk=False):
    m, scalar = _f32(mel)
    f = _mel_to_hz(m, htk)
    return float(f) if scalar else Tensor._wrap(f)


def _mel_frequencies(n_mels, f_min, f_max, htk):
    lo = float(_hz_to_mel(torch.tensor(float(f_min)), htk))
    hi = float(_hz_to_mel(torch.tensor(float(f_max)), htk))
    return _mel_to_hz(torch.linspace(lo, hi, n_mels, dtype=torch.float32),
                      htk)


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32", *, device=None):
    return _out(_mel_frequencies(n_mels, f_min, f_max, htk), dtype, device)


def _fft_frequencies(sr, n_fft):
    return torch.linspace(0.0, sr / 2.0, 1 + n_fft // 2,
                          dtype=torch.float32)


def fft_frequencies(sr, n_fft, dtype="float32", *, device=None):
    return _out(_fft_frequencies(sr, n_fft), dtype, device)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32", *,
                         device=None):
    """[n_mels, 1 + n_fft // 2] triangular mel filterbank (Slaney's area
    normalization when `norm` is "slaney")."""
    if f_max is None:
        f_max = sr / 2.0
    fftfreqs = _fft_frequencies(sr, n_fft)
    melfreqs = _mel_frequencies(n_mels + 2, f_min, f_max, htk)
    fdiff = torch.diff(melfreqs)
    ramps = melfreqs[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / torch.clamp(fdiff[:-1, None], min=1e-10)
    upper = ramps[2:] / torch.clamp(fdiff[1:, None], min=1e-10)
    fb = torch.clamp(torch.minimum(lower, upper), min=0.0)
    if norm == "slaney":
        enorm = 2.0 / (melfreqs[2:n_mels + 2] - melfreqs[:n_mels])
        fb = fb * enorm[:, None]
    return _out(fb, dtype, device)


def _power_to_db(s, ref_value, amin, top_db):
    if amin <= 0:
        raise ValueError("amin must be strictly positive")
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        # against the largest value of the whole input, not per clip
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10 log10(S / ref) with S clamped at amin and, with top_db, the
    result at most top_db below its largest value."""
    s = _unwrap(spect)
    if not isinstance(s, torch.Tensor):
        s = torch.as_tensor(np.asarray(s))
    return Tensor._wrap(_power_to_db(s, ref_value, amin, top_db))


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32", *,
               device=None):
    """[n_mels, n_mfcc] DCT-II basis."""
    n = torch.arange(n_mels, dtype=torch.float32)
    k = torch.arange(n_mfcc, dtype=torch.float32)
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm is None:
        dct = dct * 2.0
    else:
        if norm != "ortho":
            raise ValueError("norm must be None or 'ortho'")
        ortho = torch.full((n_mfcc,), math.sqrt(2.0 / n_mels))
        ortho[0] = math.sqrt(1.0 / n_mels)
        dct = dct * ortho[None, :]
    return _out(dct, dtype, device)


def _window_np(window, win_length, fftbins):
    """The window in numpy float64 (the reference's formulas)."""
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, []
    n = win_length + 1 if fftbins else win_length
    x = np.arange(n, dtype=np.float64)

    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * x / (n - 1))
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * x / (n - 1))
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * x / (n - 1))
             + 0.08 * np.cos(4 * np.pi * x / (n - 1)))
    elif name == "bartlett":
        w = 1.0 - np.abs(2 * x / (n - 1) - 1.0)
    elif name in ("rect", "boxcar", "ones"):
        w = np.ones_like(x)
    elif name == "triang":
        m = (n + 1) // 2
        if n % 2 == 0:
            ramp = (2 * np.arange(1, m + 1) - 1) / n
            w = np.concatenate([ramp, ramp[::-1]])
        else:
            ramp = 2 * np.arange(1, m + 1) / (n + 1)
            w = np.concatenate([ramp, ramp[-2::-1]])
    elif name == "gaussian":
        std = args[0] if args else 7.0
        w = np.exp(-0.5 * ((x - (n - 1) / 2.0) / std) ** 2)
    elif name == "exponential":
        center = args[0] if len(args) > 0 and args[0] is not None \
            else (n - 1) / 2
        tau = args[1] if len(args) > 1 else 1.0
        w = np.exp(-np.abs(x - center) / tau)
    elif name == "taylor":
        nbar, sll = (args + [4, 30])[:2] if args else (4, 30)
        B = 10 ** (sll / 20)
        A = np.arccosh(B) / np.pi
        s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
        ma = np.arange(1, nbar)
        Fm = np.empty(nbar - 1)
        signs = np.empty_like(ma)
        signs[::2] = 1
        signs[1::2] = -1
        m2 = ma ** 2
        for mi, _ in enumerate(ma):
            numer = signs[mi] * np.prod(
                1 - m2[mi] / s2 / (A ** 2 + (ma - 0.5) ** 2))
            denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
                1 - m2[mi] / m2[mi + 1:])
            Fm[mi] = numer / denom
        w = np.ones(n)
        for mi, m in enumerate(ma):
            w = w + 2 * Fm[mi] * np.cos(
                2 * np.pi * m * (x - n / 2 + 0.5) / n)
        w = w / w.max()
    elif name == "kaiser":
        beta = args[0] if args else 12.0
        w = np.i0(beta * np.sqrt(1 - (2 * x / (n - 1) - 1) ** 2)) / np.i0(beta)
    elif name == "tukey":
        alpha = args[0] if args else 0.5
        w = np.ones(n)
        if alpha > 0:
            width = int(np.floor(alpha * (n - 1) / 2.0))
            left = x[:width + 1]
            w[:width + 1] = 0.5 * (1 + np.cos(np.pi * (
                -1 + 2.0 * left / alpha / (n - 1))))
            w[-(width + 1):] = w[:width + 1][::-1]
    elif name == "cosine":
        w = np.sin(np.pi / n * (x + 0.5))
    else:
        raise ValueError(f"unsupported window {name!r}")
    return w[:-1] if fftbins else w


def get_window(window, win_length, fftbins=True, dtype="float32", *,
               device=None):
    """A window by name (or a (name, *args) tuple), periodic when
    `fftbins`, computed in float64 and rounded to float32 as the
    reference rounds it."""
    w = _window_np(window, win_length, fftbins).astype(np.float32)
    return _out(torch.from_numpy(w), dtype, device)
