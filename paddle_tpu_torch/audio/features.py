"""Audio feature layers (counterpart of paddle_tpu/audio/features.py):
STFT -> |.|^power -> mel filterbank -> dB -> DCT, with the window, the
filterbank and the DCT basis made at construction as buffers (on
`device`: None is the eager default place, the card unless
``set_device("cpu")``).

As in the reference, whose layers compute on the input's array and wrap
the result, the features record no gradient: their output has
``stop_gradient`` True and nothing flows back into the input (Paddle's
own layers differentiate; ROADMAP Queue C lists this). A Tensor input
gives a Tensor, a torch tensor a torch tensor."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..nn.layer import Layer
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


def _raw(x):
    return (x._data if isinstance(x, Tensor) else x).detach()


def _like(x, out):
    return Tensor._wrap(out, stop_gradient=True) if isinstance(x, Tensor) \
        else out


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True,
                 pad_mode="reflect", dtype="float32", *, device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer(
            "fft_window", AF.get_window(window, self.win_length,
                                        fftbins=True, dtype=dtype,
                                        device=device))

    def _spec(self, x):
        from ..signal import stft
        with torch.no_grad():
            spec = stft(x, self.n_fft, hop_length=self.hop_length,
                        win_length=self.win_length,
                        window=self._buffers["fft_window"],
                        center=self.center, pad_mode=self.pad_mode)
            mag = spec.abs()
            return mag ** self.power if self.power != 1.0 else mag

    def forward(self, x):
        return _like(x, self._spec(_raw(x)))


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", dtype="float32", *, device=None):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        dtype, device=device)
        self.n_mels = n_mels
        self.register_buffer(
            "fbank_matrix",
            AF.compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max, htk,
                                    norm, dtype, device=device))

    def _mel(self, x):
        spec = self._spectrogram._spec(x)          # [..., n_bins, frames]
        with torch.no_grad():
            return torch.matmul(self._buffers["fbank_matrix"], spec)

    def forward(self, x):
        return _like(x, self._mel(_raw(x)))


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32", *, device=None):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype, device=device)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def _logmel(self, x):
        mel = self._melspectrogram._mel(x)
        with torch.no_grad():
            return AF._power_to_db(mel, self.ref_value, self.amin,
                                   self.top_db)

    def forward(self, x):
        return _like(x, self._logmel(_raw(x)))


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32", *, device=None):
        super().__init__()
        assert n_mfcc <= n_mels, "n_mfcc cannot be larger than n_mels"
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype, device=device)
        self.register_buffer("dct_matrix",
                             AF.create_dct(n_mfcc, n_mels, dtype=dtype,
                                           device=device))

    def forward(self, x):
        logmel = self._log_melspectrogram._logmel(_raw(x))
        with torch.no_grad():
            # [n_mels, n_mfcc]^T @ [..., n_mels, frames]
            out = torch.matmul(self._buffers["dct_matrix"].t(), logmel)
        return _like(x, out)
