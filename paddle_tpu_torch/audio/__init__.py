"""paddle.audio's surface (counterpart of paddle_tpu/audio): the
feature layers and functional ops over ``signal.stft`` and ``torch.fft``
(the filterbank and DCT applied as products), and the ESC-50 / TESS
datasets read from local wav files (PCM16, the stdlib ``wave``
module)."""
from . import datasets, features, functional  # noqa: F401
from .features import (LogMelSpectrogram, MelSpectrogram, MFCC,  # noqa: F401
                       Spectrogram)

__all__ = ["functional", "features", "datasets", "Spectrogram",
           "MelSpectrogram", "LogMelSpectrogram", "MFCC"]
