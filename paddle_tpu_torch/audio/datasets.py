"""Audio dataset zoo (counterpart of paddle_tpu/audio/datasets.py):
ESC-50 and TESS over locally staged wav directories, read by the stdlib
``wave`` module (PCM16). Without the files they make deterministic
synthetic clips (``np.random.RandomState(0)``, the reference's
generator and order, so the clips are bit-equal to the reference's)
with a loud warning, or raise with ``allow_synthetic=False``. Feature
types other than "raw" run the port's feature layers on the eager
default place."""
from __future__ import annotations

import os
import wave
import warnings

import numpy as np

from ..io import Dataset

__all__ = ["AudioClassificationDataset", "ESC50", "TESS"]


def _synthetic_fallback(name, reason, allow):
    msg = (f"{name}: {reason} — falling back to DETERMINISTIC SYNTHETIC "
           f"audio clips. This is NOT the real dataset; stage the "
           f"documented archive locally (no downloads), or pass "
           f"allow_synthetic=False to make this an error.")
    if not allow:
        raise FileNotFoundError(f"{name}: {reason} (allow_synthetic=False)")
    warnings.warn(msg, UserWarning, stacklevel=3)


def _load_wav(path):
    """PCM16 wav -> (float32 [-1, 1] mono array, sample rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width != 2:
        raise ValueError(f"{path}: only PCM16 wavs supported "
                         f"(sample width {width})")
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


class AudioClassificationDataset(Dataset):
    """wav files and integer labels, optionally turned into features
    ('raw' | 'mfcc' | 'logmelspectrogram' | 'melspectrogram' |
    'spectrogram')."""

    _FEATS = ("raw", "mfcc", "logmelspectrogram", "melspectrogram",
              "spectrogram")

    def __init__(self, files=None, labels=None, feat_type="raw",
                 sample_rate=None, **feat_kwargs):
        if feat_type not in self._FEATS:
            raise ValueError(
                f"feat_type must be one of {self._FEATS}; got {feat_type}")
        self.files = list(files or [])
        self.labels = list(labels or [])
        self.feat_type = feat_type
        self.feat_kwargs = feat_kwargs
        self.sample_rate = sample_rate
        self._extractor = None

    def _features(self, x, sr):
        if self.feat_type == "raw":
            return x
        if self._extractor is None:
            from . import features as F
            cls = {"mfcc": F.MFCC,
                   "logmelspectrogram": F.LogMelSpectrogram,
                   "melspectrogram": F.MelSpectrogram,
                   "spectrogram": F.Spectrogram}[self.feat_type]
            self._extractor = cls(sr=sr, **self.feat_kwargs) \
                if self.feat_type != "spectrogram" else cls(
                    **self.feat_kwargs)
        from ..core.tensor import to_tensor
        out = self._extractor(to_tensor(x[None]))
        return np.asarray(out.numpy()[0])

    def __getitem__(self, idx):
        x, sr = _load_wav(self.files[idx])
        if self.sample_rate and sr != self.sample_rate:
            raise ValueError(
                f"{self.files[idx]}: sample rate {sr} != expected "
                f"{self.sample_rate} (resampling is out of scope)")
        return self._features(x, sr), int(self.labels[idx])

    def __len__(self):
        return len(self.files)


class ESC50(AudioClassificationDataset):
    """ESC-50 environmental sounds (archive ESC-50-master.zip, md5
    7771e4b9d86d0945acce719c7a59305a). File names encode the target:
    {fold}-{clip_id}-{take}-{target}.wav; mode 'train' keeps the folds
    other than `split`, 'dev' the fold `split` (5-fold protocol)."""

    def __init__(self, audio_dir=None, mode="train", split=1,
                 feat_type="raw", allow_synthetic=True, **feat_kwargs):
        files, labels = [], []
        if audio_dir and os.path.isdir(audio_dir):
            for fname in sorted(os.listdir(audio_dir)):
                if not fname.endswith(".wav"):
                    continue
                parts = fname[:-4].split("-")
                fold, target = int(parts[0]), int(parts[3])
                if (mode == "train") == (fold != split):
                    files.append(os.path.join(audio_dir, fname))
                    labels.append(target)
        if not files:
            _synthetic_fallback(
                "ESC50", "no local ESC-50 audio directory"
                if not audio_dir else f"{audio_dir!r} has no wav files",
                allow_synthetic)
            self._synth(16 if mode == "train" else 4, 50, 2205)
            super().__init__(self.files, self.labels, feat_type,
                             **feat_kwargs)
            return
        super().__init__(files, labels, feat_type, **feat_kwargs)

    def _synth(self, n, num_classes, clip_len):
        import tempfile
        rng = np.random.RandomState(0)
        d = tempfile.mkdtemp(prefix="esc50_synth_")
        self.files, self.labels = [], []
        for i in range(n):
            path = os.path.join(d, f"{i}.wav")
            pcm = (rng.standard_normal(clip_len) * 3000).astype(np.int16)
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(22050)
                w.writeframes(pcm.tobytes())
            self.files.append(path)
            self.labels.append(int(rng.randint(0, num_classes)))


class TESS(AudioClassificationDataset):
    """TESS emotional speech (archive TESS_Toronto_emotional_speech_set
    .zip, md5 1465311b24d1de704c4c63e4ccc470c7). Labels come from the
    trailing emotion token of each wav name (OAF_back_angry.wav ->
    angry); an n_folds split as in the reference."""

    EMOTIONS = ("angry", "disgust", "fear", "happy", "neutral", "ps",
                "sad")

    def __init__(self, audio_dir=None, mode="train", n_folds=5, split=1,
                 feat_type="raw", allow_synthetic=True, **feat_kwargs):
        files, labels = [], []
        if audio_dir and os.path.isdir(audio_dir):
            wavs = []
            for root, _, names in os.walk(audio_dir):
                wavs += [os.path.join(root, n) for n in names
                         if n.lower().endswith(".wav")]
            for i, path in enumerate(sorted(wavs)):
                emo = os.path.basename(path)[:-4].split("_")[-1].lower()
                if emo not in self.EMOTIONS:
                    continue
                fold = i % n_folds + 1
                if (mode == "train") == (fold != split):
                    files.append(path)
                    labels.append(self.EMOTIONS.index(emo))
        if not files:
            _synthetic_fallback(
                "TESS", "no local TESS audio directory"
                if not audio_dir else f"{audio_dir!r} has no wav files",
                allow_synthetic)
            ESC50._synth(self, 14 if mode == "train" else 7,
                         len(self.EMOTIONS), 2205)
            super().__init__(self.files, self.labels, feat_type,
                             **feat_kwargs)
            return
        super().__init__(files, labels, feat_type, **feat_kwargs)
