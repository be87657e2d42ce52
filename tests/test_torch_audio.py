"""paddle_tpu_torch.audio against paddle_tpu.audio on the CPU: the
windows bit for bit (both compute them in numpy float64 and round to
float32), the mel / DCT matrices and the feature layers within 1e-5 of
the largest value (f32 formulas evaluated by XLA and by torch, a few ulps
apart, then a product over 513 bins), power_to_db's top_db clamp over the
whole input, the features recording no gradient on either side, and the
synthetic ESC50 / TESS clips bit for bit."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

JA, TA = pt.audio, ptt.audio
WINDOWS = ["hann", "hamming", "blackman", "bartlett", "rect", "triang",
           ("gaussian", 3.0), ("exponential", None, 2.0), "taylor",
           ("kaiser", 8.0), ("tukey", 0.3), "cosine"]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n", [16, 25])
def test_windows_bit_equal(window, n):
    for fftbins in (True, False):
        got = TA.functional.get_window(window, n, fftbins=fftbins).numpy()
        want = JA.functional.get_window(window, n, fftbins=fftbins).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_and_matrices(htk):
    F, J = TA.functional, JA.functional
    for f in (0.0, 440.0, 1000.0, 8000.0):
        np.testing.assert_allclose(F.hz_to_mel(f, htk), J.hz_to_mel(f, htk),
                                   rtol=1e-6)
        m = J.hz_to_mel(f, htk)
        np.testing.assert_allclose(F.mel_to_hz(m, htk), J.mel_to_hz(m, htk),
                                   rtol=1e-6)
    hz = np.linspace(0, 16000, 33).astype(np.float32)
    _close(F.hz_to_mel(ptt.to_tensor(hz), htk).numpy(),
           J.hz_to_mel(pt.to_tensor(hz), htk).numpy())
    _close(F.mel_frequencies(40, 50.0, 14000.0, htk).numpy(),
           J.mel_frequencies(40, 50.0, 14000.0, htk).numpy())
    _close(F.fft_frequencies(32000, 1024).numpy(),
           J.fft_frequencies(32000, 1024).numpy())
    for norm in ("slaney", None):
        _close(F.compute_fbank_matrix(32000, 1024, 64, 50.0, 14000.0, htk,
                                      norm).numpy(),
               J.compute_fbank_matrix(32000, 1024, 64, 50.0, 14000.0, htk,
                                      norm).numpy())


def test_dct_and_power_to_db():
    F, J = TA.functional, JA.functional
    for norm in ("ortho", None):
        _close(F.create_dct(13, 40, norm).numpy(),
               J.create_dct(13, 40, norm).numpy())
    rng = np.random.default_rng(0)
    # two clips a thousand times apart: top_db clamps against the max of
    # the whole input, so the quiet clip is clamped flat
    s = np.abs(rng.standard_normal((2, 8, 9))).astype(np.float32)
    s[1] *= 1e-9
    for kw in (dict(top_db=80.0), dict(top_db=None),
               dict(ref_value=2.0, amin=1e-5, top_db=30.0)):
        got = F.power_to_db(ptt.to_tensor(s), **kw).numpy()
        _close(got, J.power_to_db(pt.to_tensor(s), **kw).numpy())
    got = F.power_to_db(ptt.to_tensor(s), top_db=80.0).numpy()
    assert np.all(got[1] == got.max() - 80.0)


def _twin(name, **kw):
    return getattr(TA, name)(**kw), getattr(JA, name)(**kw)


FEATURES = [
    ("Spectrogram", dict(n_fft=256, hop_length=64)),
    ("Spectrogram", dict(n_fft=256, win_length=200, window="hamming",
                         power=1.0, pad_mode="constant")),
    ("MelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32,
                               top_db=80.0)),
    ("LogMelSpectrogram", dict(sr=32000, n_fft=512, hop_length=160,
                               n_mels=64, f_min=50.0, f_max=14000.0,
                               htk=True)),
    ("MFCC", dict(sr=16000, n_mfcc=20, n_fft=256, n_mels=32)),
]


@pytest.mark.parametrize("name,kw", FEATURES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FEATURES)])
def test_feature_layers_match_reference(name, kw):
    ours, ref = _twin(name, **kw)
    bufs = dict(ours.named_buffers())
    want_bufs = dict(ref.named_buffers())
    assert sorted(bufs) == sorted(want_bufs)
    for k in bufs:
        _close(bufs[k].numpy(), want_bufs[k].numpy())
    x = np.random.default_rng(1).standard_normal((3, 2000)).astype(
        np.float32)
    got = ours(ptt.to_tensor(x)).numpy()
    want = ref(pt.to_tensor(x)).numpy()
    # dB and MFCC values are logs: held by absolute difference (1e-3 dB
    # against values of tens of dB); powers by the largest value
    rel = 2e-5 if name in ("LogMelSpectrogram", "MFCC") else 1e-5
    _close(got, want, rel)


def test_features_record_no_gradient_on_either_side():
    """The reference's layers compute on the input's array and wrap the
    result: no gradient reaches the input (Paddle's own do; ROADMAP
    Queue C, known gaps). The port follows it."""
    x = np.random.default_rng(2).standard_normal((2, 2048)).astype(
        np.float32)
    jx = pt.to_tensor(x, stop_gradient=False)
    JA.Spectrogram(n_fft=512)(jx).sum().backward()
    assert jx.grad is None
    tx = ptt.to_tensor(x, stop_gradient=False)
    out = TA.MFCC(sr=16000, n_fft=512)(tx)
    assert out.stop_gradient and not out._data.requires_grad
    s = TA.Spectrogram(n_fft=512)(tx)
    assert s.stop_gradient
    # the functional stft itself differentiates (signal_stft's case)
    ptt.signal.stft(tx, 512).abs().sum().backward()
    assert tx.grad is not None


def _clips(ds):
    from paddle_tpu.audio.datasets import _load_wav
    return [(_load_wav(f)[0], lab) for f, lab in zip(ds.files, ds.labels)]


@pytest.mark.parametrize("cls,mode", [("ESC50", "train"), ("ESC50", "dev"),
                                      ("TESS", "train")])
def test_synthetic_clips_bit_equal(cls, mode):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ours = getattr(TA.datasets, cls)(mode=mode)
        ref = getattr(JA.datasets, cls)(mode=mode)
    assert len(ours) == len(ref) > 0
    assert ours.labels == ref.labels
    for i in range(len(ours)):
        (x, lab), (y, want_lab) = ours[i], ref[i]
        assert lab == want_lab and x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_synthetic_fallback_warns_or_raises_and_features():
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        ds = TA.datasets.ESC50(mode="dev", feat_type="mfcc", n_mfcc=13)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = JA.datasets.ESC50(mode="dev", feat_type="mfcc", n_mfcc=13)
    got, want = ds[0][0], ref[0][0]
    assert got.shape == want.shape == (13, 18)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    with pytest.raises(FileNotFoundError, match="allow_synthetic=False"):
        TA.datasets.TESS(allow_synthetic=False)


def test_load_wav_pcm16_stereo(tmp_path):
    import wave
    from paddle_tpu.audio.datasets import _load_wav as jload
    from paddle_tpu_torch.audio.datasets import _load_wav as tload
    pcm = (np.random.default_rng(3).standard_normal(200) * 9000).astype(
        np.int16)
    path = str(tmp_path / "s.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.tobytes())
    (x, sr), (y, sr2) = tload(path), jload(path)
    assert sr == sr2 == 8000 and x.shape == (100,)
    np.testing.assert_array_equal(x, y)


def test_buffers_on_the_requested_device():
    m = TA.LogMelSpectrogram(sr=16000, n_fft=256, device="cpu")
    assert {b.device.type for b in torch.nn.Module.buffers(m)} == {"cpu"}
    assert TA.functional.get_window("hann", 8, device="cpu").place \
        .is_cpu_place()
