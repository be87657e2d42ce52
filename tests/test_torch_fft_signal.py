"""paddle_tpu_torch.fft and .signal against paddle_tpu's on the CPU.

Every registered ``fft_*`` and ``signal_*`` op runs as a case of
tests/eager_op_cases.py's ``OPSURF_CASES`` on both packages from the
same numpy inputs, held by tests/test_torch_ops.py's rule: values within
the case's tolerance (rtol = atol = 1e-5 for the transforms: pocketfft
in XLA and in torch sum in other orders, a few f32 ulps of the largest
bin apart), dtypes and shapes exactly, and the inputs' gradients through
``backward()`` (the STFT's, through ``abs``) within 1e-4."""
import numpy as np
import pytest
import torch

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import check_case
from torch_port_helpers import cpu_place

CASES = [c for c in C.CASES if c[0] in set(C.OPSURF_CASES)
         and c[0].startswith(("fft_", "signal_"))]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("name,fn,opts", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(name, fn, opts):
    check_case(name, fn, opts)


def test_registered_under_the_reference_names():
    from paddle_tpu.ops.registry import OPS as JOPS
    from paddle_tpu_torch.ops import OPS
    want = {n for n in JOPS if n.startswith(("fft_", "signal_"))}
    assert len(want) == 26
    assert want <= set(OPS)
    names = {n.removeprefix("fft_") for n in want if n.startswith("fft_")}
    assert names == set(ptt.fft.__all__)


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_hermitian_composites_agree_with_torch(norm):
    """The reference's hfftn / ihfftn composites compute torch's own
    hfftn / ihfftn (so the port holds them to the reference and torch
    agrees)."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy((rng.standard_normal((3, 4, 5)) + 1j
                          * rng.standard_normal((3, 4, 5))).astype(
                              np.complex64))
    x = torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(np.float32))
    for ours, theirs, a in ((ptt.fft.hfftn, torch.fft.hfftn, z),
                            (ptt.fft.hfft2, torch.fft.hfft2, z),
                            (ptt.fft.ihfftn, torch.fft.ihfftn, x),
                            (ptt.fft.ihfft2, torch.fft.ihfft2, x)):
        got = ours(a, norm=norm)
        want = theirs(a, norm=norm).resolve_conj()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bad_norm_and_pad_mode_raise():
    x = ptt.to_tensor(np.ones((2, 64), np.float32))
    with pytest.raises(ValueError, match="norm must be one of"):
        ptt.fft.fft(x, norm="unit")
    # jnp.pad takes every numpy mode; the port takes the two Paddle
    # documents
    assert pt.signal.stft(pt.to_tensor(np.ones((2, 64), np.float32)), 16,
                          pad_mode="edge").shape == [2, 9, 17]
    with pytest.raises(NotImplementedError, match="pad_mode"):
        ptt.signal.stft(x, 16, pad_mode="edge")


def test_overlap_add_adds_duplicate_indices():
    """hop < frame_length: each sample is the sum of every frame that
    covers it (an index_add, not an indexed assignment)."""
    frames = np.ones((4, 5), np.float32)       # [frame_length, n]
    got = ptt.signal.overlap_add(ptt.to_tensor(frames), 1).numpy()
    np.testing.assert_array_equal(got, [1, 2, 3, 4, 4, 3, 2, 1])
    want = pt.signal.overlap_add(pt.to_tensor(frames), 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_stft_istft_round_trip_and_frame_is_a_view():
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((3, 1000)).astype(np.float32)
    w = ptt.audio.functional.get_window("hann", 256)
    spec = ptt.signal.stft(ptt.to_tensor(sig), 256, 64, window=w)
    back = ptt.signal.istft(spec, 256, 64, window=w, length=1000)
    np.testing.assert_allclose(back.numpy(), sig, atol=2e-6)
    t = torch.from_numpy(sig)
    assert ptt.signal.frame(t, 64, 16).data_ptr() == t.data_ptr()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_precision_real_transforms(dtype):
    """The reference's real-input transforms (rfft, ihfft and their 2-D /
    N-D forms) raise on a half-precision input (XLA's RFFT takes float32
    and float64 only); the port casts it up as the complex transforms
    are cast up on both sides (ROADMAP Queue C, known gaps)."""
    x = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="RFFT input must be float32"):
        pt.fft.rfft(pt.to_tensor(x).astype(dtype))
    got = ptt.fft.rfft(ptt.to_tensor(x).astype(dtype))
    want = pt.fft.rfft(pt.to_tensor(
        ptt.to_tensor(x).astype(dtype).astype("float32").numpy()))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
