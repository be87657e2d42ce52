"""paddle_tpu_torch.core.dtype against paddle_tpu.core.dtype: every name
of the reference's surface as a torch dtype, to_dtype by name (f16,
bool and the float8 names included), from numpy dtypes, and finfo /
iinfo with the reference's fields, equal value for value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import dtype as jdt
from paddle_tpu_torch.core import dtype as tdt

# the reference's module attribute -> its DType's name
REF_NAMES = {a: getattr(jdt, a).name for a in (
    "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "float8_e4m3", "float8_e5m2")}
FLOATS = ["float16", "bfloat16", "float32", "float64", "float8_e4m3fn",
          "float8_e5m2"]
INTS = ["uint8", "int8", "int16", "int32", "int64"]


def _same_type(t: torch.dtype, ref) -> bool:
    """A torch dtype and a reference DType hold the same type: the same
    width and kind, and a value round-trips through both bit for bit."""
    probe = np.array([0.0, 1.0, 2.5, 3.0], np.float32)
    wide = np.complex128 if t.is_complex else np.float32
    want = np.asarray(jnp.asarray(probe).astype(ref.np_dtype)).astype(wide)
    got = torch.from_numpy(probe).to(t)
    got = (got.numpy() if t.is_complex else got.float().numpy()).astype(wide)
    return t.itemsize == ref.itemsize \
        and t.is_floating_point == ref.is_floating_point \
        and t.is_complex == ref.is_complex \
        and np.array_equal(got, want)


@pytest.mark.parametrize("attr", sorted(REF_NAMES))
def test_every_reference_name_is_the_same_torch_dtype(attr):
    t = getattr(tdt, attr)
    assert isinstance(t, torch.dtype) and isinstance(t, tdt.DType)
    assert _same_type(t, getattr(jdt, attr))
    # and by the reference's name
    assert tdt.to_dtype(REF_NAMES[attr]) is t
    assert tdt.to_dtype(t) is t


@pytest.mark.parametrize("name,want", [
    ("float16", torch.float16), ("float64", torch.float64),
    ("bool", torch.bool), ("bfloat16", torch.bfloat16),
    ("float8_e4m3fn", torch.float8_e4m3fn), ("int8", torch.int8)])
def test_to_dtype_by_name(name, want):
    assert tdt.to_dtype(name) is want
    assert _same_type(want, jdt.to_dtype(name))


def test_to_dtype_and_from_np_take_numpy_dtypes():
    for np_dt, want in ((np.float16, torch.float16),
                        (np.dtype("int32"), torch.int32),
                        (np.bool_, torch.bool), (float, torch.float64),
                        ("uint16", torch.uint16)):
        assert tdt.to_dtype(np_dt) is want
        assert tdt.from_np(np_dt) is want
        assert jdt.to_dtype(np_dt).name == tdt._name(want)
    import ml_dtypes
    assert tdt.from_np(ml_dtypes.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError, match="unsupported dtype"):
        tdt.to_dtype("float17")


@pytest.mark.parametrize("name", FLOATS)
def test_finfo_equals_the_reference(name):
    got, want = tdt.finfo(name), jdt.finfo(name)
    for f in ("min", "max", "eps", "tiny", "smallest_normal",
              "resolution", "bits", "dtype"):
        assert getattr(got, f) == getattr(want, f), f
    assert repr(got) == repr(want)
    assert vars(tdt.finfo(tdt.to_dtype(name))) == vars(got)


@pytest.mark.parametrize("name", INTS)
def test_iinfo_equals_the_reference(name):
    got, want = tdt.iinfo(name), jdt.iinfo(name)
    assert vars(got) == vars(want)
    assert repr(got) == repr(want)


def test_f16_names_reach_amp_and_the_optimizer():
    """The names the reference's f16 mode passes, which the port refused
    before: auto_cast(dtype="float16") and AdamW(moment_dtype="float16")
    build, and the moments are f16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    with amp.auto_cast(dtype="float16"):
        assert amp.amp_dtype() is torch.float16
    p = torch.zeros(4, requires_grad=True)
    opt = AdamW(parameters=[p], moment_dtype="float16")
    p.grad = torch.ones(4)
    opt.step()
    assert opt._accumulators[id(p)]["moment1"].dtype is torch.float16
