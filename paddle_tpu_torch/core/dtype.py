"""Data types for the PyTorch port (counterpart of paddle_tpu/core/dtype.py).

The reference wraps numpy/jax dtypes in its own ``DType``; the port's
dtypes are torch's own, so ``DType`` is ``torch.dtype`` and every name
of the reference's surface (:54-67) is a torch dtype. ``to_dtype``
takes the reference's names ("float16", "bool", "float8_e4m3fn", ...),
numpy dtypes and torch dtypes; ``finfo`` and ``iinfo`` carry the
reference's fields (:105-140), with ``dtype`` its name. ``to_jnp`` is
JAX's own and is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DType", "bool_", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "float8_e4m3", "float8_e5m2", "to_dtype",
           "from_np", "iinfo", "finfo"]

DType = torch.dtype

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3 = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

# the reference's name of each type (its DType.name, the numpy name)
_NAMES = {
    bool_: "bool", uint8: "uint8", int8: "int8", int16: "int16",
    int32: "int32", int64: "int64", float16: "float16",
    bfloat16: "bfloat16", float32: "float32", float64: "float64",
    complex64: "complex64", complex128: "complex128",
    float8_e4m3: "float8_e4m3fn", float8_e5m2: "float8_e5m2",
}
_BY_NAME = {n: d for d, n in _NAMES.items()}
# numpy's and ml_dtypes' finfo resolution, 10^-precision, which the
# reference reads back after rounding it to the type
_RESOLUTION = {float16: 1e-3, bfloat16: 1e-2, float32: 1e-6,
               float64: 1e-15, float8_e4m3: 0.1, float8_e5m2: 0.1}


def to_dtype(x) -> torch.dtype:
    """Coerce a name (the reference's: 'float16', 'bool', 'float8_e4m3fn',
    ... or any numpy name), a numpy dtype or a torch dtype."""
    if isinstance(x, torch.dtype):
        return x
    if isinstance(x, str) and x in _BY_NAME:
        return _BY_NAME[x]
    try:
        return from_np(np.dtype(x))
    except TypeError:
        raise ValueError(f"unsupported dtype {x!r}; use one of "
                         f"{sorted(_BY_NAME)}") from None


def from_np(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (ml_dtypes' bfloat16 and float8
    types by their names; numpy's other integer types as torch has
    them)."""
    name = np.dtype(np_dtype).name
    d = _BY_NAME.get(name, getattr(torch, name, None))
    if not isinstance(d, torch.dtype):
        raise ValueError(f"unsupported dtype {name!r}")
    return d


def _name(d) -> str:
    return _NAMES.get(d, str(d).removeprefix("torch."))


class iinfo:
    """ref: python/paddle/framework/dtype.py iinfo — integer dtype
    numeric limits."""

    def __init__(self, dtype):
        d = to_dtype(dtype)
        info = torch.iinfo(d)
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = _name(d)

    def __repr__(self):
        return (f"iinfo(min={self.min}, max={self.max}, "
                f"bits={self.bits}, dtype={self.dtype})")


class finfo:
    """ref: framework/dtype.py finfo — floating dtype numeric limits
    (bfloat16 and the float8 types included)."""

    def __init__(self, dtype):
        d = to_dtype(dtype)
        info = torch.finfo(d)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        self.resolution = float(torch.tensor(_RESOLUTION[d],
                                             dtype=torch.float64).to(d))
        self.bits = int(info.bits)
        self.dtype = _name(d)

    def __repr__(self):
        return (f"finfo(min={self.min}, max={self.max}, eps={self.eps}, "
                f"bits={self.bits}, dtype={self.dtype})")
