"""Custom C++ host ops (counterpart of paddle_tpu/utils/cpp_extension.py,
paddle.utils.cpp_extension parity).

`load` compiles the sources with g++ at first use into the build
directory (``build/paddle_tpu_torch/`` in the checkout, listed in
.gitignore, as the data loader's native queue is built: through
`utils.build.build_shared`, named by a hash of the sources and flags)
and finds their ops. The C ABI is the reference's v1 (:14-26)::

    extern "C" void <op_name>(
        const void* const* inputs,     // n_inputs data pointers
        const long long*  sizes,       // n_inputs element counts
        int               n_inputs,
        void*             output,      // preallocated
        long long         out_elems);

The dtype is carried in Python (the inputs and the output share the
first input's dtype unless `out_dtype` says otherwise). An op is a HOST
op, as the reference's ``jax.pure_callback`` is: a CUDA tensor's data is
copied to the host, the op runs there, and its result is copied back to
the first input's device, openly, in the call. Ops are opaque to
autograd; wrap one in `autograd.PyLayer` for a custom backward.

Device kernels are not built here: `CUDAExtension` raises, as the
reference's does (:175). The port's own CUDA kernels are built by
`utils/build.py` (`load_cuda`: nvcc, sm_90a, a plain C interface bound
through ctypes).
"""
from __future__ import annotations

import ctypes
import os
import re

import numpy as np
import torch

from ..core.tensor import Tensor
from .build import build_dir, build_shared

__all__ = ["load", "CppExtension", "CUDAExtension", "get_build_directory"]

_CUDA_HINT = ("device kernels are built by paddle_tpu_torch.utils.build "
              "(load_cuda: nvcc for sm_90a, a plain C interface bound "
              "through ctypes), as the port's own kernels under "
              "kernels/csrc are; host ops use CppExtension / load")


def get_build_directory():
    """Where `load` builds: ``$PT_EXTENSION_DIR``, else the checkout's
    build directory."""
    d = os.environ.get("PT_EXTENSION_DIR") or str(build_dir())
    os.makedirs(d, exist_ok=True)
    return d


class CustomOpModule:
    """Holds the loaded library; attribute access returns its ops."""

    def __init__(self, name, lib_path, op_names):
        self._name = name
        self._lib = ctypes.CDLL(lib_path)
        self._ops = {op: self._make_op(op) for op in op_names}

    def _make_op(self, op_name):
        cfn = getattr(self._lib, op_name)
        cfn.restype = None
        cfn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                        ctypes.POINTER(ctypes.c_longlong),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]

        def op(*tensors, out_shape=None, out_dtype=None):
            datas = [t._data if isinstance(t, Tensor) else torch.as_tensor(t)
                     for t in tensors]
            device = datas[0].device
            # the host copies (of a CUDA tensor: the op is a host op)
            arrays = [np.ascontiguousarray(d.detach().cpu().numpy())
                      for d in datas]
            shape = (tuple(out_shape) if out_shape is not None
                     else arrays[0].shape)
            dtype = np.dtype(out_dtype) if out_dtype is not None \
                else arrays[0].dtype
            out = np.empty(shape, dtype)
            ptrs = (ctypes.c_void_p * len(arrays))(
                *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
            sizes = (ctypes.c_longlong * len(arrays))(
                *[a.size for a in arrays])
            cfn(ptrs, sizes, len(arrays),
                out.ctypes.data_as(ctypes.c_void_p), out.size)
            return Tensor._wrap(torch.from_numpy(out).to(device),
                                stop_gradient=True)

        op.__name__ = op_name
        return op

    def __getattr__(self, item):
        ops = object.__getattribute__(self, "_ops")
        if item in ops:
            return ops[item]
        raise AttributeError(
            f"custom-op module {self._name!r} has no op {item!r}; "
            f"loaded ops: {sorted(ops)}")


def _discover_ops(sources):
    """Exported op names: every function declared with
    PT_EXPORT_OP(<name>) or as extern "C" void <name>(."""
    names = []
    pat = re.compile(
        r'(?:PT_EXPORT_OP\s*\(\s*(\w+)\s*\))|'
        r'(?:extern\s+"C"\s+void\s+(\w+)\s*\()')
    for s in sources:
        with open(s) as f:
            for m in pat.finditer(f.read()):
                names.append(m.group(1) or m.group(2))
    return list(dict.fromkeys(names))


def load(name, sources, extra_cflags=None, extra_cuda_cflags=None,
         extra_ldflags=None, extra_include_paths=None,
         build_directory=None, verbose=False):
    """Compile C++ sources with g++ and expose their ops (ref API:
    python/paddle/utils/cpp_extension/cpp_extension.py load)."""
    if extra_cuda_cflags:
        raise RuntimeError("cpp_extension.load builds host ops only: "
                           + _CUDA_HINT)
    cflags = ["-O3", "-shared", "-fPIC", "-std=c++17",
              *(extra_cflags or []),
              *(f"-I{inc}" for inc in extra_include_paths or [])]
    lib_path = build_shared(
        name, sources, "g++", cflags,
        out_dir=build_directory or get_build_directory(),
        libs=list(extra_ldflags or []))
    if verbose:
        print(f"cpp_extension: {name} -> {lib_path}")
    op_names = _discover_ops(sources)
    if not op_names:
        raise RuntimeError(
            f"no extern \"C\" v1-ABI ops found in {sources}; see "
            "paddle_tpu_torch.utils.cpp_extension's docstring for the "
            "contract")
    return CustomOpModule(name, lib_path, op_names)


class CppExtension:
    """setup()-style spec shim; `load` is the supported path."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


def CUDAExtension(*args, **kwargs):
    raise RuntimeError("CUDAExtension is not supported: " + _CUDA_HINT)
