"""ctypes bindings for the native data-loader core (queue.cc), the
counterpart of paddle_tpu/io/native/__init__.py.

The library is built at first use with g++ through
``utils/build.py::build_shared`` into ``build/paddle_tpu_torch/`` (as
the paged cache's block allocator is), never into the package
directory. A failed build raises: the reference returns None here and
its DataLoader falls back to the buffered thread (paddle_tpu/io/
__init__.py:652-656); the port has no silent fallback (ROADMAP Queue
C, deliberate departures)."""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

__all__ = ["NativeQueue", "collate_stack", "available", "load",
           "NATIVE_COLLATE_MIN_BYTES"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "queue.cc")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lib = None
_lock = threading.Lock()


NATIVE_COLLATE_MIN_BYTES = 1 << 16  # below this np.stack wins


def load():
    """The shared library, built at first use; raises RuntimeError when
    the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ...utils.build import build_shared
        lib = ctypes.CDLL(build_shared("ptio", [_SRC], "g++", _FLAGS))
        lib.ptq_create.restype = ctypes.c_void_p
        lib.ptq_create.argtypes = [ctypes.c_uint64]
        lib.ptq_destroy.restype = None
        lib.ptq_destroy.argtypes = [ctypes.c_void_p]
        lib.ptq_push.restype = ctypes.c_int
        lib.ptq_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
        lib.ptq_pop.restype = ctypes.c_int
        lib.ptq_pop.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.c_int64]
        lib.ptq_size.restype = ctypes.c_uint64
        lib.ptq_size.argtypes = [ctypes.c_void_p]
        lib.ptq_close.restype = None
        lib.ptq_close.argtypes = [ctypes.c_void_p]
        lib.ptq_collate.restype = None
        lib.ptq_collate.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    """True once the library is built and loaded (``load()`` raises
    when the build fails)."""
    return load() is not None


class NativeQueue:
    """Blocking bounded queue over the C++ core. Items are arbitrary
    Python objects (a registry keeps them alive; the queue transports
    opaque handles). Push/pop release the GIL while blocked, so Python
    producer threads and the consumer genuinely overlap."""

    def __init__(self, capacity: int):
        lib = load()
        self._lib = lib
        self._q = lib.ptq_create(capacity)
        self._items = {}
        self._next = 1
        self._reg_lock = threading.Lock()

    def push(self, obj, timeout_ms: int = -1) -> bool:
        with self._reg_lock:
            handle = self._next
            self._next += 1
            self._items[handle] = obj
        rc = self._lib.ptq_push(self._q, ctypes.c_void_p(handle),
                                timeout_ms)
        if rc != 1:
            with self._reg_lock:
                self._items.pop(handle, None)
        if rc == -1:
            raise RuntimeError("queue closed")
        return rc == 1

    def pop(self, timeout_ms: int = -1):
        out = ctypes.c_void_p()
        rc = self._lib.ptq_pop(self._q, ctypes.byref(out), timeout_ms)
        if rc == 0:
            raise TimeoutError("queue pop timed out")
        if rc == -1:
            raise StopIteration
        with self._reg_lock:
            return self._items.pop(out.value)

    def qsize(self) -> int:
        return int(self._lib.ptq_size(self._q))

    def close(self):
        self._lib.ptq_close(self._q)

    def __del__(self):
        q = getattr(self, "_q", None)
        if q:
            self._lib.ptq_close(q)
            self._lib.ptq_destroy(q)
            self._q = None


def collate_stack(arrays, threads: int = 4) -> np.ndarray:
    """np.stack through the parallel native memcpy. Small samples,
    object dtypes (a raw memcpy would copy PyObject pointers without a
    reference) and samples of differing shape or dtype take np.stack,
    which stacks or raises as it always does."""
    first = np.ascontiguousarray(arrays[0])
    if first.nbytes < NATIVE_COLLATE_MIN_BYTES or first.dtype.hasobject:
        return np.stack(arrays)
    srcs = [np.ascontiguousarray(a) for a in arrays]
    for a in srcs[1:]:
        if a.shape != first.shape or a.dtype != first.dtype:
            return np.stack(arrays)
    lib = load()
    n = len(arrays)
    out = np.empty((n,) + first.shape, first.dtype)
    src_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in srcs])
    sizes = (ctypes.c_uint64 * n)(*[a.nbytes for a in srcs])
    lib.ptq_collate(ctypes.c_void_p(out.ctypes.data), src_ptrs,
                    sizes, n, threads)
    return out
