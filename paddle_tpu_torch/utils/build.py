"""Build native sources into shared libraries at first use.

Counterpart of paddle_tpu/utils/cpp_extension.py::_compile: the
paged-cache block allocator, the data loader's native queue and
`utils.cpp_extension`'s host ops (g++), and the hand-written CUDA
kernels (nvcc). Libraries land in ``build/paddle_tpu_torch/``
under the repository root, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads straight away.
Each build writes a private temporary file and renames it into place, so
processes that build the same library at once never load a torn file.

A build given a persistent store (``store=``: an object with
``fetch(name, tag)`` and ``keep(name, tag, blob, seconds)``, such as
`inference.exec_cache.LibraryStore`, which an `LLMEngine` given
``exec_cache_dir=`` passes when it loads its libraries) asks the store
first: the bytes it returns are written into the build directory and
used with no compiler run; when it returns None the library is
compiled, whatever the build directory holds, and handed to
``keep``. Builds without a store never look at one. `compiler_runs`
counts every compiler this process ran.
"""
from __future__ import annotations

import collections
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

__all__ = ["build_dir", "build_shared", "csrc_path", "load_cuda", "nvcc_path",
           "compiler_runs"]

# CUDA kernels are compiled for Hopper only: sm_90a keeps wgmma/setmaxnreg
# available to the kernels that will use them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


# compiler runs in this process, by the compiler's file name ("nvcc",
# "g++", ...)
compiler_runs: "collections.Counter[str]" = collections.Counter()


def _write_atomic(path: Path, blob: bytes) -> None:
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    tmp.write_bytes(blob)
    os.replace(tmp, path)


def build_dir() -> Path:
    """``<repo>/build/paddle_tpu_torch`` (listed in .gitignore)."""
    d = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
    d.mkdir(parents=True, exist_ok=True)
    return d


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH; raises if absent."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def build_shared(name: str, sources: Sequence[str], compiler: str,
                 flags: Sequence[str], headers: Sequence[str] = (),
                 out_dir=None, libs: Sequence[str] = (), store=None) -> str:
    """Compile ``sources`` with ``compiler`` and ``flags`` into
    ``<out_dir or build_dir()>/<name>_<hash>.so``; returns the library's
    path. ``headers`` are the files the sources include: hashed with
    them, so an edited header rebuilds every library that names it.
    ``libs`` (linker flags) follow the sources on the command line.
    ``store``: a persistent library store to ask first (module
    docstring)."""
    tag = hashlib.sha256()
    for s in (*sources, *headers):
        tag.update(Path(s).read_bytes())
    tag.update(" ".join([os.path.basename(compiler), *flags,
                         *libs]).encode())
    d = build_dir() if out_dir is None else Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    out = d / f"{name}_{tag.hexdigest()[:16]}.so"
    if store is None:
        if not out.exists():
            _compile(name, compiler, flags, sources, libs, out)
        return str(out)
    # with a store, the store decides: its bytes are the library, and a
    # miss is compiled whatever the build directory holds, so a store
    # that records a compile records a compiler run
    t0 = time.perf_counter()
    blob = store.fetch(name, tag.hexdigest())
    if blob is not None:
        if not out.exists() or out.read_bytes() != blob:
            _write_atomic(out, blob)
        return str(out)
    _compile(name, compiler, flags, sources, libs, out)
    store.keep(name, tag.hexdigest(), out.read_bytes(),
               time.perf_counter() - t0)
    return str(out)


def _compile(name, compiler, flags, sources, libs, out: Path) -> None:
    """Run the compiler into a private temporary file and rename it to
    `out`; raises with the compiler's output when it fails."""
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources), *libs]
    compiler_runs[os.path.basename(compiler)] += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def csrc_path(name: str) -> str:
    """``paddle_tpu_torch/kernels/csrc/<name>``."""
    return str(Path(__file__).resolve().parents[1] / "kernels" / "csrc" / name)


def load_cuda(name: str, headers: Sequence[str] = (),
              extra_flags: Sequence[str] = (), store=None):
    """``kernels/csrc/<name>.cu`` built (nvcc, sm_90a, ``extra_flags``
    added) into its own library and loaded through ctypes; ``headers``
    are csrc files it includes; ``store`` as in `build_shared`."""
    import ctypes
    return ctypes.CDLL(build_shared(
        name, [csrc_path(name + ".cu")], nvcc_path(),
        (*NVCC_FLAGS, *extra_flags), headers=[csrc_path(h) for h in headers],
        store=store))
