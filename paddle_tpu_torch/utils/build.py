"""Build native sources into shared libraries at first use.

Counterpart of paddle_tpu/utils/cpp_extension.py::_compile, cut to what
the serving slice needs: the paged-cache block allocator (g++) and the
hand-written CUDA kernels (nvcc). Libraries land in ``build/paddle_tpu_torch/``
under the repository root, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads straight away.
Each build writes a private temporary file and renames it into place, so
processes that build the same library at once never load a torn file.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

__all__ = ["build_dir", "build_shared", "csrc_path", "load_cuda", "nvcc_path"]

# CUDA kernels are compiled for Hopper only: sm_90a keeps wgmma/setmaxnreg
# available to the kernels that will use them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


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
                 flags: Sequence[str], headers: Sequence[str] = ()) -> str:
    """Compile ``sources`` with ``compiler`` and ``flags`` into
    ``build_dir()/<name>_<hash>.so``; returns the library's path.
    ``headers`` are the files the sources include: hashed with them, so
    an edited header rebuilds every library that names it."""
    tag = hashlib.sha256()
    for s in (*sources, *headers):
        tag.update(Path(s).read_bytes())
    tag.update(" ".join([os.path.basename(compiler), *flags]).encode())
    out = build_dir() / f"{name}_{tag.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def csrc_path(name: str) -> str:
    """``paddle_tpu_torch/kernels/csrc/<name>``."""
    return str(Path(__file__).resolve().parents[1] / "kernels" / "csrc" / name)


def load_cuda(name: str, headers: Sequence[str] = (),
              extra_flags: Sequence[str] = ()):
    """``kernels/csrc/<name>.cu`` built (nvcc, sm_90a, ``extra_flags``
    added) into its own library and loaded through ctypes; ``headers``
    are csrc files it includes."""
    import ctypes
    return ctypes.CDLL(build_shared(
        name, [csrc_path(name + ".cu")], nvcc_path(),
        (*NVCC_FLAGS, *extra_flags), headers=[csrc_path(h) for h in headers]))
