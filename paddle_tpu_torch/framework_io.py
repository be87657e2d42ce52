"""paddle.save / paddle.load (counterpart of paddle_tpu/framework_io.py):
pickled objects whose tensors are numpy arrays.

The file is the reference's: each Tensor (a Parameter too) becomes
``{"__paddle_tpu_tensor__": True, "data": array, "stop_gradient": ...,
"name": ...}`` inside the same dicts, lists and tuples, so a file saved
by either package loads in the other. ``save`` also takes torch tensors
(the port's torch-level ``state_dict()``s), written in the same form
with ``stop_gradient`` from ``requires_grad`` and no name. bfloat16
arrays are ml_dtypes' bfloat16, as the reference's ``numpy()`` gives
them."""
from __future__ import annotations

import contextlib
import os
import pickle
import uuid

import torch

from .core.tensor import Tensor

__all__ = ["save", "load"]


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        return {"__paddle_tpu_tensor__": True, "data": obj.numpy(),
                "stop_gradient": obj.stop_gradient, "name": obj.name}
    if isinstance(obj, torch.Tensor):
        return {"__paddle_tpu_tensor__": True,
                "data": Tensor._wrap(obj.detach()).numpy(),
                "stop_gradient": not obj.requires_grad, "name": None}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_tensor__"):
            if return_numpy:
                return obj["data"]
            t = Tensor(obj["data"], stop_gradient=obj.get("stop_gradient",
                                                          True))
            t.name = obj.get("name", t.name)
            return t
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_saveable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Crash-safe: the pickle lands in a sibling temp file (fsync'd) and
    is renamed over `path` in one atomic step, then the directory is
    fsync'd: a crash mid-save leaves the previous file intact, never a
    torn pickle, and a failed save leaves no temp file. The fault point
    ``framework_io.before_rename`` sits between the two."""
    from .resilience import faults
    from .utils.fs import fsync_dir
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # pid alone collides across hosts on shared filesystems / pid reuse
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_to_saveable(obj), f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        faults.fault_point("framework_io.before_rename", path=path)
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load(path, return_numpy=False, **configs):
    """The object `save` wrote, its tensors as Tensors on the default
    place (or numpy arrays with `return_numpy`)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_saveable(obj, return_numpy)
