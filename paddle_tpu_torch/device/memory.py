"""Device memory telemetry over torch's caching allocator (counterpart of
paddle_tpu/device/memory.py; ref: paddle.device.cuda memory stats,
python/paddle/device/cuda/__init__.py: max_memory_allocated:110,
memory_allocated:170, memory_reserved, backed by
paddle/fluid/memory/stats.cc).

The numbers are the caching allocator's (``torch.cuda.memory_stats`` /
``memory_allocated`` / ``max_memory_allocated`` /
``reset_peak_memory_stats``): ``memory_allocated`` is the bytes held by
live tensors, ``max_memory_allocated`` their peak since the last reset.
`memory_stats` carries the reference's keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``) beside torch's own.

Departures:

* ``memory_reserved`` is the caching allocator's reserved bytes (what it
  holds from CUDA, used or cached), Paddle's own meaning. The
  reference returns PJRT's ``bytes_limit`` there (:74-75) because PJRT
  reports no reservation; torch's allocator does, so the port gives the
  reservation and keeps the capacity under ``memory_stats()
  ["bytes_limit"]`` (the card's total memory).
* ``reset_max_memory_allocated`` resets torch's peaks; the reference
  re-derives a peak from a baseline because PJRT's peaks never reset.
  Both then report the high-water mark since the reset.
* ``empty_cache`` releases the allocator's cached blocks to CUDA
  (the reference's is a no-op: PJRT owns its caching).

Every function takes the port's device forms (None = the default
place, an index, "gpu:N" / "cuda:N" / "cpu", a Place or a
torch.device). Without a card the default place raises until
``set_device("cpu")``, as the creation ops do; on the CPU the functions
return what the reference's CPU run returns: zeros and an empty
`memory_stats`.

``state_bytes_per_device`` gives EXACT per-device accounting for a set of
tensors (each device's resident bytes), on every device.

``FLAGS_allocator_strategy`` is registered here. It is informational,
as in the reference: torch's caching allocator (which grows on demand
and caches freed blocks, Paddle's "auto_growth") owns device memory.
Its default is "auto_growth", where the reference's is "pjrt"."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..core.flags import define_flag

define_flag("FLAGS_allocator_strategy", "auto_growth",
            "memory strategy (informational; torch's caching allocator "
            "owns device memory)")


def _device(device=None) -> torch.device:
    """The torch device of one of the port's device forms."""
    from ..core import device as _d
    if device is None:
        return _d.default_torch_device()
    if isinstance(device, torch.device):
        return device
    if isinstance(device, int):
        return _d.resolve_device(f"cuda:{device}")
    return _d._parse(device).torch_device()


def memory_stats(device=None) -> dict:
    d = _device(device)
    if d.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(d))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    stats["bytes_reserved"] = int(stats.get("reserved_bytes.all.current", 0))
    stats["bytes_limit"] = int(torch.cuda.get_device_properties(d)
                               .total_memory)
    return stats


def memory_allocated(device=None) -> int:
    d = _device(device)
    return int(torch.cuda.memory_allocated(d)) if d.type == "cuda" else 0


def max_memory_allocated(device=None) -> int:
    d = _device(device)
    return int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda" \
        else 0


def memory_reserved(device=None) -> int:
    d = _device(device)
    return int(torch.cuda.memory_reserved(d)) if d.type == "cuda" else 0


def max_memory_reserved(device=None) -> int:
    d = _device(device)
    return int(torch.cuda.max_memory_reserved(d)) if d.type == "cuda" \
        else 0


def reset_max_memory_allocated(device=None) -> None:
    d = _device(device)
    if d.type == "cuda":
        torch.cuda.reset_peak_memory_stats(d)


reset_peak_memory_stats = reset_max_memory_allocated


def empty_cache() -> None:
    """Release the caching allocator's unused cached blocks (a no-op
    without a CUDA context)."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def state_bytes_per_device(arrays: Iterable) -> Dict[int, int]:
    """Exact bytes each device holds for `arrays` (Tensors or torch
    tensors): each tensor's elements times its element size, keyed by
    its CUDA index; the CPU counts as device 0, as the reference's CPU
    run numbers its one device."""
    per: Dict[int, int] = {}
    for a in arrays:
        t = getattr(a, "_data", a)
        d = t.device.index if t.device.type == "cuda" else 0
        d = 0 if d is None else d
        per[d] = per.get(d, 0) + t.numel() * t.element_size()
    return per
