"""The device step of the DataLoader: a batch's numpy leaves become
Tensors on the loader's place. New in the port (the reference hands
numpy to ``Tensor`` at paddle_tpu/io/__init__.py:268-284 and :488-497,
and XLA moves it).

On the CPU each leaf is wrapped without a copy (the collate made it
fresh), cast as the reference's arrays are without x64 (int64 ->
int32, float64 -> float32, ...).

On the card each batch reaches the device once, from pinned memory:

- every leaf is copied into one pinned staging buffer, each at an
  offset aligned to 256 bytes (in the process tier straight out of its
  shared-memory segment);
- one host-to-device copy of the whole buffer is issued with
  ``non_blocking=True`` on the feed's own copy stream, and an event is
  recorded after it;
- the leaves are views of the one device buffer.

The consumer's stream waits on the event (no host wait) and
``record_stream`` marks the device buffer as used there, so the caching
allocator does not hand it to the copy stream again before the
consumer's work on it is done. The staging buffers are a ring of
two per feed (one feed per loader), grown to the largest batch and
reused: before a slot is refilled the host waits on its previous copy's
event. ``h2d_copies`` counts the copies issued and nothing else.

The feed runs in a loader's thread while the consumer may be capturing
a CUDA graph (TrainStep's first call of a batch signature); CUDA
refuses many calls from any thread while a capture is under way, so the
feed makes its CUDA calls under ``jit.cuda_graph.capture_lock``, which
every capture holds."""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.tensor import _NP_NARROW, Tensor, _init
from ..jit.cuda_graph import capture_lock

_ALIGN = 256
# staging buffers a feed keeps: a batch is staged while the previous
# one's copy may still be reading its buffer
_SLOTS = 2

__all__ = ["DeviceFeed", "Arrival"]


def _leaves(obj, out):
    """The ndarray leaves of a collated batch, in order."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _leaves(x, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    return out


def _rebuild(obj, it):
    """`obj` with each ndarray leaf replaced by the next of `it`."""
    if isinstance(obj, np.ndarray):
        return next(it)
    if isinstance(obj, list):
        return [_rebuild(x, it) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_rebuild(x, it) for x in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    return obj


def _target(a: np.ndarray) -> np.dtype:
    """The dtype the reference's array of `a` has without x64."""
    return np.dtype(_NP_NARROW.get(a.dtype, a.dtype))


def _stageable(a: np.ndarray) -> bool:
    return a.dtype.kind in "biufc"


def _tensor(data: torch.Tensor) -> Tensor:
    t = Tensor.__new__(Tensor)
    _init(t, data, True, None)
    return t


@dataclass
class Arrival:
    """A batch whose Tensors are being copied to the card: `batch`
    (the collated structure, Tensor leaves), the copy's `event` and the
    device `buffer` the leaves view (None and None on the CPU, or for a
    batch with nothing to copy)."""
    batch: object
    event: object = None
    buffer: object = None

    def take(self):
        """The batch, made safe to use on the current stream: that
        stream waits on the copy (on the device, not the host) and the
        buffer is recorded as used by it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.buffer.device)
            stream.wait_event(self.event)
            self.buffer.record_stream(stream)
        return self.batch


class _Slot:
    __slots__ = ("pinned", "event")

    def __init__(self):
        self.pinned = None
        self.event = None


class DeviceFeed:
    """Moves collated numpy batches to `device` (see the module
    docstring); one per DataLoader. Thread-safe: `put` may run in the
    prefetch thread while another epoch's consumer calls it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.h2d_copies = 0
        self._lock = threading.Lock()
        self._stream = None
        self._ring = [_Slot() for _ in range(_SLOTS)]
        self._next = 0

    def put(self, batch) -> Arrival:
        """`batch` (a collated structure) with its stageable ndarray
        leaves turned into Tensors on the feed's device. On the card the
        leaves may be views of shared memory: they are read before
        `put` returns and not kept."""
        arrays = _leaves(batch, [])
        stage = [a for a in arrays if _stageable(a)]
        if self.device.type != "cuda" or not stage:
            return Arrival(_rebuild(batch, iter([self._leaf(a)
                                                 for a in arrays])))
        offs, total = [], 0
        for a in stage:
            offs.append(total)
            n = a.size * _target(a).itemsize
            total += -(-max(n, 1) // _ALIGN) * _ALIGN
        with self._lock:
            slot = self._ring[self._next]
            self._next = (self._next + 1) % len(self._ring)
            # no CUDA call of this thread may fall inside another
            # thread's graph capture (CapturedStep holds the lock)
            with capture_lock:
                if slot.event is not None:
                    slot.event.synchronize()    # its last copy read it
                if slot.pinned is None or slot.pinned.numel() < total:
                    slot.pinned = None
                    slot.pinned = torch.empty(total, dtype=torch.uint8,
                                              pin_memory=True)
            host = slot.pinned.numpy()
            for a, off in zip(stage, offs):
                t = _target(a)
                dst = host[off:off + a.size * t.itemsize].view(t)
                np.copyto(dst.reshape(a.shape), a, casting="unsafe")
            with capture_lock, torch.cuda.device(self.device):
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._stream):
                    buf = torch.empty(total, dtype=torch.uint8,
                                      device=self.device)
                    buf.copy_(slot.pinned[:total], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
            slot.event = event
            self.h2d_copies += 1
        staged = iter(
            _tensor(buf[off:off + a.size * _target(a).itemsize].view(
                _torch_dtype(_target(a))).view(a.shape))
            for a, off in zip(stage, offs))
        out = [next(staged) if _stageable(a) else self._leaf(a)
               for a in arrays]
        return Arrival(_rebuild(batch, iter(out)), event, buf)

    def _leaf(self, a: np.ndarray):
        """A leaf that is not staged: on the CPU a Tensor over `a` (no
        copy unless it is cast); a dtype the staging does not hold
        (bfloat16 from ml_dtypes, objects) goes through ``Tensor``'s own
        conversion on the feed's device."""
        if not _stageable(a):
            return Tensor(a, place=self.device)
        a = np.ascontiguousarray(a.astype(_target(a), copy=False))
        return _tensor(torch.from_numpy(a))


def _torch_dtype(d: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, d)).dtype
