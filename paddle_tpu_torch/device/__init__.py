"""paddle_tpu_torch.device (counterpart of paddle_tpu/device/__init__.py;
ref: python/paddle/device/__init__.py: set_device:265, Stream:617,
Event:445).

Streams and events are torch.cuda's: `Stream` and `Event` wrap a
``torch.cuda.Stream`` / ``torch.cuda.Event`` of the device they are
made for, `synchronize` waits for the card, and the `cuda` namespace
carries `device.memory`'s functions over the caching allocator. Every
function takes the port's default place when no device is given: the
card, which raises without one until ``set_device("cpu")``. On the CPU
place a stream and an event are inert, as the reference's are on every
backend (XLA owns its streams), and `synchronize` returns at once.

The reference's vendor-plugin names (``register_pjrt_plugin``,
``get_all_custom_device_type``, ``get_available_custom_device``,
``is_compiled_with_custom_device``) register PJRT plugins, which are
JAX's own: they are not ported."""
from __future__ import annotations

import torch

from . import memory  # noqa: F401
from ..core.device import (  # noqa: F401
    set_device, get_device, get_place, Place, CPUPlace, CUDAPlace,
    device_count, is_compiled_with_cuda, is_compiled_with_tpu,
)

__all__ = ["memory", "set_device", "get_device", "get_place", "Place",
           "CPUPlace", "CUDAPlace", "device_count", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "get_all_device_type",
           "get_available_device", "synchronize", "Stream", "Event",
           "current_stream", "set_stream", "stream_guard", "cuda"]


def get_all_device_type():
    """The platforms of the default backend: ["gpu"] with a card, else
    ["cpu"] (the reference lists its jax backend's, "tpu" or "cpu")."""
    return ["gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device():
    if torch.cuda.is_available():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def synchronize(device=None):
    """Wait for every launch queued on the card (the default place's, or
    `device`'s); nothing to wait for on the CPU."""
    d = memory._device(device)
    if d.type == "cuda":
        torch.cuda.synchronize(d)


class Stream:
    """A CUDA stream of `device` (``torch.cuda.Stream``; the reference's
    priority 1 is high, 2 normal), inert on the CPU. `torch_stream` is
    the torch stream, None on the CPU."""

    def __init__(self, device=None, priority=2):
        d = memory._device(device)
        self.device = d
        self.torch_stream = (torch.cuda.Stream(
            d, priority=-1 if priority == 1 else 0)
            if d.type == "cuda" else None)

    @classmethod
    def _of(cls, device, torch_stream):
        """A Stream over an existing torch stream (None on the CPU)."""
        s = cls.__new__(cls)
        s.device, s.torch_stream = device, torch_stream
        return s

    def synchronize(self):
        if self.torch_stream is not None:
            self.torch_stream.synchronize()

    def wait_event(self, event):
        if self.torch_stream is not None and event.torch_event is not None:
            self.torch_stream.wait_event(event.torch_event)

    def wait_stream(self, stream):
        if self.torch_stream is not None and stream.torch_stream is not None:
            self.torch_stream.wait_stream(stream.torch_stream)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event

    def query(self):
        return True if self.torch_stream is None \
            else self.torch_stream.query()


class Event:
    """A CUDA event of `device` (``torch.cuda.Event``), inert on the CPU.
    `torch_event` is the torch event, None on the CPU."""

    def __init__(self, device=None, enable_timing=False, blocking=False):
        d = memory._device(device)
        self.device = d
        self.torch_event = (torch.cuda.Event(enable_timing=enable_timing,
                                             blocking=blocking)
                            if d.type == "cuda" else None)

    def record(self, stream=None):
        if self.torch_event is None:
            return
        s = current_stream(self.device) if stream is None else stream
        self.torch_event.record(s.torch_stream)

    def query(self):
        return True if self.torch_event is None \
            else self.torch_event.query()

    def synchronize(self):
        if self.torch_event is not None:
            self.torch_event.synchronize()

    def elapsed_time(self, end_event):
        """Milliseconds from this event to `end_event` (both recorded
        with enable_timing=True)."""
        return self.torch_event.elapsed_time(end_event.torch_event)


def current_stream(device=None):
    d = memory._device(device)
    return Stream._of(d, torch.cuda.current_stream(d)
                      if d.type == "cuda" else None)


def set_stream(stream):
    """Make `stream` its device's current stream; returns it."""
    if stream.torch_stream is not None:
        torch.cuda.set_stream(stream.torch_stream)
    return stream


class stream_guard:
    """Run the block with `stream` as its device's current stream."""

    def __init__(self, stream):
        self.stream = stream
        self._ctx = None

    def __enter__(self):
        if self.stream.torch_stream is not None:
            self._ctx = torch.cuda.stream(self.stream.torch_stream)
            self._ctx.__enter__()
        return self.stream

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        return False


class cuda:  # namespace: paddle.device.cuda.*
    """ref: python/paddle/device/cuda/__init__.py, over the caching
    allocator through `device.memory`."""

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    max_memory_allocated = staticmethod(memory.max_memory_allocated)
    memory_allocated = staticmethod(memory.memory_allocated)
    memory_reserved = staticmethod(memory.memory_reserved)
    max_memory_reserved = staticmethod(memory.max_memory_reserved)
    reset_max_memory_allocated = staticmethod(
        memory.reset_max_memory_allocated)
    reset_peak_memory_stats = staticmethod(memory.reset_peak_memory_stats)
    empty_cache = staticmethod(memory.empty_cache)
    memory_stats = staticmethod(memory.memory_stats)

    @staticmethod
    def device_count():
        return device_count()


cuda.Stream = Stream
cuda.Event = Event
