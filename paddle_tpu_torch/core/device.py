"""Devices and places for the PyTorch port.

Counterpart of paddle_tpu/core/device.py. The port's entry points run on
the CUDA card unless the caller asks for the CPU by name: there is no
silent fallback, so a process without a card that did not ask for
``device="cpu"`` gets an error instead of a slow CPU run.

A ``Place`` names a torch device. The default place of the eager API
(``to_tensor``, the creation and random ops) is ``cuda:0``; without a
card anything that needs it raises until ``set_device("cpu")`` is
called. The reference falls back to the CPU when no accelerator exists
(:66-73, :97-103); the port does not. ``CUDAPlace`` is the counterpart
of the reference's ``TPUPlace`` (:55), which is TPU-specific and not
ported.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "get_device",
           "get_place", "set_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]

_NO_CARD = ("no CUDA device is available; pass device='cpu' (or call "
            "set_device('cpu')) to run on the CPU")


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises without a card); ``"cpu"``/``"cuda:N"``
    or a ``torch.device`` pass through, with ``cuda`` checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CARD)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


class Place:
    """A device of the eager API: ``device_type`` "cpu" or "gpu" and an
    index. ``torch_device()`` is the torch device it names."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self.device_id}")

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"


class CPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("cpu", device_id)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


def place_of(device: torch.device) -> Place:
    """The Place of a torch device."""
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(0 if device.index is None else device.index)


# None: the card, checked each time it is asked for
_current_place: Place | None = None


def get_place() -> Place:
    """The default place: the one ``set_device`` chose, else ``cuda:0``,
    which raises without a card."""
    if _current_place is not None:
        return _current_place
    resolve_device("cuda:0")
    return CUDAPlace(0)


def default_torch_device() -> torch.device:
    """The torch device of ``get_place()`` (raises as it does)."""
    return get_place().torch_device()


def get_device() -> str:
    p = get_place()
    return f"{p.device_type}:{p.device_id}"


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    dev = str(device).lower()
    kind, _, idx = dev.partition(":")
    idx = int(idx) if idx else 0
    if kind == "cpu":
        return CPUPlace(idx)
    if kind in ("gpu", "cuda"):
        return CUDAPlace(idx)
    raise ValueError(f"unsupported device {device!r}; use 'gpu', 'gpu:N' "
                     "or 'cpu'")


def set_device(device) -> Place:
    """Set the default place: "gpu", "gpu:N", "cuda:N" (checked to
    exist: raises without a card) or "cpu", or a Place."""
    global _current_place
    place = _parse(device)
    if place.device_type == "gpu":
        place.torch_device()
    _current_place = place
    return place


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
