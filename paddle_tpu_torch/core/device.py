"""Device resolution for the PyTorch port.

Counterpart of paddle_tpu/core/device.py. The port's entry points run on
the CUDA card unless the caller asks for the CPU by name: there is no
silent fallback, so a process without a card that did not ask for
``device="cpu"`` gets an error instead of a slow CPU run.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises without a card); ``"cpu"``/``"cuda:N"``
    or a ``torch.device`` pass through, with ``cuda`` checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
