"""The backward dispatch modes (counterpart of
paddle_tpu/autograd/dispatch_queue.py's mode API, :87-120).

The reference's dispatch queue fuses runs of its tape's grad nodes into
XLA executables to cut JAX's per-node dispatch gaps; its modes
("whole_graph", "batched", "per_node") choose how much it fuses, and
its gradients are bit-identical across them. The port's reverse pass is
torch.autograd's in every mode, so the mode is kept only so callers
still run: it selects nothing. The float0 helpers (``is_float0``,
``zero_cotangent_array``, ``ones_seed_array``), the constant caches
(``clear_const_caches``), the fused-chain cache (``chain_cache_size``,
``clear_chain_cache``) and ``run_batched`` are JAX's own and are not
ported.
"""
from __future__ import annotations

import os

__all__ = ["dispatch_mode", "set_dispatch_mode", "backward_dispatch_mode"]

_MODE_ENV = "PADDLE_TPU_BACKWARD_DISPATCH"
_VALID_MODES = ("whole_graph", "batched", "per_node")
_mode = os.environ.get(_MODE_ENV, "whole_graph")
if _mode not in _VALID_MODES:
    _mode = "whole_graph"


def dispatch_mode() -> str:
    """The current backward dispatch mode (torch.autograd runs every
    one)."""
    return _mode


def set_dispatch_mode(mode: str) -> str:
    """Set the backward dispatch mode; returns the previous mode."""
    global _mode
    if mode not in _VALID_MODES:
        raise ValueError(
            f"backward dispatch mode must be one of {_VALID_MODES}, "
            f"got {mode!r}")
    old = _mode
    _mode = mode
    return old


class backward_dispatch_mode:
    """Context manager pinning the backward dispatch mode."""

    def __init__(self, mode: str):
        self._new = mode

    def __enter__(self):
        self._old = set_dispatch_mode(self._new)
        return self

    def __exit__(self, *exc):
        set_dispatch_mode(self._old)
        return False
