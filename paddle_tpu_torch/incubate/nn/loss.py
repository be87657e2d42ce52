"""incubate.nn loss utilities (counterpart of
paddle_tpu/incubate/nn/loss.py)."""
from __future__ import annotations

__all__ = ["identity_loss"]


def identity_loss(x, reduction="none"):
    """Marks x as a loss (:5): reduction "none", "mean" or "sum" (the
    reference's int codes 0 = sum, 1 = mean, 2 = none too). x: a Tensor
    or a torch tensor."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    if red == "mean":
        return x.mean()
    if red == "sum":
        return x.sum()
    if red == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")
