"""meta_parallel (counterpart of paddle_tpu/distributed/meta_parallel/).
Only activation recompute is ported so far."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
