"""paddle_tpu_torch.distributed (counterpart of paddle_tpu/distributed/).
Only ``meta_parallel``'s activation recompute is ported so far."""
from . import meta_parallel
from .meta_parallel import recompute, recompute_sequential

__all__ = ["meta_parallel", "recompute", "recompute_sequential"]
