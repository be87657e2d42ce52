"""paddle_tpu_torch.distributed (counterpart of paddle_tpu/distributed/).
Ported so far: ``meta_parallel``'s activation recompute and ``rpc`` (the
fleet's HMAC call layer)."""
from . import meta_parallel, rpc
from .meta_parallel import recompute, recompute_sequential

__all__ = ["meta_parallel", "recompute", "recompute_sequential", "rpc"]
