"""paddle_tpu_torch.resilience (counterpart of paddle_tpu/resilience):
the deterministic fault-injection registry (`faults`) that the serving
engine's hardening (deadlines, poisoned-request isolation,
load-shedding admission, speculative-step degradation) is tested
through. The reference's crash-safe checkpoints, self-healing
DataLoader and training supervisor are not ported yet."""
from . import faults  # noqa: F401
from .faults import fault_point, inject  # noqa: F401
