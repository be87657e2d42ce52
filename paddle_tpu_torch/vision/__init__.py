"""paddle_tpu_torch.vision (counterpart of paddle_tpu/vision): the
models (ResNet so far)."""
from . import models

__all__ = ["models"]
