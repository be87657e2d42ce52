"""paddle_tpu_torch.vision (counterpart of paddle_tpu/vision): the
models (ResNet so far), the transforms and the datasets. ``vision.ops``
is ROADMAP item 25's."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
