"""paddle_tpu_torch.vision (counterpart of paddle_tpu/vision): the
model zoo, the transforms, the datasets and the vision ops."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
