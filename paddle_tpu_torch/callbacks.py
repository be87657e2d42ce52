"""paddle.callbacks namespace (counterpart of paddle_tpu/callbacks.py;
ref: python/paddle/callbacks/__init__.py re-exporting hapi callbacks)."""
from .hapi.model_api import (  # noqa: F401
    Callback, EarlyStopping, ModelCheckpoint, ProgBarLogger,
    LRSchedulerCallback as LRScheduler,
)
from .hapi.summary_writer import SummaryWriter, VisualDL  # noqa: F401

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "SummaryWriter"]
