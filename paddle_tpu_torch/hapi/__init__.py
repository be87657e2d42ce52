"""hapi (counterpart of paddle_tpu/hapi/; ref: python/paddle/hapi/)."""
from .model_api import (Callback, EarlyStopping, Model,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, summary)
from .summary_writer import SummaryWriter, VisualDL  # noqa: F401
