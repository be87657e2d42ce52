"""paddle.incubate.autotune (counterpart of
paddle_tpu/incubate/autotune.py:18, ``set_config``): runtime tuning
switches.

The "kernel" section maps onto the Hopper kernels' block-config cache
(``kernels/autotune.py``: a sweep of build variants per shape class,
winners on disk); "layout" and "dataloader" tuning are accepted and do
nothing, and warn when enabled, as in the reference (the DataLoader
sizes its workers explicitly)."""
from __future__ import annotations

import json
import os
import warnings

__all__ = ["set_config"]


def set_config(config=None):
    """config: a dict (or the path of a JSON file) with optional sections
    kernel / layout / dataloader, e.g. {"kernel": {"enable": True}};
    None enables kernel tuning."""
    if config is None:
        os.environ["PADDLE_TPU_PALLAS_AUTOTUNE"] = "1"
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    kernel = config.get("kernel", {})
    if "enable" in kernel:
        os.environ["PADDLE_TPU_PALLAS_AUTOTUNE"] = \
            "1" if kernel["enable"] else "0"
    for section in ("layout", "dataloader"):
        if config.get(section, {}).get("enable"):
            warnings.warn(
                f"incubate.autotune: the {section!r} section is a no-op "
                "here (torch chooses layouts; DataLoader workers are "
                "explicit)", stacklevel=2)
