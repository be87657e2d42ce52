"""Data type names for the PyTorch port (counterpart of
paddle_tpu/core/dtype.py, cut to the types the serving slice uses)."""
from __future__ import annotations

import torch

__all__ = ["bfloat16", "float32", "int8", "to_dtype"]

bfloat16 = torch.bfloat16
float32 = torch.float32
int8 = torch.int8

_BY_NAME = {"bfloat16": bfloat16, "float32": float32, "int8": int8}


def to_dtype(x) -> torch.dtype:
    """Coerce a name ('bfloat16', 'float32', 'int8') or a torch dtype."""
    if isinstance(x, torch.dtype):
        return x
    try:
        return _BY_NAME[str(x)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {x!r}; use one of {sorted(_BY_NAME)}"
        ) from None
