from .device import resolve_device
from .dtype import bfloat16, float32, int8, to_dtype

__all__ = ["resolve_device", "bfloat16", "float32", "int8", "to_dtype"]
