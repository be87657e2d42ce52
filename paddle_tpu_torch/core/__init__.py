from . import flags
from .device import (CPUPlace, CUDAPlace, Place, device_count, get_device,
                     get_place, is_compiled_with_cuda, is_compiled_with_tpu,
                     resolve_device, set_device)
from .dtype import bfloat16, float32, int8, to_dtype
from .generator import Generator, default_generator, seed
from .tensor import Tensor, to_tensor

__all__ = ["flags", "resolve_device", "bfloat16", "float32", "int8",
           "to_dtype", "Place", "CPUPlace", "CUDAPlace", "device_count",
           "get_device", "get_place", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "set_device", "Generator",
           "default_generator", "seed", "Tensor", "to_tensor"]
