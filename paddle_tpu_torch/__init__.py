"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100. It keeps paddle_tpu's module paths and public names; its kernels
are written by hand for Hopper (sm_90a). It imports torch and numpy,
never jax and nothing from the paddle_tpu package.

Entry points (GPTForCausalLM, LlamaForCausalLM, BertForMaskedLM, the
vision ResNets, the fused incubate layers, the nn conv, pooling and
norm layers, the nn transformer layers, LLMEngine, generate,
TrainStep and the optimizers, which follow the model's parameters) run
on the CUDA card unless the caller passes device="cpu"; without a card
they raise.

The eager API (``Tensor``, ``to_tensor``, the registered ops, autograd,
``seed``, places, ``nn.Layer`` / ``nn.Parameter`` / ``nn.ParamAttr``,
``save`` / ``load``, ``io``'s datasets and DataLoader, ``jit``'s
to_static / save / load, ``inference``'s Predictor, ``metric``,
``utils``, ``callbacks``, ``Model`` and ``summary``; ``distribution``,
and lazily, as the reference resolves them, ``fft``, ``signal``,
``sparse``, ``geometric``, ``quantization`` and ``audio``) keeps the
reference's root names, so one eager script runs on either package by
swapping the import. Its default place
is the card; ``set_device("cpu")`` asks for the CPU. The port's models
(GPTForCausalLM, LlamaForCausalLM, BertForMaskedLM, the ResNets) stay
torch ``nn.Module``s whose children are ``Layer``s."""
# the op registry first: nn.functional registers its ops in it
from . import core, ops  # noqa: I001
from . import (amp, autograd, distributed, distribution, framework_io,
               incubate, inference, io, jit, kernels, models, nn, optimizer,
               resilience, vision)
from . import callbacks, metric, tensor_array, utils
from .convert import (bert_params_from_numpy, fused_params_from_numpy,
                      gpt_params_from_numpy, llama_params_from_numpy,
                      optimizer_state_from_numpy, resnet_params_from_numpy,
                      vision_params_from_numpy)
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .core import resolve_device
from .core.device import (CPUPlace, CUDAPlace, Place, device_count,
                          get_device, get_place, is_compiled_with_cuda,
                          set_device)
from .core.dtype import (DType, bfloat16, complex64, complex128, finfo,
                         float16, float32, float64, iinfo, int8, int16,
                         int32, int64, uint8)
from .core.dtype import bool_ as bool  # noqa: A001
from .core.generator import Generator, default_generator, seed
from .core.tensor import Tensor, to_tensor
from .ops import *  # noqa: F401,F403
from .ops import cast, slice, split, unique  # noqa: F401
from .core.flags import get_flags, set_flags
from .framework_io import load, save
from .hapi.model_api import Model, summary
from .tensor_array import (array_length, array_read, array_write,
                           create_array)
from .inference import LLMEngine, PagedKVCache
from .jit import TrainStep
from .models import (BertConfig, BertForMaskedLM, GPTConfig, GPTForCausalLM,
                     GPTPretrainingCriterion, LlamaConfig, LlamaForCausalLM,
                     generate)

__all__ = ["amp", "core", "distributed", "distribution", "incubate",
           "inference", "jit", "kernels", "models", "nn", "optimizer",
           "resilience", "vision",
           "bert_params_from_numpy", "fused_params_from_numpy",
           "gpt_params_from_numpy", "llama_params_from_numpy",
           "optimizer_state_from_numpy", "resnet_params_from_numpy",
           "resolve_device", "get_flags", "set_flags", "LLMEngine", "PagedKVCache", "TrainStep",
           "BertConfig", "BertForMaskedLM", "GPTConfig", "GPTForCausalLM",
           "GPTPretrainingCriterion", "LlamaConfig", "LlamaForCausalLM",
           "generate", "Tensor", "to_tensor", "seed", "Generator",
           "default_generator", "no_grad", "enable_grad",
           "set_grad_enabled", "grad", "is_grad_enabled", "set_device",
           "get_device", "get_place", "Place", "CPUPlace", "CUDAPlace",
           "device_count", "is_compiled_with_cuda", "autograd", "ops",
           "DType", "bool", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "finfo", "iinfo", "framework_io", "save", "load",
           "io", "callbacks", "metric", "utils", "Model", "summary",
           "tensor_array", "create_array", "array_write", "array_read",
           "array_length", "vision_params_from_numpy"]


_LAZY = ("fft", "signal", "sparse", "geometric", "quantization", "audio")


def __getattr__(name):
    # the op surfaces resolved at first use, as the reference's root
    # resolves them
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")
