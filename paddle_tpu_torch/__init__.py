"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100. It keeps paddle_tpu's module paths and public names; its kernels
are written by hand for Hopper (sm_90a). It imports torch and numpy,
never jax and nothing from the paddle_tpu package.

Entry points (GPTForCausalLM, LLMEngine, generate) run on the CUDA card
unless the caller passes device="cpu"; without a card they raise."""
from . import core, inference, kernels, models, nn
from .convert import gpt_params_from_numpy
from .core import resolve_device
from .inference import LLMEngine, PagedKVCache
from .models import GPTConfig, GPTForCausalLM, generate

__all__ = ["core", "inference", "kernels", "models", "nn",
           "gpt_params_from_numpy", "resolve_device", "LLMEngine",
           "PagedKVCache", "GPTConfig", "GPTForCausalLM", "generate"]
