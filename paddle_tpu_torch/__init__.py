"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100. It keeps paddle_tpu's module paths and public names; its kernels
are written by hand for Hopper (sm_90a). It imports torch and numpy,
never jax and nothing from the paddle_tpu package.

Entry points (GPTForCausalLM, LlamaForCausalLM, the fused incubate
layers, LLMEngine, generate, TrainStep and the optimizers, which follow
the model's parameters) run on the CUDA card unless the caller passes
device="cpu"; without a card they raise."""
from . import (amp, core, distributed, incubate, inference, jit, kernels,
               models, nn, optimizer)
from .convert import (fused_params_from_numpy, gpt_params_from_numpy,
                      llama_params_from_numpy, optimizer_state_from_numpy)
from .core import resolve_device
from .inference import LLMEngine, PagedKVCache
from .jit import TrainStep
from .models import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                     LlamaConfig, LlamaForCausalLM, generate)

__all__ = ["amp", "core", "distributed", "incubate", "inference", "jit",
           "kernels", "models", "nn", "optimizer", "fused_params_from_numpy",
           "gpt_params_from_numpy", "llama_params_from_numpy",
           "optimizer_state_from_numpy", "resolve_device", "LLMEngine",
           "PagedKVCache", "TrainStep", "GPTConfig", "GPTForCausalLM",
           "GPTPretrainingCriterion", "LlamaConfig", "LlamaForCausalLM",
           "generate"]
