"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100. It keeps paddle_tpu's module paths and public names; its kernels
are written by hand for Hopper (sm_90a). It imports torch and numpy,
never jax and nothing from the paddle_tpu package.

Entry points (GPTForCausalLM, LlamaForCausalLM, BertForMaskedLM, the
vision ResNets, the fused incubate layers, the nn conv, pooling and
norm layers, the nn transformer layers, LLMEngine, generate,
TrainStep and the optimizers, which follow the model's parameters) run
on the CUDA card unless the caller passes device="cpu"; without a card
they raise."""
from . import (amp, core, distributed, incubate, inference, jit, kernels,
               models, nn, optimizer, resilience, vision)
from .convert import (bert_params_from_numpy, fused_params_from_numpy,
                      gpt_params_from_numpy, llama_params_from_numpy,
                      optimizer_state_from_numpy, resnet_params_from_numpy)
from .core import resolve_device
from .core.flags import get_flags, set_flags
from .inference import LLMEngine, PagedKVCache
from .jit import TrainStep
from .models import (BertConfig, BertForMaskedLM, GPTConfig, GPTForCausalLM,
                     GPTPretrainingCriterion, LlamaConfig, LlamaForCausalLM,
                     generate)

__all__ = ["amp", "core", "distributed", "incubate", "inference", "jit",
           "kernels", "models", "nn", "optimizer", "resilience", "vision",
           "bert_params_from_numpy", "fused_params_from_numpy",
           "gpt_params_from_numpy", "llama_params_from_numpy",
           "optimizer_state_from_numpy", "resnet_params_from_numpy",
           "resolve_device", "get_flags", "set_flags", "LLMEngine", "PagedKVCache", "TrainStep",
           "BertConfig", "BertForMaskedLM", "GPTConfig", "GPTForCausalLM",
           "GPTPretrainingCriterion", "LlamaConfig", "LlamaForCausalLM",
           "generate"]
