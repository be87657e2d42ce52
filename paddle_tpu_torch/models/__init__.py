from .generation import generate
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_small,
                  gpt3_1p3b, gpt_tiny)

__all__ = ["generate", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "gpt2_small", "gpt3_1p3b", "gpt_tiny"]
