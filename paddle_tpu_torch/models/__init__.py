from .generation import generate
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt2_small, gpt3_1p3b, gpt_tiny,
                  num_params)

__all__ = ["generate", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt2_small", "gpt3_1p3b", "gpt_tiny",
           "num_params"]
