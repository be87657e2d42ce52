from .bert import BertConfig, BertForMaskedLM, BertModel, bert_base, bert_tiny
from .generation import generate
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt2_small, gpt3_1p3b, gpt3_6p7b,
                  gpt_tiny, num_params)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama2_7b,
                    llama2_13b, llama_tiny)

__all__ = ["BertConfig", "BertForMaskedLM", "BertModel", "bert_base",
           "bert_tiny", "generate", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt2_small", "gpt3_1p3b", "gpt3_6p7b",
           "gpt_tiny", "num_params", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama2_7b", "llama2_13b", "llama_tiny"]
