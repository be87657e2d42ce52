"""Carry paddle_tpu GPT weights into the port.

paddle_tpu's ``state_dict()`` names match the port's parameter names
one for one, and Linear weights keep paddle_tpu's [in, out] layout in
the port, so nothing is transposed: each array is copied into a torch
tensor of the same dtype (bf16 arrays arrive as ml_dtypes bfloat16 and
are reinterpreted bit for bit).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["gpt_params_from_numpy"]


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def gpt_params_from_numpy(named: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """paddle_tpu GPTForCausalLM state_dict (as numpy) -> a state_dict
    for the port's GPTForCausalLM (``model.load_state_dict(...)``)."""
    return {name: _to_tensor(np.asarray(arr)) for name, arr in named.items()}
