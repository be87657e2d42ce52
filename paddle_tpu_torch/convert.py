"""Carry paddle_tpu weights (GPT, LLaMA, BERT, ResNet, the fused incubate
layers) and optimizer state into the port.

paddle_tpu's ``state_dict()`` names match the port's parameter names
one for one, and Linear weights keep paddle_tpu's [in, out] layout in
the port (the fused layers keep its [3, H, D, dm] qkv layout too), so
nothing is transposed: each array is copied into a torch tensor of the
same dtype (f16 and f32 arrays as numpy's own types; bf16 arrays arrive
as ml_dtypes bfloat16 and are reinterpreted bit for bit). ResNet's
batch-norm buffers ``_mean`` / ``_variance`` ride in the state_dict
beside its parameters, by name as well.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["gpt_params_from_numpy", "llama_params_from_numpy",
           "bert_params_from_numpy", "resnet_params_from_numpy",
           "fused_params_from_numpy", "optimizer_state_from_numpy",
           "vision_params_from_numpy"]

# every optimizer's accumulators (reference optimizers.py): Adam, AdamW
# and Lamb; Momentum; Adamax and Adagrad; RMSProp; Adadelta
_ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow", "velocity",
                 "moment", "inf_norm", "mean_square", "mean_grad",
                 "momentum_acc", "avg_squared_grad", "avg_squared_update")
# multi_precision's f32 master of a parameter (reference optimizer.py:491)
_MASTER = "master"


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


# LLaMA's, BERT's, ResNet's (parameters and batch-norm buffers) and the
# fused incubate layers' state_dicts carry the same way: names one for
# one, layouts unchanged
llama_params_from_numpy = gpt_params_from_numpy
bert_params_from_numpy = gpt_params_from_numpy
resnet_params_from_numpy = gpt_params_from_numpy
fused_params_from_numpy = gpt_params_from_numpy
# the vision zoo (LeNet ... InceptionV3): names and layouts one for one
vision_params_from_numpy = gpt_params_from_numpy


def optimizer_state_from_numpy(state: Dict, names: Dict[str, str]) -> Dict:
    """paddle_tpu ``Optimizer.state_dict()`` (arrays as numpy) -> a state
    dict for the port's ``Optimizer.set_state_dict``.

    paddle_tpu keys accumulators ``<tensor name>_<accumulator>`` with its
    tensors' own names (``p.name``); `names` maps those to the port's
    parameter names (``{p.name: n for n, p in
    paddle_model.named_parameters()}``), and the port's optimizer must
    be built with ``parameters=model.named_parameters()``. Values are
    copied with their dtypes (the bias-correction powers stay f32
    scalars); a multi_precision master (``<tensor name>_master``) is
    carried as an f32 tensor; "LR_Scheduler" and "global_step" pass
    through. A run resumed from the result continues as the reference
    run would."""
    out = {}
    for key, val in state.items():
        if key in ("LR_Scheduler", "global_step"):
            out[key] = val
            continue
        acc = next((a for a in (*_ACCUMULATORS, _MASTER)
                    if key.endswith("_" + a)), None)
        if acc is None:
            raise KeyError(f"optimizer state key {key!r} names none of the "
                           f"accumulators {_ACCUMULATORS} nor a "
                           f"master")
        ref_name = key[:-len(acc) - 1]
        if ref_name not in names:
            raise KeyError(f"no port parameter name for {ref_name!r}")
        t = _to_tensor(np.asarray(val))
        out[f"{names[ref_name]}_{acc}"] = (t.float() if acc == _MASTER
                                           else t)
    return out
