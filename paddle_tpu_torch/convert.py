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
           "vision_params_from_numpy", "hybrid_gpt_params_from_numpy",
           "mp_shard_state", "mp_gather_state"]

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
# the hybrid GPT (GPTForCausalLMHybrid, and its PipelineLayer form keyed
# ``stages.<part>.<i>.``, the tied embedding under its home position's
# ``layer.``): the reference's names one for one
hybrid_gpt_params_from_numpy = gpt_params_from_numpy


def _mp_axis(name, shape):
    """The axis `name` is split on under ``gpt_tp_rules`` (None:
    replicated)."""
    from .models.shard_plans import gpt_tp_rules
    spec = tuple(gpt_tp_rules(name, shape))
    return spec.index("mp") if "mp" in spec else None


def _qkv_blocks(arr, mp):
    """A fused QKV weight's or bias's last axis as [3, mp, cols]: the q,
    k and v blocks, each cut into mp runs of whole heads."""
    cols = arr.shape[-1] // 3
    return arr.reshape(arr.shape[:-1] + (3, mp, cols // mp))


def mp_shard_state(full: Dict, rank: int, mp: int, num_heads: int) -> Dict:
    """Rank `rank`'s shard (of `mp`) of a whole hybrid GPT state (numpy
    arrays or torch tensors by the reference's names), for a model built
    in process-group mode: each array cut by ``shard_plans.gpt_tp_rules``
    into `mp` equal runs of its split axis, except the fused QKV
    projection, whose q, k and v blocks are each cut by head
    (`num_heads` divisible by `mp`), rank r keeping [q_r | k_r | v_r]."""
    if num_heads % mp:
        raise ValueError(f"{num_heads} heads do not split over mp {mp}")
    out = {}
    for name, v in full.items():
        arr = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v)
        ax = _mp_axis(name, arr.shape)
        if ax is None:
            out[name] = arr
        elif "qkv_proj" in name:
            out[name] = _qkv_blocks(arr, mp)[..., rank, :].reshape(
                arr.shape[:-1] + (-1,))
        else:
            out[name] = np.split(arr, mp, axis=ax)[rank]
    return {k: _to_tensor(a) for k, a in out.items()}


def mp_gather_state(shards) -> Dict:
    """The inverse of `mp_shard_state` (for gradients): the whole arrays
    (numpy) from every rank's shard (a list by rank); a replicated array
    is rank 0's."""
    mp = len(shards)
    out = {}
    for name in shards[0]:
        parts = [np.asarray(s[name].detach().cpu()
                            if isinstance(s[name], torch.Tensor) else s[name])
                 for s in shards]
        cols = parts[0].shape
        ax = _mp_axis(name, cols)
        if ax is None:
            out[name] = parts[0]
        elif "qkv_proj" in name:
            blocks = [p.reshape(p.shape[:-1] + (3, -1)) for p in parts]
            out[name] = np.stack(blocks, axis=-2).reshape(
                cols[:-1] + (-1,))
        else:
            out[name] = np.concatenate(parts, axis=ax)
    return out


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
