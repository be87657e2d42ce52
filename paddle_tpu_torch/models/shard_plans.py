"""Megatron-style tensor-parallel sharding plans for the model families
(counterpart of paddle_tpu/models/shard_plans.py).

Each maps a parameter name to its `PartitionSpec` over a ("dp", "mp")
mesh: column-parallel weights split the output axis, row-parallel
weights the input axis, embeddings the vocab axis. The port records
these specs (``distributed.topology``); ``convert.mp_shard_state`` cuts
a whole state by `gpt_tp_rules` for process-group tensor parallelism.
"""
from __future__ import annotations

from ..distributed.topology import PartitionSpec as P

__all__ = ["gpt_tp_rules", "llama_tp_rules", "fsdp_rules"]


def gpt_tp_rules(name: str, shape) -> P:
    """The plan of models.gpt.GPTForCausalLM's parameters."""
    if "word_embeddings" in name:
        return P("mp", None)           # vocab-split
    if "position_embeddings" in name:
        return P()
    if "qkv_proj.weight" in name or "fc1.weight" in name:
        return P(None, "mp")           # column parallel
    if "qkv_proj.bias" in name or "fc1.bias" in name:
        return P("mp")
    if "out_proj.weight" in name or "fc2.weight" in name:
        return P("mp", None)           # row parallel
    if "lm_head.weight" in name:
        return P(None, "mp")
    return P()                         # norms, other biases: replicated


def llama_tp_rules(name: str, shape) -> P:
    """The plan of models.llama.LlamaForCausalLM's parameters."""
    if "embed_tokens" in name:
        return P("mp", None)
    if any(k in name for k in ("q_proj.weight", "k_proj.weight",
                               "v_proj.weight", "gate_proj.weight",
                               "up_proj.weight", "lm_head.weight")):
        return P(None, "mp")
    if "o_proj.weight" in name or "down_proj.weight" in name:
        return P("mp", None)
    return P()


def fsdp_rules(name: str, shape) -> P:
    """A ZeRO-3-style plan: the largest axis split on "dp" (the
    reference's rendering of GroupShardedStage3's parameter split)."""
    if not shape:
        return P()
    big = max(range(len(shape)), key=lambda i: shape[i])
    spec = [None] * len(shape)
    spec[big] = "dp"
    return P(*spec)
