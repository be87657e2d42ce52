"""Serving helpers of the fused functional ops (counterpart of
paddle_tpu/incubate/nn/functional/serving.py), cut to what the serving
engine uses: the rotary helper it applies to LLaMA's q and k, and the
int8 KV quantizer of its int8 pools. The rest of that module
(masked_multihead_attention, block_multihead_attention,
fused_multi_transformer) is not ported yet."""
from __future__ import annotations

import torch

__all__ = []


def _apply_rotary(x, cos, sin, neox):
    """serving.py:101. x: [..., D]; cos/sin: [..., D // 2] (half-width
    tables, unlike fused_rotary_position_embedding's full-width ones).
    neox=True rotates the split halves (GPT-NeoX), else adjacent pairs
    (GPT-J / interleaved). Runs in the promoted dtype of x and the
    tables; the caller casts."""
    d = x.shape[-1]
    if neox:
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape)


def _quantize_kv(x, scale, round_type, max_bound, min_bound):
    """serving.py:88. x: [..., H, D] float -> int8 with the per-head
    scale [H]: x in f32 times the scale, rounded (round_type 0 = half
    away from zero, the reference's quant_round_type=0; 1 = half to
    even, the default), clipped to [min_bound, max_bound]."""
    s = scale.reshape((1,) * (x.dim() - 2) + (-1, 1))
    y = x.float() * s
    if round_type == 0:
        y = torch.sign(y) * torch.floor(y.abs() + 0.5)
    else:
        y = torch.round(y)
    return y.clamp(min_bound, max_bound).to(torch.int8)
