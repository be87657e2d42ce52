"""The functional ops GPT uses (counterparts of paddle_tpu/ops/nn_ops.py
and ops/linalg.py), with the reference's cast order kept."""
from __future__ import annotations

import math

import torch

__all__ = ["linear", "embedding", "layer_norm", "gelu",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W laid out [in, out], as paddle_tpu's Linear
    keeps it (nn/layers/common.py:12). bf16 products accumulate in f32
    and round once to bf16 before the bias, as ops/nn_ops.py:210 does."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(ids, weight):
    return weight[ids]


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis: f32 statistics, then a cast back to
    the input dtype BEFORE the affine (ops/nn_ops.py:501-509)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate=False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """The plain attention composite of ops/nn_ops.py:875-899 on the
    paddle layout [batch, seq, heads, head_dim]: f32 scores, an optional
    bottom-right-aligned causal mask, a boolean or additive mask, f32
    softmax cast back to the query dtype, then probs @ v. Dropout-free
    (the serving slice runs in eval mode)."""
    q = query.transpose(1, 2)                            # [b, h, s, d]
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(d)
    if is_causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=scores.device).tril(s_k - s_q)
        scores = scores.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, float("-inf"))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2)                           # [b, s, h, d]
