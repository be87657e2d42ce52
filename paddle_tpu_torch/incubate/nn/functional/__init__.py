"""Fused functional ops (counterpart of
paddle_tpu/incubate/nn/functional/__init__.py): the fused norms, which
reach the kernels B4 (layer norm) and B5 (RMS norm), rotary position
embedding, flash attention (B1/B2), and the fused attention and
feed-forward blocks the fused layers are built from.

Each op applies the reference registry's AMP policy for its name first
(fused_rms_norm, fused_layer_norm and
fused_bias_dropout_residual_layer_norm are black, fused_flash_attention
white, the rest follow their inputs). Dropout draws from a
``torch.Generator`` (None: torch's default generator); its masks are
torch's, never jax.random's."""
from __future__ import annotations

import warnings

import torch

from ....amp.state import maybe_cast_inputs as _amp
from ....kernels import norms as _norms
from ....kernels.flash_attention import attention_path, flash_attention
from ....nn import functional as F

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding", "fused_flash_attention",
           "fused_multi_head_attention", "fused_feedforward"]


def fused_rms_norm(x, weight=None, epsilon=1e-6):
    """RMS norm over the last axis through B5 (:18): the CUDA kernel on
    the card, the reference's off-TPU form on the CPU. An AMP-black op."""
    x, weight = _amp("fused_rms_norm", "black", x, weight)
    return _norms.rms_norm(x, weight, epsilon)


def fused_layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the last axis through B4 (:23). AMP-black."""
    x, weight, bias = _amp("fused_layer_norm", "black", x, weight, bias)
    return _norms.layer_norm(x, weight, bias, epsilon)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """RoPE over [batch, seq, heads, head_dim] (:28). sin/cos: full-width
    [seq, head_dim] tables (or [1, seq, 1, head_dim]); absent, they are
    built in f32 with base 10000. The neox style rotates the two halves,
    the other style adjacent pairs. position_ids [batch, seq] pick rows
    of the tables. Each output is cast to its input's dtype after the
    rotation, which runs in the promoted dtype. Returns one tensor, or a
    tuple for several inputs."""
    q, k, v, sin, cos = _amp("fused_rotary_position_embedding", None, q, k,
                             v, sin, cos)
    seq, hd = q.shape[1], q.shape[-1]
    if sin is None or cos is None:
        inv = 1.0 / (10000.0 ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=q.device) / hd))
        t = torch.arange(seq, dtype=torch.float32, device=q.device)
        freqs = torch.outer(t, inv)                          # [seq, hd/2]
        if use_neox_rotary_style:
            emb = torch.cat([freqs, freqs], dim=-1)
        else:
            emb = freqs.repeat_interleave(2, dim=-1)
        sin = torch.sin(emb)[None, :, None, :]
        cos = torch.cos(emb)[None, :, None, :]
    elif sin.dim() == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    if position_ids is not None:
        pid = torch.as_tensor(position_ids, device=q.device).long()
        sin = sin[0, :, 0][pid][:, :, None, :]
        cos = cos[0, :, 0][pid][:, :, None, :]

    def rot(x):
        if use_neox_rotary_style:
            x1, x2 = x.chunk(2, dim=-1)
            rotated = torch.cat([-x2, x1], dim=-1)
        else:
            x1, x2 = x[..., 0::2], x[..., 1::2]
            rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
        return (x * cos + rotated * sin).to(x.dtype)

    outs = tuple(rot(t) for t in (q, k, v) if t is not None)
    return outs if len(outs) > 1 else outs[0]


def fused_flash_attention(query, key, value, attn_mask=None, causal=False,
                          dropout=0.0, training=True, softmax_scale=None,
                          segment_ids=None):
    """Flash attention, [batch, seq, heads, dim] layout (paddle_tpu
    incubate/nn/functional/__init__.py:70); key/value may carry fewer
    heads (GQA/MQA), segment_ids=(q_seg, kv_seg) masks attention to equal
    ids on the kernel path. An AMP-white op.

    On the CUDA card, a fall back to the O(S^2) composite (shapes the
    kernels refuse) is surfaced as a RuntimeWarning naming the reason,
    as the reference does on its device (:90-97); an explicit dense
    attn_mask is the caller's choice and does not warn. Attention
    dropout is not implemented on the flash path: it raises rather than
    training without it (:85-89)."""
    if dropout and training:
        raise NotImplementedError(
            "attention dropout is not implemented on the flash path; set "
            "dropout=0.0")
    query, key, value, attn_mask = _amp(
        "fused_flash_attention", "white", query, key, value, attn_mask)
    if attn_mask is None and query.device.type == "cuda":
        path, why = attention_path(query.shape, key.shape,
                                   device=query.device)
        if path == "composite":
            warnings.warn(
                f"flash_attention fell back to the composite: {why}",
                RuntimeWarning, stacklevel=2)
    return flash_attention(query, key, value, attn_mask=attn_mask,
                           causal=causal, softmax_scale=softmax_scale,
                           segment_ids=segment_ids)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True, generator=None):
    """layer_norm(dropout(x + bias) + residual) through B4 (:133). An
    AMP-black op. The reference's jax.random `key` becomes `generator`."""
    x, residual, bias, ln_scale, ln_bias = _amp(
        "fused_bias_dropout_residual_layer_norm", "black", x, residual,
        bias, ln_scale, ln_bias)
    if bias is not None:
        x = x + bias
    if dropout_rate > 0.0 and training:
        # inline, not F.dropout: the op's own AMP rule (black) holds for
        # its whole body, as in the reference
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            < 1.0 - dropout_rate
        x = torch.where(keep, x / (1.0 - dropout_rate), 0.0).to(x.dtype)
    return _norms.layer_norm(x + residual, ln_scale, ln_bias, ln_epsilon)


def fused_multi_head_attention(x, qkv_weight, qkv_bias, linear_weight,
                               linear_bias, num_heads, pre_layer_norm=False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, training=True,
                               epsilon=1e-5, generator=None):
    """Fused self-attention block (:176): optional pre-LN (B4), the qkv
    projection ([dm, 3*dm] weight, columns [q | k | v] per head),
    attention, the output projection, dropout, the residual, and post-LN
    (B4) unless pre_layer_norm. With attention dropout in training it
    takes the masked SDPA composite, and with an explicit attn_mask the
    attention composite, as the reference does; otherwise B1, non-causal.
    On CUDA tensors B1 must take the shape: a sequence length that is not
    a multiple of 128, or a head_dim outside (64, 128, 256), raises
    rather than running the composite on the card (pad the batch, or
    pass the padding as attn_mask)."""
    residual = x
    if pre_layer_norm:
        x = fused_layer_norm(x, pre_ln_scale, pre_ln_bias, epsilon=epsilon)
    b, s, d = x.shape
    qkv = F.matmul(x, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    q, k, v = qkv.reshape(b, s, 3, num_heads, d // num_heads).unbind(dim=2)
    if attn_dropout_rate > 0.0 and training:
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
            training=True, generator=generator)
    else:
        if attn_mask is None and q.device.type == "cuda":
            path, why = attention_path(q.shape, k.shape, device=q.device)
            if path != "cuda":
                raise ValueError(
                    f"fused_multi_head_attention: B1 does not take this "
                    f"shape on the card: {why}")
        out = fused_flash_attention(q, k, v, attn_mask=attn_mask)
    out = F.matmul(out.reshape(b, s, d), linear_weight)
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, dropout_rate, training=training,
                    generator=generator)
    out = out + residual
    if not pre_layer_norm:
        out = fused_layer_norm(out, ln_scale, ln_bias, epsilon=epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, generator=None):
    """Fused feed-forward block (:214): optional pre-LN (B4), linear1,
    the activation (relu, gelu or silu), dropout, linear2, dropout, the
    residual, and post-LN (B4) unless pre_layer_norm."""
    residual = x
    if pre_layer_norm:
        x = fused_layer_norm(x, ln1_scale, ln1_bias, ln1_epsilon)
    x = F.matmul(x, linear1_weight)
    if linear1_bias is not None:
        x = x + linear1_bias
    x = getattr(F, activation)(x)
    x = F.dropout(x, dropout1_rate, training=training, generator=generator)
    x = F.matmul(x, linear2_weight)
    if linear2_bias is not None:
        x = x + linear2_bias
    x = F.dropout(x, dropout2_rate, training=training, generator=generator)
    x = x + residual
    if not pre_layer_norm:
        x = fused_layer_norm(x, ln2_scale, ln2_bias, ln2_epsilon)
    return x
