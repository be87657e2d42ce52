"""Fused functional ops (counterpart of
paddle_tpu/incubate/nn/functional/__init__.py): the fused norms, which
reach the kernels B4 (layer norm) and B5 (RMS norm), rotary position
embedding, flash attention (B1/B2), the fused linear, activation,
softmax, dropout and attention ops, and the fused attention and
feed-forward blocks the fused layers are built from. The serving family
(masked / block multi-head attention, the variable-length attention,
``fused_multi_transformer``) is in ``serving.py``.

The ops the reference registers are registered ops here too, under its
names and AMP policies (fused_rms_norm, fused_layer_norm,
fused_bias_dropout_residual_layer_norm and the softmax-mask ops black;
fused_flash_attention, fused_linear, fused_linear_activation, swiglu,
fused_matmul_bias, fused_dot_product_attention, fused_ec_moe and
fused_gate_attention white; the rest follow their inputs): they take
the eager API's Tensors, and a call with torch tensors runs the body
directly. Each body applies its AMP rule itself (``amp_in_fn``), so a
Tensor call is cast once. ``fused_multi_head_attention`` and
``fused_feedforward``, plain functions in the reference, take Tensors
through ``eager_function``.

Dropout draws from a ``torch.Generator`` (a Tensor call without one:
the eager generator of the inputs' device; a torch-level call: torch's
default generator); the reference's jax.random ``key`` becomes
``generator``. Where the reference calls ``jax.nn.gelu`` directly
(fused_linear_activation, fused_bias_act, fused_ec_moe) it is the tanh
approximation, as jax's default."""
from __future__ import annotations

import math
import warnings

import torch

from ....amp.state import maybe_cast_inputs as _amp
from ....kernels import norms as _norms
from ....kernels.flash_attention import attention_path, flash_attention
from ....nn import functional as F
from ....ops.registry import eager_function, register_op
from .serving import _act

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding", "fused_flash_attention",
           "fused_multi_head_attention", "fused_feedforward",
           "fused_linear", "fused_linear_activation", "swiglu",
           "fused_dropout_add", "fused_softmax_mask",
           "fused_softmax_mask_upper_triangle", "fused_bias_act",
           "fused_matmul_bias", "fused_dot_product_attention",
           "fused_ec_moe", "fused_gate_attention",
           "masked_multihead_attention", "block_multihead_attention",
           "fused_multi_transformer",
           "variable_length_memory_efficient_attention"]


@register_op("fused_rms_norm", amp_policy="black", amp_in_fn=True)
def fused_rms_norm(x, weight=None, epsilon=1e-6):
    """RMS norm over the last axis through B5 (:18): the CUDA kernel on
    the card, the reference's off-TPU form on the CPU. An AMP-black op."""
    x, weight = _amp("fused_rms_norm", "black", x, weight)
    return _norms.rms_norm(x, weight, epsilon)


@register_op("fused_layer_norm", amp_policy="black", amp_in_fn=True)
def fused_layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the last axis through B4 (:23). AMP-black."""
    x, weight, bias = _amp("fused_layer_norm", "black", x, weight, bias)
    return _norms.layer_norm(x, weight, bias, epsilon)


@register_op("fused_rotary_position_embedding", amp_in_fn=True)
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


@register_op("fused_flash_attention", amp_policy="white", amp_in_fn=True)
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


@register_op("fused_bias_dropout_residual_layer_norm", amp_policy="black",
             amp_in_fn=True, random=True)
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


@eager_function(random=True)
def fused_multi_head_attention(x, qkv_weight, qkv_bias, linear_weight,
                               linear_bias, num_heads, pre_layer_norm=False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, training=True,
                               epsilon=1e-5, *, generator=None):
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


@eager_function(random=True)
def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, *,
                      generator=None):
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


@register_op("fused_linear", amp_policy="white", amp_in_fn=True)
def fused_linear(x, weight, bias=None, transpose_weight=False):
    """x @ weight (+ bias) (:104); `transpose_weight` reverses weight's
    axes first. An AMP-white op."""
    x, weight, bias = _amp("fused_linear", "white", x, weight, bias)
    if transpose_weight:
        weight = weight.permute(*reversed(range(weight.dim())))
    out = F._mm(x, weight)
    if bias is not None:
        out = out + bias
    return out


@register_op("fused_linear_activation", amp_policy="white", amp_in_fn=True)
def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """act(x @ y + bias) (:117): gelu (tanh approximation) or relu; any
    other name returns the product. An AMP-white op."""
    x, y, bias = _amp("fused_linear_activation", "white", x, y, bias)
    if trans_x:
        x = x.transpose(-1, -2)
    if trans_y:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(dt), y.to(dt))
    if bias is not None:
        out = out + bias
    if activation in ("gelu", "relu"):
        return _act(activation, out)
    return out


@register_op("swiglu", amp_policy="white", amp_in_fn=True)
def swiglu(x, y=None):
    """silu(x) * y (:150); with one argument its last axis is split in
    two halves, x and y."""
    x, y = _amp("swiglu", "white", x, y)
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return torch.nn.functional.silu(x) * y


def _dropout_keep(x, p, generator):
    return torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p


@register_op("fused_dropout_add", amp_in_fn=True, random=True)
def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator=None):
    """dropout(x) + y (:158), paddle's two modes: upscale_in_train
    scales kept values by 1 / (1 - p) in training; downscale_in_infer
    keeps them unscaled and multiplies by 1 - p at inference."""
    x, y = _amp("fused_dropout_add", None, x, y)
    if training and p > 0.0:
        kept = x / (1.0 - p) if mode == "upscale_in_train" else x
        x = torch.where(_dropout_keep(x, p, generator), kept,
                        0.0).to(x.dtype)
    elif not training and mode == "downscale_in_infer":
        x = (x * (1.0 - p)).to(x.dtype)
    return x + y


@register_op("fused_softmax_mask", amp_policy="black", amp_in_fn=True)
def fused_softmax_mask(x, mask):
    """softmax(x + mask) over the last axis in f32, cast to x's dtype
    (:240). x [b, h, s_q, s_k], mask broadcastable."""
    x, mask = _amp("fused_softmax_mask", "black", x, mask)
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


@register_op("fused_softmax_mask_upper_triangle", amp_policy="black",
             amp_in_fn=True)
def fused_softmax_mask_upper_triangle(x):
    """softmax with the strictly upper triangle masked out (-1e30), the
    causal score softmax (:251). x [b, h, s, s]."""
    (x,) = _amp("fused_softmax_mask_upper_triangle", "black", x)
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    z = torch.where(keep, x.float(), -1e30)
    return torch.softmax(z, dim=-1).to(x.dtype)


@register_op("fused_bias_act", amp_in_fn=True)
def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu",
                   compute_dtype="default", quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """act(x + bias) in f32, cast to x's dtype (:262): gelu (tanh
    approximation), relu, silu / swish, or the gated geglu / swiglu over
    the two halves of the last axis. The quant arguments raise, as in
    the reference."""
    if any(v is not None for v in (dequant_scales, shift, smooth)) or \
            quant_scale != -1:
        raise NotImplementedError(
            "fused_bias_act quant arguments are not supported (int8 "
            "serving quant is a documented exclusion)")
    x, bias = _amp("fused_bias_act", None, x, bias)
    h = x if bias is None else x + bias
    return _act(act_method, h.float()).to(x.dtype)


@register_op("fused_matmul_bias", amp_policy="white", amp_in_fn=True)
def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False):
    """x @ y + bias in one op (:292), bf16/f16 products accumulated in
    f32 and cast to x's dtype. An AMP-white op."""
    x, y, bias = _amp("fused_matmul_bias", "white", x, y, bias)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = F._mm(x, y)
    if bias is not None:
        out = out + bias
    return out


@register_op("fused_dot_product_attention", amp_policy="white",
             amp_in_fn=True, random=True)
def fused_dot_product_attention(q, k, v, mask=None, scaling_factor=None,
                                dropout_prob=0.0, is_training=True,
                                is_causal_masking=False,
                                return_softmax=False, generator=None):
    """Attention on [b, s, h, d] in f32 (:311): an int or bool `mask`
    keeps the positions where it is nonzero, `is_causal_masking` the
    bottom-right-aligned lower triangle (masked scores -1e30), dropout
    of the probabilities drawn from `generator`, the output cast to q's
    dtype. return_softmax raises, as in the reference."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax: the fused path never materializes the "
            "probability matrix (flash-style)")
    q, k, v = _amp("fused_dot_product_attention", "white", q, k, v)
    d = q.shape[-1]
    scale = scaling_factor if scaling_factor is not None \
        else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask.bool(), s, -1e30)
    if is_causal_masking:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=s.device).tril(sk - sq)
        s = torch.where(cm, s, -1e30)
    p = torch.softmax(s, dim=-1)
    if dropout_prob > 0.0 and is_training:
        p = torch.where(_dropout_keep(p, dropout_prob, generator),
                        p / (1.0 - dropout_prob), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


@register_op("fused_ec_moe", amp_policy="white", amp_in_fn=True)
def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
                 bmm1_bias, act_type="gelu", _bmm1_layout=None):
    """Soft expert-choice MoE FFN (:344): every token mixes all experts'
    FFN outputs by its softmaxed gate, in f32, cast to x's dtype.
    x [b, s, dm]; gate [b, s, e]; bmm0 [e, dm, ff]; bmm1 [e, ff, dm]
    (an [e, dm, ff] bmm1 is taken too, contracted over ff); act gelu
    (tanh approximation) or relu. `_bmm1_layout` ("efd" / "edf") names
    the layout and skips the shape rule and its ambiguity warning."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("fused_ec_moe supports act_type gelu|relu")
    x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias = _amp(
        "fused_ec_moe", "white", x, gate, bmm0_weight, bmm0_bias,
        bmm1_weight, bmm1_bias)
    e, dm, ff = bmm0_weight.shape
    h = torch.einsum("bsd,edf->besf", x.float(), bmm0_weight.float())
    h = _act(act_type, h + bmm0_bias.float().reshape(1, e, 1, -1))
    w1 = bmm1_weight.float()
    if _bmm1_layout not in (None, "efd", "edf"):
        raise ValueError("_bmm1_layout must be 'efd' or 'edf'")
    layout = _bmm1_layout or ("efd" if w1.shape[1] == ff else "edf")
    if _bmm1_layout is None and w1.shape[1] == ff and ff == dm:
        warnings.warn(
            "fused_ec_moe: inter_size == d_model makes the "
            "bmm1_weight layout ambiguous; assuming the canonical "
            "[num_experts, d_ff, d_model] layout. Pass a weight in "
            "that layout to silence this warning.", stacklevel=2)
    if layout == "efd":
        out = torch.einsum("besf,efd->besd", h, w1)
    else:
        out = torch.einsum("besf,edf->besd", h, w1)
    out = out + bmm1_bias.float().reshape(1, e, 1, -1)
    probs = torch.softmax(gate.float(), dim=-1)
    return torch.einsum("bse,besd->bsd", probs, out).to(x.dtype)


@register_op("fused_gate_attention", amp_policy="white", amp_in_fn=True)
def fused_gate_attention(query, key=None, query_weight=None,
                         key_weight=None, value_weight=None,
                         qkv_weight=None, gate_linear_weight=None,
                         gate_linear_bias=None, out_linear_weight=None,
                         out_linear_bias=None, nonbatched_bias=None,
                         attn_mask=None, has_gating=True,
                         merge_qkv=True, use_flash_attn=False):
    """AlphaFold-style gated attention (:385), einsum for einsum in f32,
    cast to the query's dtype. query [n, b, q, qdim]; merged qkv_weight
    [3, heads, head_dim, qdim]; separate weights [qdim, heads,
    head_dim]; attn_mask and nonbatched_bias additive."""
    (query, key, query_weight, key_weight, value_weight, qkv_weight,
     gate_linear_weight, gate_linear_bias, out_linear_weight,
     out_linear_bias, nonbatched_bias, attn_mask) = _amp(
        "fused_gate_attention", "white", query, key, query_weight,
        key_weight, value_weight, qkv_weight, gate_linear_weight,
        gate_linear_bias, out_linear_weight, out_linear_bias,
        nonbatched_bias, attn_mask)
    qd = query.float()
    kd = qd if key is None else key.float()
    if merge_qkv:
        if qkv_weight is None:
            raise ValueError("merge_qkv=True requires qkv_weight")
        c = qkv_weight.shape[2] ** -0.5
        qkv = torch.einsum("nbqa,thca->tnbqhc", qd, qkv_weight.float())
        q, k, v = qkv[0] * c, qkv[1], qkv[2]
    else:
        c = query_weight.shape[-1] ** -0.5
        q = torch.einsum("nbqa,ahc->nbqhc", qd, query_weight.float()) * c
        k = torch.einsum("nbka,ahc->nbkhc", kd, key_weight.float())
        v = torch.einsum("nbka,ahc->nbkhc", kd, value_weight.float())
    logits = torch.einsum("nbqhc,nbkhc->nbhqk", q, k)
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    if nonbatched_bias is not None:
        logits = logits + nonbatched_bias.float().unsqueeze(1)
    weights = torch.softmax(logits, dim=-1)
    avg = torch.einsum("nbhqk,nbkhc->nbqhc", weights, v)
    if has_gating:
        gate = torch.einsum("nbqa,ahc->nbqhc", qd,
                            gate_linear_weight.float())
        avg = avg * torch.sigmoid(gate + gate_linear_bias.float())
    out = torch.einsum("nbqhc,hco->nbqo", avg, out_linear_weight.float())
    out = out + out_linear_bias.float()
    return out.to(query.dtype)


# the serving / decode family (reference: incubate/nn/functional/
# serving.py)
from .serving import (  # noqa: E402
    block_multihead_attention, fused_multi_transformer,
    masked_multihead_attention, variable_length_memory_efficient_attention)
