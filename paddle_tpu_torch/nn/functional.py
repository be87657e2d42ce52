"""The functional ops (counterparts of paddle_tpu/nn/functional, over
ops/nn_ops.py, ops/linalg.py and ops/manipulation.py), with the
reference's cast order kept. The convolutions, pools and batch norm are
in ``cnn_ops.py`` and re-exported here.

Each op applies the reference's AMP rule for its name and per-op policy
first (``amp.state.maybe_cast_inputs``; the policies are those of the
reference registry: linear, matmul and scaled_dot_product_attention are
white, layer_norm and cross_entropy black, the rest follow their
input; convolutions are white, batch_norm black, pools follow their
input).

``layer_norm`` and ``rms_norm`` here are the plain ops the model layers
call (nn_ops.py:490, :514), not the fused kernels B4/B5 of
``kernels/norms.py``, which only the incubate fused ops reach, as in
the reference."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..amp.state import maybe_cast_inputs as _amp
from ..kernels import norms as _norms
from ..kernels.flash_attention import _shapes_ok
from ..kernels.flash_attention import flash_attention as _flash
from ..ops.registry import register_op
from .cnn_ops import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool2d, avg_pool1d,
                      avg_pool2d, avg_pool3d, batch_norm, conv1d, conv2d,
                      conv2d_transpose, conv3d, conv3d_transpose, max_pool1d,
                      max_pool2d, max_pool3d)

__all__ = ["linear", "matmul", "embedding", "layer_norm", "rms_norm", "gelu",
           "relu", "silu", "tanh", "dropout", "cross_entropy", "flatten",
           "pad", "scaled_dot_product_attention", "flash_attention",
           "conv1d", "conv2d",
           "conv3d", "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool2d", "batch_norm"]


def _mm(x, y):
    """x @ y as the reference computes it (ops/linalg.py:22-31): mixed
    inputs promote as jnp.matmul promotes them (torch.matmul refuses
    them), f32 accumulation, and a low-precision x casts the product
    back to its own dtype."""
    dt = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(dt), y.to(dt))
    return out.to(x.dtype) if x.dtype in (torch.bfloat16, torch.float16) \
        else out


@register_op("linear", amp_policy="white", amp_in_fn=True)
def linear(x, weight, bias=None):
    """y = x @ W + b with W laid out [in, out], as paddle_tpu's Linear
    keeps it (nn/layers/common.py:12). bf16 products accumulate in f32
    and round once to bf16 before the bias, as ops/nn_ops.py:210 does."""
    x, weight, bias = _amp("linear", "white", x, weight, bias)
    out = _mm(x, weight)
    if bias is not None:
        out = out + bias
    return out


@register_op("matmul", amp_policy="white", amp_in_fn=True)
def matmul(x, y, transpose_x=False, transpose_y=False):
    """ops/linalg.py:22: optional transposes of the last two axes, then
    x @ y (bf16 products accumulate in f32 and round once)."""
    x, y = _amp("matmul", "white", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return _mm(x, y)


@register_op("embedding", amp_in_fn=True)
def embedding(x, weight, padding_idx=None, sparse=False):
    """The rows of `weight` at ids `x` (ops/nn_ops.py:222-227); the rows
    of ids equal to `padding_idx` are zeros (the product with a 0/1
    mask, so their gradient is zero too). `sparse` is taken and not
    used, as in the reference."""
    (weight,) = _amp("embedding", None, weight)
    out = weight[x]
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


@register_op("layer_norm", amp_policy="black", amp_in_fn=True)
def layer_norm(x, weight=None, bias=None, epsilon=1e-5,
               begin_norm_axis=None, normalized_shape=None):
    """LayerNorm over the axes from `begin_norm_axis` on (default: the
    last ``len(normalized_shape)`` axes, else the last one): the
    reference's off-TPU ``_ln_xla`` over those axes, f32 statistics, then
    a cast back to the input dtype BEFORE the affine
    (ops/nn_ops.py:491-510)."""
    x, weight, bias = _amp("layer_norm", "black", x, weight, bias)
    if begin_norm_axis is None:
        n = 1 if normalized_shape is None else (
            len(normalized_shape) if isinstance(
                normalized_shape, (list, tuple, torch.Size)) else 1)
        begin_norm_axis = x.dim() - n
    axes = tuple(range(begin_norm_axis, x.dim()))
    return _norms._ln_xla(x, weight, bias, epsilon, axes)


@register_op("rms_norm", amp_policy="black", amp_in_fn=True)
def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis (ops/nn_ops.py:514): rsqrt of the f32
    mean of squares, a cast back to the input dtype BEFORE the weight
    (the form of ``_rms_xla``)."""
    x, weight = _amp("rms_norm", "black", x, weight)
    return _norms._rms_xla(x, weight, epsilon)


@register_op("gelu", amp_in_fn=True)
def gelu(x, approximate=False):
    (x,) = _amp("gelu", None, x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


@register_op("relu", amp_in_fn=True)
def relu(x):
    (x,) = _amp("relu", None, x)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)      # jax.nn.relu's bool gives int32
    return torch.relu(x)


@register_op("silu", amp_in_fn=True)
def silu(x):
    """x * sigmoid(x) (ops/nn_ops.py:65)."""
    (x,) = _amp("silu", None, x)
    return torch.nn.functional.silu(x)


@register_op("tanh", amp_in_fn=True)
def tanh(x):
    """ops/math.py:224; no AMP policy of its own: it follows its input
    (tanh is on neither of the reference's lists)."""
    (x,) = _amp("tanh", None, x)
    return torch.tanh(x)


@register_op("dropout", amp_in_fn=True, random=True)
def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """ops/nn_ops.py:165: keep each element with probability 1 - p, drawn
    from `generator` (a torch.Generator on x's device; None draws from
    torch's default generator). The draws are torch's, not jax.random's,
    so a test compares dropout by its masks, never by seed."""
    (x,) = _amp("dropout", None, x)
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


@register_op("cross_entropy", amp_policy="black", amp_in_fn=True)
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """ops/nn_ops.py:657-724, branch for branch, in f32 (AMP black).

    Hard labels (class ids; a label with the input's rank is squeezed on
    `axis`): with softmax, loss = logsumexp(z) - z[label] with the
    logsumexp in f32 and the picked logit widened to f32, so no f32
    log-softmax of the whole class axis is materialised; label smoothing
    mixes the picked logit with the mean logit. Without softmax the
    input is taken as probabilities: -log(max(p[label], 1e-30)), mixed
    with the mean log-probability under smoothing. Labels equal to
    `ignore_index` give 0; `weight` ([classes]) scales each token's loss
    by its class's weight. "mean" divides by the count of valid tokens
    (at least 1), or by their weights' sum (at least 1e-12) with
    `weight`.

    Soft labels (a distribution per token): -sum(label * log p) with
    log p the f32 log-softmax (or log(max(p, 1e-30)) without softmax),
    the labels smoothed toward uniform first; `weight` and
    `ignore_index` are unused and "mean" is the plain mean, as in the
    reference. reduction: "mean" | "sum" | "none"."""
    input, label, weight = _amp("cross_entropy", "black", input, label,
                                weight)
    valid = w_tok = None
    if soft_label:
        if use_softmax:
            logp = torch.log_softmax(input.float(), dim=axis)
        else:
            logp = torch.log(torch.clamp_min(input.float(), 1e-30))
        lbl = label.float()
        if label_smoothing > 0:
            lbl = lbl * (1 - label_smoothing) \
                + label_smoothing / input.shape[axis]
        loss = -(lbl * logp).sum(axis)
    else:
        lbl = label
        if lbl.dim() == input.dim():
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0).unsqueeze(axis)
        if use_softmax:
            lse = torch.logsumexp(input.float(), dim=axis)
            picked = input.gather(axis, safe).squeeze(axis).float()
            if label_smoothing > 0:
                picked = (1 - label_smoothing) * picked \
                    + label_smoothing * input.float().mean(axis)
            loss = torch.where(valid, lse - picked, 0.0)
        else:
            logp = torch.log(torch.clamp_min(input.float(), 1e-30))
            picked = logp.gather(axis, safe).squeeze(axis)
            if label_smoothing > 0:
                picked = (1 - label_smoothing) * picked \
                    + label_smoothing * logp.mean(axis)
            loss = torch.where(valid, -picked, 0.0)
        if weight is not None:
            w_tok = torch.where(valid, weight[safe.squeeze(axis)], 0.0)
            loss = loss * w_tok
    if reduction == "mean":
        if valid is None:
            return loss.mean()
        denom = w_tok.sum().clamp_min(1e-12) if w_tok is not None \
            else valid.float().sum().clamp_min(1.0)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


@register_op("flatten", amp_in_fn=True)
def flatten(x, start_axis=0, stop_axis=-1):
    """ops/manipulation.py:35: axes start_axis..stop_axis merged into
    one (a 0-d tensor becomes shape [1])."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


@register_op("pad_op", amp_in_fn=True)
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """ops/manipulation.py:276-298. `pad` of 2 * x.dim() values pads
    every axis, first axis first: [lo0, hi0, lo1, hi1, ...] (the reverse
    of ``torch.nn.functional.pad``'s order). A shorter `pad` pads the
    trailing spatial axes (the leading ones after the batch axis for a
    channels-last `data_format`), last axis first, as
    torch.nn.functional.pad orders it. mode: "constant" (`value`),
    "reflect", "replicate" or "circular", as numpy.pad's "reflect",
    "edge" and "wrap" take them (each padded axis gathered by the index
    numpy.pad gives)."""
    pad = [int(v) for v in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        k = len(pad) // 2
        if data_format.endswith("C"):
            spatial = list(range(1, 1 + k))
        else:
            spatial = list(range(nd - k, nd))
        for i, d in enumerate(spatial[::-1]):
            width[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        return torch.nn.functional.pad(
            x, [v for lo, hi in reversed(width) for v in (lo, hi)],
            value=value)
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi),
                         mode=_PAD_MODES[mode])
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


def _sdpa_takes_kernel(q_shape, k_shape, attn_mask, dropout_p, training):
    """nn_ops.py:869-874's test for sending an SDPA call to the flash
    kernels, less its device check: no mask, no live dropout, and shapes
    the kernels take."""
    return attn_mask is None and (dropout_p == 0.0 or not training) \
        and _shapes_ok(q_shape, k_shape)


@register_op("scaled_dot_product_attention", amp_policy="white", amp_in_fn=True, random=True)
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention on the paddle layout [batch, seq, heads, head_dim]
    (ops/nn_ops.py:862).

    On CUDA tensors an eligible call — no mask, no live dropout, shapes
    the kernels take — goes to the flash-attention kernels, as the
    reference sends it to its TPU kernel (nn_ops.py:869-874). Otherwise
    the plain composite of nn_ops.py:875-899 runs: f32 scores, an
    optional bottom-right-aligned causal mask, a boolean or additive
    mask, f32 softmax cast back to the query dtype, dropout of the
    probabilities (drawn from `generator`), then probs @ v."""
    query, key, value, attn_mask = _amp(
        "scaled_dot_product_attention", "white", query, key, value,
        attn_mask)
    if query.device.type == "cuda" and _sdpa_takes_kernel(
            query.shape, key.shape, attn_mask, dropout_p, training):
        return _flash(query, key, value, causal=is_causal)
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
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(q.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2)                           # [b, s, h, d]


@register_op("flash_attention", amp_in_fn=True)
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, name=None,
                    segment_ids=None):
    """The reference's API (nn/functional/__init__.py:114): attention on
    [batch, seq, heads, head_dim] through ``fused_flash_attention``, so
    the kernels B1/B2 on the card and their plain form on the CPU.
    Returns (out, None): the softmax is never materialised. key/value
    may carry fewer heads (GQA/MQA); ``segment_ids=(q_seg, kv_seg)``
    masks attention to equal ids."""
    from ..incubate.nn.functional import fused_flash_attention
    out = fused_flash_attention(query, key, value, causal=causal,
                                dropout=dropout, training=training,
                                segment_ids=segment_ids)
    return out, None
