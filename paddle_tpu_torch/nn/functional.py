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
the reference.

The rest of the reference's nn ops (activations, the softmax family,
the dropouts, ``one_hot``, group / instance / local-response norm, the
losses, ``bilinear``) and ``nn.functional``'s own functions
(``cosine_similarity``, ``normalize``, ``sequence_mask``, ``softmax_``,
``flash_attn_unpadded``, ``rnnt_loss`` over ``rnnt_loss_op``) follow,
each the reference's function op for op; the spatial ones
(``interpolate``, the shuffles, ``grid_sample``, ...) are in
``cnn_ops.py``. A random op takes a ``generator`` (a torch.Generator on
the input's device) where the reference takes ``key``."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..amp.state import maybe_cast_inputs as _amp
from ..kernels import norms as _norms
from ..kernels.flash_attention import _shapes_ok
from ..kernels.flash_attention import flash_attention as _flash
from ..ops.registry import register_op
from ..core.dtype import to_dtype
from ..core.tensor import NARROW
from .cnn_ops import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, affine_grid,
                      avg_pool1d, avg_pool2d, avg_pool3d, batch_norm,
                      channel_shuffle, conv1d, conv2d, conv2d_transpose,
                      conv3d, conv3d_transpose, fold, grid_sample,
                      interpolate, max_pool1d, max_pool2d, max_pool3d,
                      pixel_shuffle, pixel_unshuffle, temporal_shift,
                      unfold_im2col, unpool, upsample)

__all__ = ["linear", "matmul", "embedding", "layer_norm", "rms_norm", "gelu",
           "relu", "silu", "tanh", "sigmoid", "logsigmoid", "dropout",
           "cross_entropy", "flatten", "pad", "scaled_dot_product_attention", "flash_attention",
           "conv1d", "conv2d",
           "conv3d", "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool2d", "batch_norm",
           # the rest of the reference's nn ops
           "relu6", "leaky_relu", "prelu", "elu", "selu", "celu", "swish",
           "mish", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
           "softshrink", "tanhshrink", "softplus", "softsign",
           "thresholded_relu", "maxout", "glu", "rrelu", "softmax",
           "log_softmax", "gumbel_softmax", "dropout2d", "alpha_dropout",
           "one_hot", "group_norm", "instance_norm", "local_response_norm",
           "mse_loss", "l1_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "nll_loss", "binary_cross_entropy",
           "bce_loss", "binary_cross_entropy_with_logits",
           "sigmoid_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "log_loss", "huber_loss", "label_smooth",
           "npair_loss", "hsigmoid_loss", "margin_cross_entropy", "bilinear",
           "adaptive_max_pool1d", "adaptive_max_pool3d", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "interpolate", "upsample",
           "unfold_im2col", "unfold", "fold", "unpool", "temporal_shift",
           "affine_grid",
           # nn.functional's own
           "cosine_similarity", "normalize", "grid_sample", "sequence_mask",
           "softmax_", "flash_attn_unpadded", "rnnt_loss", "rnnt_loss_op"]

unfold = unfold_im2col


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


@register_op("sigmoid")
def sigmoid(x):
    """ops/math.py:314, kept here so nn.functional re-exports it as the
    reference's does."""
    return torch.sigmoid(x)


@register_op("logsigmoid")
def logsigmoid(x):
    """ops/math.py:326, kept here as ``sigmoid`` is."""
    return torch.nn.functional.logsigmoid(x)


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


# ---------------------------------------------------------------------------
# activations (ops/nn_ops.py:23-147)
# ---------------------------------------------------------------------------
def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("relu6", amp_in_fn=True)
def relu6(x):
    (x,) = _amp("relu6", None, x)
    return torch.nn.functional.relu6(x)


@register_op("leaky_relu", amp_in_fn=True)
def leaky_relu(x, negative_slope=0.01):
    """x where x >= 0, else negative_slope * x (jax.nn.leaky_relu)."""
    (x,) = _amp("leaky_relu", None, x)
    return torch.where(x >= 0, x, negative_slope * x)


@register_op("prelu", amp_in_fn=True)
def prelu(x, weight, data_format="NCHW"):
    """x where x > 0, else weight * x; a weight of more than one element
    is laid along the channel axis (1, or the last for "NHWC")."""
    x, weight = _amp("prelu", None, x, weight)
    w = weight
    if w.dim() == 1 and x.dim() > 1 and w.shape[0] > 1:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@register_op("elu", amp_in_fn=True)
def elu(x, alpha=1.0):
    """jax.nn.elu: alpha * expm1(x) below 0, its argument clamped to
    <= 0 so the unused branch stays finite."""
    (x,) = _amp("elu", None, x)
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, 0.0, x)))


@register_op("selu", amp_in_fn=True)
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    (x,) = _amp("selu", None, x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("celu", amp_in_fn=True)
def celu(x, alpha=1.0):
    """jax.nn.celu: max(x, 0) + alpha * expm1(min(x, 0) / alpha)."""
    (x,) = _amp("celu", None, x)
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


swish = silu


@register_op("mish", amp_in_fn=True)
def mish(x):
    (x,) = _amp("mish", None, x)
    return x * torch.tanh(_softplus(x))


@register_op("hardswish", amp_in_fn=True)
def hardswish(x):
    (x,) = _amp("hardswish", None, x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@register_op("hardsigmoid", amp_in_fn=True)
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    (x,) = _amp("hardsigmoid", None, x)
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@register_op("hardtanh", amp_in_fn=True)
def hardtanh(x, min=-1.0, max=1.0):
    (x,) = _amp("hardtanh", None, x)
    return torch.clamp(x, min, max)


@register_op("hardshrink", amp_in_fn=True)
def hardshrink(x, threshold=0.5):
    (x,) = _amp("hardshrink", None, x)
    return torch.where(x.abs() > threshold, x, 0.0)


@register_op("softshrink", amp_in_fn=True)
def softshrink(x, threshold=0.5):
    (x,) = _amp("softshrink", None, x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


@register_op("tanhshrink", amp_in_fn=True)
def tanhshrink(x):
    (x,) = _amp("tanhshrink", None, x)
    return x - torch.tanh(x)


@register_op("softplus", amp_in_fn=True)
def softplus(x, beta=1.0, threshold=20.0):
    """x where beta * x > threshold, else softplus(beta * x) / beta."""
    (x,) = _amp("softplus", None, x)
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


@register_op("softsign", amp_in_fn=True)
def softsign(x):
    (x,) = _amp("softsign", None, x)
    return x / (x.abs() + 1)


@register_op("thresholded_relu", amp_in_fn=True)
def thresholded_relu(x, threshold=1.0, value=0.0):
    (x,) = _amp("thresholded_relu", None, x)
    return torch.where(x > threshold, x, value)


@register_op("maxout", amp_in_fn=True)
def maxout(x, groups, axis=1):
    """The channel axis split into [c // groups, groups], the max over
    each group."""
    (x,) = _amp("maxout", None, x)
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [x.shape[axis] // groups, groups]
    return x.reshape(shape).amax(axis + 1)


@register_op("glu", amp_in_fn=True)
def glu(x, axis=-1):
    """a * sigmoid(b), a and b the halves of `axis`."""
    (x,) = _amp("glu", None, x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@register_op("rrelu", amp_in_fn=True, random=True)
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True,
          generator=None):
    """Randomized leaky ReLU (nn_ops.py:1075): in training each negative
    element's slope is drawn from U(lower, upper) (f32 draws cast to x's
    dtype, from `generator`); in eval the slope is their mean."""
    (x,) = _amp("rrelu", None, x)
    if not training:
        return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device
                        ).uniform_(lower, upper, generator=generator)
    return torch.where(x >= 0, x, x * slope.to(x.dtype))


# ---------------------------------------------------------------------------
# softmax family (nn_ops.py:133-160)
# ---------------------------------------------------------------------------
@register_op("softmax", amp_policy="black", amp_in_fn=True)
def softmax(x, axis=-1):
    (x,) = _amp("softmax", "black", x)
    return torch.softmax(x, dim=axis)


@register_op("log_softmax", amp_policy="black", amp_in_fn=True)
def log_softmax(x, axis=-1):
    (x,) = _amp("log_softmax", "black", x)
    return torch.log_softmax(x, dim=axis)


@register_op("gumbel_softmax", amp_in_fn=True, random=True)
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, *,
                   generator=None):
    """softmax((x + g) / temperature) with g Gumbel noise in x's dtype,
    -log(-log(u)) of u uniform in [tiny, 1) as jax.random.gumbel draws it
    (from `generator`). `hard`: the one-hot of the argmax forward, the
    soft sample's gradient backward (straight-through)."""
    (x,) = _amp("gumbel_softmax", None, x)
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        torch.finfo(x.dtype).tiny, 1.0, generator=generator)
    return _gumbel_softmax(x, -torch.log(-torch.log(u)), temperature, hard,
                           axis)


def _gumbel_softmax(x, g, temperature, hard, axis):
    """gumbel_softmax on the noise `g` given (the draw-free part)."""
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


# ---------------------------------------------------------------------------
# dropouts and one_hot (nn_ops.py:178-230)
# ---------------------------------------------------------------------------
@register_op("dropout2d", amp_in_fn=True, random=True)
def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole channels dropped: one keep draw per (batch, channel),
    upscaled by 1 / (1 - p)."""
    (x,) = _amp("dropout2d", None, x)
    if not training or p == 0.0:
        return x
    mshape = tuple(x.shape[:2]) + (1, 1) if data_format == "NCHW" \
        else (x.shape[0], 1, 1, x.shape[3])
    keep = torch.rand(mshape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


@register_op("alpha_dropout", amp_in_fn=True, random=True)
def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU-preserving dropout: dropped elements take -alpha * scale,
    then the affine a * x + b keeps the mean and variance."""
    (x,) = _amp("alpha_dropout", None, x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    a = (1.0 / (1.0 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


@register_op("one_hot", amp_in_fn=True)
def one_hot(x, num_classes):
    """f32 one-hot rows; an id outside [0, num_classes) gives a row of
    zeros, as jax.nn.one_hot does."""
    return (x.unsqueeze(-1) == torch.arange(
        num_classes, device=x.device)).to(torch.float32)


# ---------------------------------------------------------------------------
# group, instance and local response norm (nn_ops.py:575-625)
# ---------------------------------------------------------------------------
def _moments(x32, axes):
    return x32.mean(axes, keepdim=True), x32.var(axes, unbiased=False,
                                                keepdim=True)


@register_op("group_norm", amp_policy="black", amp_in_fn=True)
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Channels in `num_groups` groups, each normalised over its channels
    and the spatial axes in f32, cast back to x's dtype before the
    per-channel affine."""
    x, weight, bias = _amp("group_norm", "black", x, weight, bias)
    channel_last = data_format[-1] == "C" and x.dim() > 2
    x_ = torch.movedim(x, -1, 1) if channel_last else x
    n, c, rest = x_.shape[0], x_.shape[1], tuple(x_.shape[2:])
    xg = x_.reshape((n, num_groups, c // num_groups) + rest).float()
    mean, var = _moments(xg, tuple(range(2, xg.dim())))
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(
        x_.shape).to(x.dtype)
    shape = [1, c] + [1] * len(rest)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return torch.movedim(out, 1, -1) if channel_last else out


@register_op("instance_norm", amp_policy="black", amp_in_fn=True)
def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Each (batch, channel) normalised over its spatial axes in f32."""
    x, weight, bias = _amp("instance_norm", "black", x, weight, bias)
    mean, var = _moments(x.float(), tuple(range(2, x.dim())))
    out = ((x.float() - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_op("local_response_norm", amp_in_fn=True)
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """x / (k + alpha * s) ** beta, s the sum of squares over `size`
    neighbouring channels (size // 2 before, the rest after), summed
    window row by window row as the reference does."""
    (x,) = _amp("local_response_norm", None, x)
    half, c = size // 2, x.shape[1]
    pad = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    sq = torch.nn.functional.pad(torch.square(x), pad)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq.narrow(1, i, c)
    return x / torch.pow(k + alpha * acc, beta)


# ---------------------------------------------------------------------------
# losses (nn_ops.py:628-860, :1044-1159)
# ---------------------------------------------------------------------------
def _reduce(x, reduction):
    """mean, sum, or (any other value) the elements as they are."""
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


@register_op("mse_loss", amp_in_fn=True)
def mse_loss(input, label, reduction="mean"):
    input, label = _amp("mse_loss", None, input, label)
    return _reduce(torch.square(input - label), reduction)


@register_op("l1_loss", amp_in_fn=True)
def l1_loss(input, label, reduction="mean"):
    input, label = _amp("l1_loss", None, input, label)
    return _reduce((input - label).abs(), reduction)


@register_op("smooth_l1_loss", amp_in_fn=True)
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    input, label = _amp("smooth_l1_loss", None, input, label)
    d = input - label
    out = torch.where(d.abs() < delta, 0.5 * d * d / delta,
                      d.abs() - 0.5 * delta)
    return _reduce(out, reduction)


@register_op("softmax_with_cross_entropy", amp_policy="black",
             amp_in_fn=True)
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """-log_softmax at the label (kept as an axis of size 1; 0 where the
    label is ignore_index), or -sum(label * log_softmax) for soft
    labels, in logits' dtype; with the softmax when asked."""
    logits, label = _amp("softmax_with_cross_entropy", "black", logits,
                         label)
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        lbl = label.squeeze(axis) if label.dim() == logp.dim() else label
        lbl = lbl.long()
        valid = (lbl != ignore_index).unsqueeze(axis)
        safe = torch.where(lbl != ignore_index, lbl, 0).unsqueeze(axis)
        loss = torch.where(valid, -logp.gather(axis, safe), 0.0)
    loss = loss.to(logits.dtype)
    if return_softmax:
        return loss, torch.exp(logp).to(logits.dtype)
    return loss


@register_op("nll_loss", amp_policy="black", amp_in_fn=True)
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """-input[i, label[i]] over [N, C] log-probabilities; ignored labels
    give 0; with `weight`, "mean" divides by the valid labels' weights."""
    input, label, weight = _amp("nll_loss", "black", input, label, weight)
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = torch.where(valid, -input.gather(1, safe[:, None])[:, 0], 0.0)
    if weight is not None:
        w = torch.where(valid, weight[safe], 0.0)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


@register_op("binary_cross_entropy", amp_policy="black", amp_in_fn=True)
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """-(y log p + (1 - y) log(1 - p)), each log's argument at least
    1e-12."""
    input, label, weight = _amp("binary_cross_entropy", "black", input,
                                label, weight)
    eps = 1e-12
    out = -(label * torch.log(torch.clamp_min(input, eps))
            + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def bce_loss(input, label, weight=None, reduction="mean"):
    """The reference's alias of binary_cross_entropy."""
    return binary_cross_entropy(input, label, weight=weight,
                                reduction=reduction)


@register_op("binary_cross_entropy_with_logits", amp_policy="black",
             amp_in_fn=True)
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """BCE on f32 logits in the reference's stable forms, with and
    without `pos_weight`."""
    logit, label, weight, pos_weight = _amp(
        "binary_cross_entropy_with_logits", "black", logit, label, weight,
        pos_weight)
    logit = logit.float()
    max_val = torch.clamp_min(-logit, 0.0)
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        out = (1 - label) * logit + log_w * (
            torch.log(1 + torch.exp(-logit.abs())) + max_val)
    else:
        out = (1 - label) * logit + max_val + torch.log(
            torch.exp(-max_val) + torch.exp(-logit - max_val))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


@register_op("sigmoid_cross_entropy_with_logits", amp_policy="black",
             amp_in_fn=True)
def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    """Elementwise BCE on f32 logits; labels equal to ignore_index give
    0, and `normalize` divides by the count of the others (at least 1)."""
    x, label = _amp("sigmoid_cross_entropy_with_logits", "black", x, label)
    x32 = x.float()
    loss = torch.clamp_min(x32, 0.0) - x32 * label + torch.log1p(
        torch.exp(-x32.abs()))
    valid = label != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if normalize:
        loss = loss / valid.float().sum().clamp_min(1.0)
    return loss


@register_op("kl_div", amp_policy="black", amp_in_fn=True)
def kl_div(input, label, reduction="mean", log_target=False):
    """label * (log label - input) (label at least 1e-30 in the log), or
    exp(label) * (label - input) for a log target; "batchmean" divides
    the sum by the batch."""
    input, label = _amp("kl_div", "black", input, label)
    if log_target:
        out = torch.exp(label) * (label - input)
    else:
        out = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


@register_op("margin_ranking_loss", amp_in_fn=True)
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    input, other, label = _amp("margin_ranking_loss", None, input, other,
                               label)
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


@register_op("hinge_embedding_loss", amp_in_fn=True)
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    input, label = _amp("hinge_embedding_loss", None, input, label)
    out = torch.where(label == 1.0, input,
                      torch.clamp_min(margin - input, 0.0))
    return _reduce(out, reduction)


def _l2(x, axis):
    """sqrt(sum(x * x)) over `axis` (jnp.linalg.norm of a vector)."""
    return torch.sqrt((x * x).sum(axis))


@register_op("cosine_embedding_loss", amp_in_fn=True)
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    """1 - cos for label 1, max(0, cos - margin) otherwise; cos over the
    last axis with 1e-12 added to the norms' product."""
    input1, input2, label = _amp("cosine_embedding_loss", None, input1,
                                 input2, label)
    cos = (input1 * input2).sum(-1) / (_l2(input1, -1) * _l2(input2, -1)
                                       + 1e-12)
    out = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                           0.0))
    return _reduce(out, reduction)


@register_op("triplet_margin_loss", amp_in_fn=True)
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    """max(d(a, p) - d(a, n) + margin, 0), d the p-norm of |a - b| +
    epsilon over the last axis; `swap` takes the smaller of d(a, n) and
    d(p, n)."""
    input, positive, negative = _amp("triplet_margin_loss", None, input,
                                     positive, negative)

    def dist(a, b):
        return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1),
                         1.0 / p)

    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(dist(input, positive) - d_neg + margin,
                                   0.0), reduction)


@register_op("square_error_cost", amp_in_fn=True)
def square_error_cost(input, label):
    input, label = _amp("square_error_cost", None, input, label)
    return torch.square(input - label)


@register_op("log_loss", amp_in_fn=True)
def log_loss(input, label, epsilon=1e-4):
    input, label = _amp("log_loss", None, input, label)
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(
        1 - input + epsilon)


@register_op("huber_loss", amp_policy="black", amp_in_fn=True)
def huber_loss(input, label, delta=1.0, reduction="mean"):
    """0.5 d^2 where |d| <= delta, else delta (|d| - delta / 2), in f32."""
    input, label = _amp("huber_loss", "black", input, label)
    d = (input - label).float()
    ad = d.abs()
    loss = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(loss, reduction)


@register_op("label_smooth", amp_in_fn=True)
def label_smooth(label, prior_dist=None, epsilon=0.1):
    label, prior_dist = _amp("label_smooth", None, label, prior_dist)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@register_op("npair_loss", amp_in_fn=True)
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross entropy of anchor @ positive^T against the diagonal (the
    reference's targets are arange(batch); `labels` is not read) plus
    l2_reg * (|anchor|^2 + |positive|^2) / (2 batch)."""
    anchor, positive = _amp("npair_loss", None, anchor, positive)
    b = anchor.shape[0]
    logp = torch.log_softmax(torch.matmul(anchor, positive.T), dim=1)
    ce = -logp.diagonal().mean()
    return ce + l2_reg * (torch.square(anchor).sum()
                          + torch.square(positive).sum()) / (2.0 * b)


@register_op("hsigmoid_loss", amp_policy="black", amp_in_fn=True)
def hsigmoid_loss(x, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None):
    """Hierarchical sigmoid loss (nn_ops.py:1092): the default complete
    binary tree walks the bits of label + num_classes from the top (node
    (code >> (len - d)) - 1, bit (code >> (len - d - 1)) & 1 at depth
    d), or a custom tree's path_table / path_code ([B, depth], -1
    padded); the sum over the path of BCE(logit, bit), [B, 1]."""
    x, weight, bias = _amp("hsigmoid_loss", "black", x, weight, bias)
    xf = x.float()
    if path_table is None:
        code = label.int() + num_classes
        max_depth = int(np.floor(np.log2(max(num_classes, 2)))) + 1
        ds = torch.arange(max_depth, device=x.device, dtype=torch.int32)
        length = torch.floor(torch.log2(code.float())).int()
        shift = torch.clamp_min(length[:, None] - ds[None, :], 0)
        node = (code[:, None] >> shift) - 1
        bit = (code[:, None] >> torch.clamp_min(shift - 1, 0)) & 1
        valid = ds[None, :] < length[:, None]
    else:
        node, bit = path_table.int(), path_code.int()
        valid = node >= 0
    node = torch.where(valid, node, 0).long()
    logits = torch.einsum("bdf,bf->bd", weight[node].float(), xf)
    if bias is not None:
        logits = logits + bias.float()[node]
    t = bit.float()
    per = torch.clamp_min(logits, 0) - logits * t + torch.log1p(
        torch.exp(-logits.abs()))
    return torch.where(valid, per, 0.0).sum(1, keepdim=True)


@register_op("margin_cross_entropy", amp_policy="black", amp_in_fn=True)
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False):
    """ArcFace / CosFace margin softmax CE (nn_ops.py:1136): the target
    cosine cos(theta) becomes cos(margin1 theta + margin2) - margin3,
    then scale * logits go through softmax CE; [N, 1]."""
    logits, label = _amp("margin_cross_entropy", "black", logits, label)
    lf = logits.float()
    lbl = label.long().reshape(-1)[:, None]
    cos_t = torch.clamp(lf.gather(1, lbl)[:, 0], -1.0, 1.0)
    cos_m = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    z = lf.scatter(1, lbl, cos_m[:, None]) * scale
    loss = (torch.logsumexp(z, dim=1) - z.gather(1, lbl)[:, 0])[:, None]
    if return_softmax:
        return loss, torch.softmax(z, dim=1)
    return loss


# ---------------------------------------------------------------------------
# bilinear (nn_ops.py:1160)
# ---------------------------------------------------------------------------
@register_op("bilinear", amp_policy="white", amp_in_fn=True)
def bilinear(x1, x2, weight, bias=None):
    """out[b, o] = x1[b]^T W[o] x2[b], f32 products cast to x1's dtype,
    plus bias."""
    x1, x2, weight, bias = _amp("bilinear", "white", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1.float(), weight.float(),
                       x2.float()).to(x1.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out


# ---------------------------------------------------------------------------
# nn.functional's own (paddle_tpu/nn/functional/__init__.py)
# ---------------------------------------------------------------------------
@register_op("cosine_similarity", amp_in_fn=True)
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """sum(x1 * x2) / max(|x1| |x2|, eps) over `axis` (:43)."""
    x1, x2 = _amp("cosine_similarity", None, x1, x2)
    dot = (x1 * x2).sum(axis)
    n1 = torch.sqrt(torch.square(x1).sum(axis))
    n2 = torch.sqrt(torch.square(x2).sum(axis))
    return dot / torch.clamp_min(n1 * n2, eps)


@register_op("normalize", amp_in_fn=True)
def normalize(x, p=2.0, axis=1, epsilon=1e-12):
    """x over max(its p-norm along `axis`, epsilon) (:51)."""
    (x,) = _amp("normalize", None, x)
    norm = torch.pow(torch.pow(x.abs(), p).sum(axis, keepdim=True), 1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


@register_op("sequence_mask", amp_in_fn=True)
def sequence_mask(x, maxlen=None, dtype="int64"):
    """[..., maxlen] with 1 where the position is below the length in
    `x` (:105). `maxlen` is required, as in the reference (its shapes
    are static)."""
    if maxlen is None:
        raise ValueError("maxlen must be given under XLA (static shapes)")
    dt = to_dtype(dtype)
    r = torch.arange(int(maxlen), device=x.device)
    return (r < x[..., None]).to(NARROW.get(dt, dt))


def softmax_(x, axis=-1):
    """softmax (:201): like the reference's, it returns a new tensor."""
    return softmax(x, axis)


def _segments_of(cu, total, device):
    """Each of `total` packed positions' sequence index by the offsets
    `cu` (searchsorted right, minus one); positions at or past cu[-1]
    get -1 (padding)."""
    cu = torch.as_tensor(cu, device=device).to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=device)
    seg = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
    return torch.where((pos < cu[-1]) & (seg < cu.shape[0] - 1), seg, -1)


@register_op("flash_attn_unpadded", amp_in_fn=True)
def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        training=True, name=None):
    """Attention over packed sequences (:129): query/key/value [total,
    heads, head_dim], cu_seqlens_* [n_seqs + 1] offsets. The packing is
    one batch row through ``fused_flash_attention`` with segment ids from
    the offsets, so on the card B1 and B2 run it (the total a multiple
    of 128); q padding past cu_seqlens_q[-1] gets id -1 and kv padding
    -2, so padding attends to nothing and outputs 0. `causal` needs
    equal packings (checked on the host, as the reference checks its
    concrete offsets). Returns (out, None)."""
    from ..incubate.nn.functional import fused_flash_attention
    if causal:
        cq = np.asarray(torch.as_tensor(cu_seqlens_q).cpu())
        ck = np.asarray(torch.as_tensor(cu_seqlens_k).cpu())
        if cq.shape != ck.shape or not np.array_equal(cq, ck):
            raise NotImplementedError(
                "flash_attn_unpadded with causal=True requires "
                "identical q/kv packing (cu_seqlens_q == cu_seqlens_k): "
                "the global bottom-right causal mask only matches "
                "per-sequence causality when the packings coincide")
    q_seg = _segments_of(cu_seqlens_q, query.shape[0], query.device)
    kv_seg = _segments_of(cu_seqlens_k, key.shape[0], key.device)
    kv_seg = torch.where(kv_seg < 0, -2, kv_seg)
    out = fused_flash_attention(
        query[None], key[None], value[None], causal=causal, dropout=dropout,
        training=training, softmax_scale=scale,
        segment_ids=(q_seg[None], kv_seg[None]))
    return out[0], None


@register_op("warprnnt", amp_policy="black", amp_in_fn=True)
def rnnt_loss_op(input, label, input_lengths, label_lengths, blank=0,
                 fastemit_lambda=0.0):
    """RNN-Transducer loss per sample (ops/longtail.py:501): the
    log-semiring alpha recursion over the [T, U + 1] grid of
    log_softmax(input) ([B, T, U + 1, V]), one time step after another
    and, within a step, one label position after another, as the
    reference's scan and fori_loop run it; invalid columns and steps
    past a sample's own length are masked (-1e30, frozen). Returns
    -(alpha[T_b - 1, U_b] + blank[T_b - 1, U_b]). fastemit_lambda > 0 is
    not implemented and raises, as in the reference."""
    if fastemit_lambda:
        raise NotImplementedError(
            "fastemit_lambda > 0 is not implemented on the RNN-T path; "
            "pass fastemit_lambda=0.0")
    (input,) = _amp("warprnnt", "black", input)
    logp = torch.log_softmax(input, dim=-1)
    b, t_max, u1, _ = logp.shape
    dev, dt = logp.device, logp.dtype
    lbl = label.long()
    in_len, lb_len = input_lengths.long(), label_lengths.long()
    blank_lp = logp[..., blank]                             # [B, T, U+1]
    lbl_pad = torch.cat([lbl, torch.zeros((b, 1), dtype=torch.long,
                                          device=dev)], 1)[:, :u1]
    emit_lp = logp.gather(-1, lbl_pad[:, None, :, None].expand(
        b, t_max, u1, 1))[..., 0]                           # [B, T, U+1]
    neg_inf = torch.tensor(-1e30, dtype=dt, device=dev)
    valid_u = torch.arange(u1, device=dev)[None, :] <= lb_len[:, None]
    alpha = torch.where(valid_u, torch.cat(
        [torch.zeros((b, 1), dtype=dt, device=dev),
         torch.cumsum(emit_lp[:, 0, :-1], 1)], 1), neg_inf)
    for t in range(1, t_max):
        stay = alpha + blank_lp[:, t - 1]
        emit_in = emit_lp[:, t]
        cols = [stay[:, 0]]
        for u in range(1, u1):
            cols.append(torch.logaddexp(stay[:, u],
                                        cols[-1] + emit_in[:, u - 1]))
        alpha_t = torch.where(valid_u, torch.stack(cols, 1), neg_inf)
        alpha = torch.where((t < in_len)[:, None], alpha_t, alpha)
    tb = torch.clamp(in_len - 1, 0, t_max - 1)
    ub = torch.clamp(lb_len, 0, u1 - 1)
    a_final = alpha.gather(1, ub[:, None])[:, 0]
    blank_final = blank_lp[torch.arange(b, device=dev), tb, ub]
    return -(a_final + blank_final)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss (:205) over ``rnnt_loss_op``, reduced by
    "mean", "sum" or "none". As in the reference, fastemit_lambda
    defaults to 0.0 (paddle's 0.001 would raise)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"reduction must be 'mean', 'sum' or 'none'; got {reduction!r}")
    per_sample = rnnt_loss_op(input, label, input_lengths, label_lengths,
                              blank=blank, fastemit_lambda=fastemit_lambda)
    if reduction == "mean":
        return per_sample.mean()
    if reduction == "sum":
        return per_sample.sum()
    return per_sample


# the reference's nn.functional re-exports these long-tail ops of ops/
# (ops/ imports this module first, so they are imported at its end)
from ..ops.sequence_ops import ctc_loss  # noqa: E402,F401
from ..ops.vision_ops import (deformable_conv,  # noqa: E402,F401
                              depthwise_conv2d, max_pool2d_with_index)

__all__ += ["ctc_loss", "deformable_conv", "depthwise_conv2d",
            "max_pool2d_with_index"]
