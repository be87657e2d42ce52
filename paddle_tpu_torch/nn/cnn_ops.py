"""Convolution, pooling and batch norm (counterparts of
paddle_tpu/ops/nn_ops.py:235-437 and :523-571, and of
ops/vision_ops.py:38's ``conv3d_transpose``), and the spatial ops (the
1-D and 3-D adaptive max pools, the shuffles, ``interpolate`` /
``upsample``, ``unfold_im2col``, ``temporal_shift``, ``affine_grid``,
nn.functional's ``grid_sample``, and vision_ops' ``fold`` and
``unpool``), re-exported by ``nn.functional``.

The reference computes these with XLA, not Pallas: convolutions through
``lax.conv_general_dilated``, pools through ``lax.reduce_window``, batch
norm in jnp. So no TPU kernel stands behind them, and the port calls
PyTorch's convolutions and pools (cuDNN on the card) where they compute
the same function, and writes out what they do not: the padding rules
(every form of ``_conv_padding``, asymmetric pairs and ``"SAME"`` by
XLA's rule), max pools padded with -inf and averages over the valid
elements, and batch norm's statistics in the reference's two forms with
its running-statistics rule.

Layouts: a channels-last input (``data_format`` ending in "C") is
viewed channels-first by ``movedim`` (no copy: PyTorch then sees a
channels-last tensor and cuDNN computes in that layout) and the result
moved back the same way. Weights keep paddle's [out, in/groups, *k]
(transposes: [in, out/groups, *k]) in every layout, as in the reference.

f32 convolutions: the reference asks XLA for ``Precision.HIGHEST``
(nn_ops.py:290). On the card cuDNN computes f32 convolutions in TF32
while ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default);
the port sets no global backend flag, so a caller that needs the
reference's f32 results sets it to False.

AMP policies are the reference registry's: convolutions white,
``batch_norm`` black, pools follow their input. ``ceil_mode`` is taken
and ignored, as the reference's ``_pool`` ignores it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..amp.state import cast_target
from ..amp.state import maybe_cast_inputs as _amp
from ..core.flags import flag_value
from ..ops.registry import register_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool2d", "batch_norm", "adaptive_max_pool1d",
           "adaptive_max_pool3d", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "interpolate", "upsample", "unfold_im2col",
           "fold", "unpool", "temporal_shift", "affine_grid",
           "grid_sample"]


# ---------------------------------------------------------------- helpers
def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _conv_padding(padding, n):
    """The reference's padding forms (nn_ops.py:255-265): "SAME" /
    "VALID", an int, n ints, 2n ints (lo, hi per axis), or n pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding),) * 2] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(v) for v in p) for p in padding]


def _same_pads(size, window, stride):
    """XLA's "SAME" (lax.padtype_to_pads): ceil(size / stride) outputs,
    the padding split with the smaller half in front."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, windows, strides):
    """[(lo, hi)] per spatial axis of `padding` for windows of
    `windows` (their dilated extent) at `strides`."""
    p = _conv_padding(padding, len(spatial))
    if p == "SAME":
        return [_same_pads(s, w, st)
                for s, w, st in zip(spatial, windows, strides)]
    if p == "VALID":
        return [(0, 0)] * len(spatial)
    if isinstance(p, str):
        raise ValueError(f"padding {padding!r}: expected 'SAME', 'VALID' "
                         f"or integers")
    return p


def _torch_pad(pads):
    """A [(lo, hi)] per axis list as torch.nn.functional.pad's argument
    (last axis first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _pad_or_crop(y, pads):
    """y widened by zeros (a positive pad) or cropped (a negative one) on
    each spatial axis by its (lo, hi); an axis left with no elements is
    empty, as XLA's convolution gives it."""
    keep = [slice(None), slice(None)]
    grow = []
    for (lo, hi), size in zip(pads, y.shape[2:]):
        if size + lo + hi <= 0:
            keep.append(slice(0, 0))
            grow.append((0, 0))
            continue
        keep.append(slice(max(-lo, 0), size - max(-hi, 0)))
        grow.append((max(lo, 0), max(hi, 0)))
    return TF.pad(y[tuple(keep)], _torch_pad(grow))


def _channels_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _restore_layout(y, channel_last):
    return y.movedim(1, -1) if channel_last else y


def _add_bias(out, bias, channel_last):
    if bias is None:
        return out
    shape = [1] * out.dim()
    shape[-1 if channel_last else 1] = bias.shape[0]
    return out + bias.reshape(shape)


# ---------------------------------------------------------------- conv
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format):
    """nn_ops.py:268: a convolution of x (N, C, *spatial or N, *spatial,
    C) with weight [out, in/groups, *k]; equal non-negative pads go to
    the convolution itself, any other padding is applied first."""
    n = x.dim() - 2
    channel_last = data_format[-1] == "C"
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    xc = _channels_first(x, channel_last)
    windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = _pads(padding, xc.shape[2:], windows, stride)
    if all(lo == hi >= 0 for lo, hi in pads):
        pad_arg = [lo for lo, _ in pads]
    else:
        xc = TF.pad(xc, _torch_pad(pads))
        pad_arg = 0
    out = _CONV[n](xc, weight, None, stride, pad_arg, dilation, groups)
    return _add_bias(_restore_layout(out, channel_last), bias, channel_last)


@register_op("conv1d", amp_policy="white", amp_in_fn=True)
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    x, weight, bias = _amp("conv1d", "white", x, weight, bias)
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 "NWC" if data_format == "NLC" else "NCW")


@register_op("conv2d", amp_policy="white", amp_in_fn=True)
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    x, weight, bias = _amp("conv2d", "white", x, weight, bias)
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format)


@register_op("conv3d", amp_policy="white", amp_in_fn=True)
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    x, weight, bias = _amp("conv3d", "white", x, weight, bias)
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n):
    """nn_ops.py:311 and vision_ops.py:38: the reference convolves x
    dilated by `stride` with the flipped kernel, padded (k - lo,
    k - hi + output_padding) per axis, k = (kernel - 1) * dilation (XLA's
    own pads for "SAME" / "VALID"). The full transposed convolution
    (no padding) is that convolution padded (k, k), so the result is the
    full one cropped, or padded with zeros, by the difference."""
    channel_last = data_format[-1] == "C"
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    outpad = _norm_tuple(output_padding, n)
    xc = _channels_first(x, channel_last)
    ks = [(k - 1) * d for k, d in zip(weight.shape[2:], dilation)]
    p = _conv_padding(padding, n)
    if isinstance(p, str):
        if any(st != 1 for st in stride):
            # what lax.conv_general_dilated raises for string padding
            # with an input dilation (the reference's call)
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        # XLA pads the input as a stride-1 window of k + 1
        lax_pads = _pads(p, xc.shape[2:], [k + 1 for k in ks], [1] * n)
    else:
        lax_pads = [(k - lo, k - hi + op)
                    for k, (lo, hi), op in zip(ks, p, outpad)]
    full = _CONV_T[n](xc, weight, None, stride, 0, 0, groups, dilation)
    out = _pad_or_crop(full, [(plo - k, phi - k) for k, (plo, phi)
                              in zip(ks, lax_pads)])
    return _add_bias(_restore_layout(out, channel_last), bias, channel_last)


@register_op("conv2d_transpose", amp_policy="white", amp_in_fn=True)
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """weight [in, out/groups, kh, kw] in every layout (nn_ops.py:311)."""
    x, weight, bias = _amp("conv2d_transpose", "white", x, weight, bias)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


@register_op("conv3d_transpose", amp_policy="white", amp_in_fn=True)
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    """weight [in, out/groups, kd, kh, kw] (vision_ops.py:38)."""
    x, weight, bias = _amp("conv3d_transpose", "white", x, weight, bias)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)


# ---------------------------------------------------------------- pools
_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _window_sums(x, kernel, stride):
    """Sums over each window (no padding) of a channels-first x."""
    if x.dim() == 3:
        return TF.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                             divisor_override=1).squeeze(2)
    return _AVG_POOL[x.dim() - 2](x, kernel, stride, divisor_override=1)


def _pool(x, kernel, stride, padding, kind, data_format, exclusive=True):
    """nn_ops.py:354: max (padding counts as -inf) or average over each
    window: the sum over the valid elements divided by their count
    (`exclusive`) or by the window's size. Pads that PyTorch's pools
    take (equal, at most half the window) go to them; others are
    applied first."""
    n = x.dim() - 2
    channel_last = data_format[-1] == "C"
    kernel = _norm_tuple(kernel, n)
    stride = _norm_tuple(stride if stride is not None else kernel, n)
    xc = _channels_first(x, channel_last)
    pads = _pads(padding, xc.shape[2:], kernel, stride)
    own = all(lo == hi and 0 <= lo <= k // 2
              for (lo, hi), k in zip(pads, kernel))
    if kind == "max":
        if own:
            out = _MAX_POOL[n](xc, kernel, stride, [lo for lo, _ in pads])
        else:
            low = -math.inf if xc.is_floating_point() \
                else torch.iinfo(xc.dtype).min
            out = _MAX_POOL[n](TF.pad(xc, _torch_pad(pads), value=low),
                               kernel, stride)
    elif own:
        out = _AVG_POOL[n](xc, kernel, stride, [lo for lo, _ in pads],
                           count_include_pad=not exclusive)
    else:
        sums = _window_sums(TF.pad(xc, _torch_pad(pads)), kernel, stride)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            out = sums / _window_sums(TF.pad(ones, _torch_pad(pads)),
                                      kernel, stride)
        else:
            out = sums / float(np.prod(kernel))
    return _restore_layout(out, channel_last)


@register_op("max_pool1d", amp_in_fn=True)
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    (x,) = _amp("max_pool1d", None, x)
    return _pool(x, kernel_size, stride, padding, "max", "NCW")


@register_op("max_pool2d", amp_in_fn=True)
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    (x,) = _amp("max_pool2d", None, x)
    return _pool(x, kernel_size, stride, padding, "max", data_format)


@register_op("max_pool3d", amp_in_fn=True)
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    (x,) = _amp("max_pool3d", None, x)
    return _pool(x, kernel_size, stride, padding, "max", data_format)


@register_op("avg_pool1d", amp_in_fn=True)
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    (x,) = _amp("avg_pool1d", None, x)
    return _pool(x, kernel_size, stride, padding, "avg", "NCW", exclusive)


@register_op("avg_pool2d", amp_in_fn=True)
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    (x,) = _amp("avg_pool2d", None, x)
    return _pool(x, kernel_size, stride, padding, "avg", data_format,
                 exclusive)


@register_op("avg_pool3d", amp_in_fn=True)
def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCDHW"):
    (x,) = _amp("avg_pool3d", None, x)
    return _pool(x, kernel_size, stride, padding, "avg", data_format,
                 exclusive)


def _adaptive(x, output_size, n, data_format, kind):
    """nn_ops.py:411-437, :1186: a window per output cell from
    floor(i * size / out) to ceil((i + 1) * size / out) on each axis
    (PyTorch's adaptive pools take the same windows); sizes that divide
    evenly run as the plain pool of that window, as the reference runs
    them."""
    out = _norm_tuple(output_size, n)
    channel_last = data_format[-1] == "C"
    xc = _channels_first(x, channel_last)
    sizes = xc.shape[2:]
    if all(s % o == 0 for s, o in zip(sizes, out)):
        k = tuple(s // o for s, o in zip(sizes, out))
        return _pool(x, k, k, 0, kind, data_format)
    fn = {("avg", 1): TF.adaptive_avg_pool1d,
          ("avg", 2): TF.adaptive_avg_pool2d,
          ("avg", 3): TF.adaptive_avg_pool3d,
          ("max", 1): TF.adaptive_max_pool1d,
          ("max", 2): TF.adaptive_max_pool2d,
          ("max", 3): TF.adaptive_max_pool3d}[kind, n]
    return _restore_layout(fn(xc, out), channel_last)


@register_op("adaptive_avg_pool1d", amp_in_fn=True)
def adaptive_avg_pool1d(x, output_size):
    (x,) = _amp("adaptive_avg_pool1d", None, x)
    return _adaptive(x, output_size, 1, "NCW", "avg")


@register_op("adaptive_avg_pool2d", amp_in_fn=True)
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    (x,) = _amp("adaptive_avg_pool2d", None, x)
    return _adaptive(x, output_size, 2, data_format, "avg")


@register_op("adaptive_avg_pool3d", amp_in_fn=True)
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    (x,) = _amp("adaptive_avg_pool3d", None, x)
    return _adaptive(x, output_size, 3, data_format, "avg")


@register_op("adaptive_max_pool2d", amp_in_fn=True)
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    (x,) = _amp("adaptive_max_pool2d", None, x)
    return _adaptive(x, output_size, 2, data_format, "max")


# ---------------------------------------------------------------- batch norm
def _batch_stats(x32, ch_axis, pivot):
    """(mean, biased variance) of f32 `x32` over every axis but
    `ch_axis`: exact two-pass moments, or, with a `pivot` (the running
    mean, holding no gradient), nn_ops.py:534-556's one-pass form, both
    sums over the same input centred on the pivot."""
    axes = tuple(i for i in range(x32.dim()) if i != ch_axis)
    if pivot is None:
        return x32.mean(axes), x32.var(axes, correction=0)
    shape = [1] * x32.dim()
    shape[ch_axis] = x32.shape[ch_axis]
    p = pivot.float()
    xc = x32 - p.reshape(shape)
    n = x32.numel() // x32.shape[ch_axis]
    d = xc.sum(axes) / n
    return d + p, torch.clamp_min((xc * xc).sum(axes) / n - d * d, 0.0)


class _BatchNormTrain(torch.autograd.Function):
    """Training batch norm computed in f32 on an input of any float
    dtype: the batch statistics in the reference's two forms, the
    output ``((x - mean) * rsqrt(var + eps)) * weight + bias``, and the
    closed-form backward. It saves x in its own dtype (bf16 under O1,
    where the reference's black-list cast would make an f32 copy) and
    two [C] vectors; the gradient reaches x as the f32 gradient cast to
    x's dtype, as through that cast. The fast form's statistics equal
    the exact form's as functions of x (its pivot holds no gradient),
    so one backward serves both."""

    @staticmethod
    def forward(ctx, x, weight, bias, pivot, ch_axis, epsilon):
        axes = tuple(i for i in range(x.dim()) if i != ch_axis)
        shape = [1] * x.dim()
        shape[ch_axis] = x.shape[ch_axis]
        x32 = x.float()
        mean, var = _batch_stats(x32, ch_axis, pivot)
        rstd = torch.rsqrt(var + epsilon)
        out = (x32 - mean.reshape(shape)) * rstd.reshape(shape)
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.axes, ctx.shape = axes, shape
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        axes, shape = ctx.axes, ctx.shape
        n = x.numel() // mean.numel()
        dy = dout.float()
        r = rstd.reshape(shape)
        xhat = (x.float() - mean.reshape(shape)) * r
        dbias = dy.sum(axes)
        dweight = (dy * xhat).sum(axes)
        # with g = dy * weight: sum(g) = weight * dbias and
        # sum(g * xhat) = weight * dweight
        if weight is None:
            g, sg, sgx = dy, dbias, dweight
        else:
            g = dy * weight.reshape(shape)
            sg, sgx = dbias * weight, dweight * weight
        dx = (g - (sg / n).reshape(shape)
              - xhat * (sgx / n).reshape(shape)) * r
        return (dx.to(x.dtype), None if weight is None else dweight,
                dbias if ctx.has_bias else None, None, None, None)


@register_op("batch_norm", amp_policy="black", amp_in_fn=True)
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """nn_ops.py:523: (out, new running mean, new running variance).

    Training normalises by the batch's statistics over every axis but
    the channel's, in f32: exact two-pass moments, or with
    ``FLAGS_fast_bn_stats`` the one-pass form whose pivot is the running
    mean (held out of the gradient); the running statistics become
    ``momentum * old + (1 - momentum) * batch``, the variance biased
    (``torch.nn.functional.batch_norm`` weights momentum the other way
    and keeps the unbiased variance, so it is not used). Eval normalises
    by the running statistics and returns them unchanged. AMP black:
    under auto_cast the math runs in f32 and the output is f32."""
    channel_last = data_format[-1] == "C" and x.dim() > 2
    ch_axis = x.dim() - 1 if channel_last else 1
    compute = cast_target("batch_norm", "black", x.dtype)
    running_mean, running_var, weight, bias = _amp(
        "batch_norm", "black", running_mean, running_var, weight, bias)
    pivot = running_mean.detach() if training and flag_value(
        "FLAGS_fast_bn_stats") else None
    if training and compute == torch.float32:
        out, mean, var = _BatchNormTrain.apply(x, weight, bias, pivot,
                                               ch_axis, epsilon)
        return (out, momentum * running_mean + (1 - momentum) * mean,
                momentum * running_var + (1 - momentum) * var)
    x = x.to(compute)
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    if training:
        # a low-precision computation (no auto_cast, a bf16 or f16
        # input): the statistics in f32, the rest in x's dtype, as the
        # reference computes it
        mean, var = _batch_stats(x.float(), ch_axis, pivot)
        new_rm = momentum * running_mean + (1 - momentum) * mean.detach()
        new_rv = momentum * running_var + (1 - momentum) * var.detach()
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
        var.reshape(shape).float() + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, new_rm, new_rv


# ---------------------------------------------------------------- adaptive max
def _adaptive_max_mask(x, output_size, n):
    """(max, argmax) of the adaptive windows of an NC* input, the argmax
    int32 and flat into the input's spatial volume (the unpool
    contract)."""
    fn = {1: TF.adaptive_max_pool1d, 3: TF.adaptive_max_pool3d}[n]
    out, idx = fn(x, _norm_tuple(output_size, n), return_indices=True)
    return out, idx.to(torch.int32)


@register_op("adaptive_max_pool1d", amp_in_fn=True)
def adaptive_max_pool1d(x, output_size, return_mask=False):
    """nn_ops.py:1171: the max of each adaptive window along L; with
    `return_mask` also the int32 argmax positions along L."""
    (x,) = _amp("adaptive_max_pool1d", None, x)
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1)
    return _adaptive(x, output_size, 1, "NCW", "max")


@register_op("adaptive_max_pool3d", amp_in_fn=True)
def adaptive_max_pool3d(x, output_size, data_format="NCDHW",
                        return_mask=False):
    """nn_ops.py:1197: the max of each adaptive window; with
    `return_mask` (NCDHW only, as in the reference) also the int32
    argmax flat into D*H*W."""
    (x,) = _amp("adaptive_max_pool3d", None, x)
    if not return_mask:
        return _adaptive(x, output_size, 3, data_format, "max")
    if data_format[-1] == "C":
        raise NotImplementedError(
            "adaptive_max_pool3d(return_mask=True) supports NCDHW only "
            "(the reference AdaptiveMaxPool3D has no data_format)")
    return _adaptive_max_mask(x, output_size, 3)


# ---------------------------------------------------------------- shuffles
@register_op("pixel_shuffle", amp_in_fn=True)
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    (x,) = _amp("pixel_shuffle", None, x)
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@register_op("pixel_unshuffle", amp_in_fn=True)
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    """NCHW, as the reference computes it whatever `data_format` says."""
    (x,) = _amp("pixel_unshuffle", None, x)
    r = downscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


@register_op("channel_shuffle", amp_in_fn=True)
def channel_shuffle(x, groups, data_format="NCHW"):
    """NCHW, as the reference computes it whatever `data_format` says."""
    (x,) = _amp("channel_shuffle", None, x)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


# ---------------------------------------------------------------- resize
def _jnp_linspace(start, stop, num, device):
    """jnp.linspace in f32: start * (1 - i / (num - 1)) + stop * i /
    (num - 1), the last point `stop` itself."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / (num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def _keys_cubic(x):
    """The Keys cubic kernel with a = -0.5 (jax.image's CUBIC)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """jax.image's weight matrix [n_in, n_out] for one axis: half-pixel
    sample points, the kernel widened by the downsampling factor (its
    antialiasing), each column normalised to sum 1, columns whose sample
    lies outside the input zeroed; in f32."""
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]).abs() \
        / max(inv, 1.0)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _along(x, ax, w):
    """x contracted with w [x.shape[ax], n] on axis `ax` (which becomes
    n long)."""
    return torch.matmul(x.movedim(ax, -1), w).movedim(-1, ax)


def _resize(x, shape, method):
    """jax.image.resize(x, shape, method) (antialiased), each axis whose
    size changes in turn: "nearest" takes index floor((i + 0.5) * n_in
    / n_out) (half-pixel centres, torch's "nearest-exact"), "linear" and
    "cubic" contract with ``_resize_weights``."""
    if method == "nearest":
        for ax, n in enumerate(shape):
            m = x.shape[ax]
            if m == n:
                continue
            off = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * m / n
            x = x.index_select(ax, torch.floor(off).long())
        return x
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    kernel = _triangle if method == "linear" else _keys_cubic
    for ax, n in enumerate(shape):
        if x.shape[ax] != n:
            x = _along(x, ax, _resize_weights(x.shape[ax], n, kernel,
                                              x.device).to(x.dtype))
    return x


def _resize_align_corners(x, shape, channel_last):
    """nn_ops.py:979: linear interpolation on each spatial axis at the
    points jnp.linspace(0, n_in - 1, n_out) (whatever the mode)."""
    axes = range(1, x.dim() - 1) if channel_last else range(2, x.dim())
    out = x
    for ax in axes:
        n_in, n_out = x.shape[ax], shape[ax]
        if n_in == n_out:
            continue
        pos = _jnp_linspace(0.0, n_in - 1.0, n_out, x.device)
        lo = torch.floor(pos).long()
        hi = torch.clamp_max(lo + 1, n_in - 1)
        bshape = [1] * out.dim()
        bshape[ax] = n_out
        w = (pos - lo).to(x.dtype).reshape(bshape)
        out = out.index_select(ax, lo) * (1 - w) \
            + out.index_select(ax, hi) * w
    return out


_RESIZE_MODES = {"nearest": "nearest", "bilinear": "linear",
                 "linear": "linear", "trilinear": "linear",
                 "bicubic": "cubic", "area": "linear"}


@register_op("interpolate", amp_in_fn=True)
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """nn_ops.py:955: resize the spatial axes to `size` (or int(s * f)
    of `scale_factor`) as jax.image.resize computes it, which differs
    from torch.nn.functional.interpolate: "nearest" takes half-pixel
    centres (torch's "nearest-exact"), linear and cubic antialias when
    they downsample, "area" is antialiased linear, and cubic is Keys'
    with a = -0.5 (torch's bicubic uses -0.75). With `align_corners`
    every mode but "nearest" interpolates linearly between the corners
    (``_resize_align_corners``)."""
    (x,) = _amp("interpolate", None, x)
    channel_last = data_format[-1] == "C"
    spatial = tuple(x.shape[1:-1] if channel_last else x.shape[2:])
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s.item()) if hasattr(s, "item") else int(s) for s in (
        size if isinstance(size, (list, tuple)) else [size])]
    method = _RESIZE_MODES[mode]
    if channel_last:
        shape = (x.shape[0],) + tuple(size) + (x.shape[-1],)
    else:
        shape = tuple(x.shape[:2]) + tuple(size)
    if mode == "nearest":
        return _resize(x, shape, "nearest")
    if align_corners:
        return _resize_align_corners(x, shape, channel_last)
    return _resize(x, shape, method)


@register_op("upsample", amp_in_fn=True)
def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate.raw_fn(x, size, scale_factor, mode, align_corners,
                              data_format)


# ---------------------------------------------------------------- patches
@register_op("unfold_im2col", amp_in_fn=True)
def unfold_im2col(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """[N, C * kh * kw, L] patch columns (channel-major, then the kernel
    rows and columns) of a zero-padded NCHW input (nn_ops.py:1001)."""
    (x,) = _amp("unfold_im2col", None, x)
    n, c, h, w = x.shape
    kh, kw = _norm_tuple(kernel_sizes, 2)
    sh, sw = _norm_tuple(strides, 2)
    ph, pw = _norm_tuple(paddings, 2)
    dh, dw = _norm_tuple(dilations, 2)
    xp = TF.pad(x, [pw, pw, ph, ph])
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + oh * sh:sh, j * dw:j * dw + ow * sw:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, 2).reshape(n, c * kh * kw, oh * ow)


@register_op("fold", amp_in_fn=True)
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im (ops/vision_ops.py:147), the inverse of unfold: [N, C * kh
    * kw, L] patch columns summed into [N, C, H, W]."""
    (x,) = _amp("fold", None, x)
    kh, kw = _norm_tuple(kernel_sizes, 2)
    sh, sw = _norm_tuple(strides, 2)
    dh, dw = _norm_tuple(dilations, 2)
    pad = _conv_padding(paddings, 2)
    H, W = _norm_tuple(output_sizes, 2)
    N, CKK, _ = x.shape
    C = CKK // (kh * kw)
    Hp, Wp = H + pad[0][0] + pad[0][1], W + pad[1][0] + pad[1][1]
    Lh = (Hp - dh * (kh - 1) - 1) // sh + 1
    Lw = (Wp - dw * (kw - 1) - 1) // sw + 1
    cols = x.reshape(N, C, kh, kw, Lh, Lw)
    out = torch.zeros((N, C, Hp, Wp), dtype=x.dtype, device=x.device)
    for iy in range(kh):
        for ix in range(kw):
            out[:, :, iy * dh:iy * dh + Lh * sh:sh,
                ix * dw:ix * dw + Lw * sw:sw] += cols[:, :, iy, ix]
    return out[:, :, pad[0][0]:Hp - pad[0][1], pad[1][0]:Wp - pad[1][1]]


@register_op("unpool", amp_in_fn=True)
def unpool(x, indices, kernel_size=2, stride=None, padding=0,
           output_size=None):
    """max_unpool2d (ops/vision_ops.py:229): each pooled value written
    at its flat H * W index of a zero [N, C, H, W], H and W from the
    pool's arguments unless `output_size` gives them."""
    (x,) = _amp("unpool", None, x)
    N, C, Ho, Wo = x.shape
    if output_size is None:
        kh, kw = _norm_tuple(kernel_size, 2)
        sh, sw = _norm_tuple(stride if stride is not None else kernel_size,
                             2)
        pad = _conv_padding(padding, 2)
        H = (Ho - 1) * sh - pad[0][0] - pad[0][1] + kh
        W = (Wo - 1) * sw - pad[1][0] - pad[1][1] + kw
    else:
        H, W = output_size[-2:]
    flat = torch.zeros((N, C, H * W), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(),
                        x.reshape(N, C, -1))
    return flat.reshape(N, C, H, W)


@register_op("temporal_shift", amp_in_fn=True)
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """The first shift_ratio of the channels shifted one segment back in
    time, the next as many one forward, zeros where nothing shifts in
    (nn_ops.py:1021)."""
    (x,) = _amp("temporal_shift", None, x)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold_ = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :fold_],
                      torch.zeros_like(xr[:, :1, :fold_])], 1)
    right = torch.cat([torch.zeros_like(xr[:, :1, fold_:2 * fold_]),
                       xr[:, :-1, fold_:2 * fold_]], 1)
    return torch.cat([left, right, xr[:, :, 2 * fold_:]], 2).reshape(
        nt, c, h, w)


@register_op("affine_grid", amp_in_fn=True)
def affine_grid(theta, out_shape, align_corners=True):
    """[N, H, W, 2] sampling points: theta [N, 2, 3] applied to the (x,
    y, 1) grid over [-1, 1] (corner-aligned, or pixel centres)."""
    (theta,) = _amp("affine_grid", None, theta)
    _, _, h, w = [int(v) for v in out_shape]
    dev = theta.device
    if align_corners:
        ys = _jnp_linspace(-1.0, 1.0, h, dev)
        xs = _jnp_linspace(-1.0, 1.0, w, dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) / h * 2 - 1
        xs = (torch.arange(w, device=dev) + 0.5) / w * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)


@register_op("grid_sample", amp_in_fn=True)
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x [N, C, H, W] sampled at grid [N, Hg, Wg, 2] in [-1, 1]
    (paddle_tpu/nn/functional/__init__.py:58): bilinear from the four
    neighbours, or the nearest (rounded half to even); "zeros" zeroes
    neighbours outside the image, any other padding_mode clamps them to
    the border."""
    x, grid = _amp("grid_sample", None, x, grid)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    flat = x.reshape(n, c, h * w)

    def gather(xi, yi):
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        val = flat.gather(2, idx.reshape(n, 1, -1).expand(n, c, -1)
                          ).reshape(n, c, *idx.shape[1:])
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            val = val * valid[:, None].to(val.dtype)
        return val

    if mode == "nearest":
        return gather(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    return (gather(x0, y0) * (1 - wx) * (1 - wy)
            + gather(x0 + 1, y0) * wx * (1 - wy)
            + gather(x0, y0 + 1) * (1 - wx) * wy
            + gather(x0 + 1, y0 + 1) * wx * wy)
