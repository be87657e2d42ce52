"""Weight-only quantization for LLM serving (counterpart of
paddle_tpu/nn/quant/__init__.py): ``weight_quantize`` /
``weight_dequantize`` with per-output-channel absmax scales, the
[in, out] weight stored transposed [out, in] as int8 codes in [-127,
127], or as int4 codes in [-7, 7] packed two to a byte along the input
axis (low nibble first); ``weight_only_linear`` and LLM.int8()'s
``llm_int8_linear``. The codes round half to even (``torch.round``, as
``jnp.round``), so they equal the reference's exactly. The products
dequantize to f32 and multiply in f32, as the reference computes them;
the result takes x's dtype. Each scale is absmax times the f32
reciprocal of 127 (or 7): the reference divides by the constant, which
XLA compiles into that product, and the codes follow the scale's
bits."""
from __future__ import annotations

import torch

from ...amp.state import maybe_cast_inputs as _amp
from ...core.dtype import to_dtype
from ...ops.registry import register_op

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear"]


def _codes(w, scale, limit):
    """round(w / scale) per row, clamped to [-limit, limit], as int8 (a
    zero scale divides by 1)."""
    safe = torch.where(scale == 0, 1.0, scale)
    return torch.clamp(torch.round(w / safe[:, None]), -limit,
                       limit).to(torch.int8)


@register_op("weight_quantize", amp_in_fn=True)
def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """[in, out] float weight -> (codes [out, in] int8, or [out, in // 2]
    packed int4; scale [out] f32). algo: "weight_only_int8" or
    "llm.int8" (int8 codes, scale absmax / 127), "weight_only_int4"
    (absmax / 7, the input axis even). `arch` and `group_size` are taken
    and not used, as in the reference."""
    if algo not in ("weight_only_int8", "weight_only_int4", "llm.int8"):
        raise ValueError(f"unknown algo {algo!r}")
    w = x.float().T
    amax = w.abs().amax(1)
    if algo == "weight_only_int4":
        if w.shape[1] % 2:
            raise ValueError(
                "weight_only_int4 packs nibble PAIRS along the input "
                f"dim, which must be even; got in-dim {w.shape[1]}")
        scale = amax * (1.0 / 7.0)
        q = _codes(w, scale, 7)
        lo = q[:, 0::2].to(torch.int32) & 0xF
        hi = q[:, 1::2].to(torch.int32) & 0xF
        return (lo | (hi << 4)).to(torch.uint8).view(torch.int8), scale
    scale = amax * (1.0 / 127.0)
    return _codes(w, scale, 127), scale


def _unpack_int4(q):
    """[out, in // 2] packed int8 -> [out, in] int32 values in [-8, 7]
    (low nibble first)."""
    b = q.view(torch.uint8).to(torch.int32)
    lo, hi = b & 0xF, (b >> 4) & 0xF
    out = torch.stack([torch.where(lo >= 8, lo - 16, lo),
                       torch.where(hi >= 8, hi - 16, hi)], -1)
    return out.reshape(q.shape[0], -1)


def _dequant(weight, scale, int4):
    """The f32 [out, in] weight of codes `weight` times `scale`."""
    vals = _unpack_int4(weight) if int4 else weight.to(torch.int32)
    w = vals.float()
    return w if scale is None else w * scale.float()[:, None]


@register_op("weight_dequantize", amp_in_fn=True)
def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16", group_size=-1):
    """(codes [out, in], scale [out]) -> the [in, out] weight in
    `out_dtype`."""
    return _dequant(x, scale, algo == "weight_only_int4").T.to(
        to_dtype(out_dtype))


@register_op("weight_only_linear", amp_policy="white", amp_in_fn=True)
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x [.., in] @ dequant(weight [out, in (/ 2 for int4)])ᵀ + bias, in
    f32, cast to x's dtype."""
    x, bias, weight_scale = _amp("weight_only_linear", "white", x, bias,
                                 weight_scale)
    w = _dequant(weight, weight_scale, weight_dtype == "int4")
    out = torch.matmul(x.float(), w.T)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _int8_split(xf, threshold):
    """LLM.int8()'s decomposition of f32 activations: (outlier columns
    [in] bool (absmax over every row above `threshold`), their values,
    the rest's int8 codes as f32 (round(x / s) clamped to ±127), the
    per-tensor scale s = absmax * (1 / 127) (1 when 0))."""
    col_amax = xf.abs().amax(dim=tuple(range(xf.dim() - 1)))
    outlier = col_amax > threshold
    x_in = torch.where(outlier, 0.0, xf)
    a_scale = x_in.abs().amax() * (1.0 / 127.0)
    a_scale = torch.where(a_scale == 0, 1.0, a_scale)
    xq = torch.clamp(torch.round(x_in / a_scale), -127, 127)
    return outlier, torch.where(outlier, xf, 0.0), xq, a_scale


@register_op("llm_int8_linear", amp_policy="white", amp_in_fn=True)
def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8() (quant/__init__.py:97): activation columns whose absmax
    exceeds `threshold` multiply the dequantized weight in f32; the rest
    run as int8 codes times the weight, rescaled; plus bias, cast to
    x's dtype."""
    x, bias, weight_scale = _amp("llm_int8_linear", "white", x, bias,
                                 weight_scale)
    wdq = _dequant(weight, weight_scale, False)
    _, x_out, xq, a_scale = _int8_split(x.float(), threshold)
    out = torch.matmul(xq, wdq.T) * a_scale + torch.matmul(x_out, wdq.T)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
