"""incubate.nn fused layers (counterpart of paddle_tpu/incubate/nn/layer.py):
FusedMultiHeadAttention (:23), FusedFeedForward (:116) and
FusedTransformerEncoderLayer (:165), as ``nn.Module``s over the fused
functionals, which reach B4 (layer norm) and B1 (flash attention).

Parameters keep the reference's names and layouts, so a paddle_tpu
state_dict loads name for name (``convert.fused_params_from_numpy``):
``qkv_weight`` is [3, H, D, dm] and ``qkv_bias`` [3, H, D], flattened
and transposed into the functional's [dm, 3*H*D] at each forward
(:97-103); the other weights are [in, out].

Construction takes ``device`` (None = the CUDA card, raises without
one; "cpu" by request), ``dtype`` and ``seed``: weights are drawn on the
device from a ``torch.Generator`` seeded with ``seed`` (Xavier-uniform
over the functional layout's fan-in and fan-out, the reference's
default initializer), biases 0 and layer-norm scales 1; dropout masks
come from a second generator seeded with ``seed + 1``. The reference's
``*_attr`` initializer arguments are not ported (they raise), nor are
FusedMultiTransformer, FusedLinear, FusedDropoutAdd and FusedEcMoe.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.dtype import to_dtype
from . import functional as F

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


def _no_attrs(cls, **attrs):
    for name, val in attrs.items():
        if val is not None:
            raise NotImplementedError(
                f"{cls}({name}=...): parameter attributes are not ported; "
                "load weights with load_state_dict instead")


class _FusedBase(nn.Module):
    """Parameter construction and seeded initialisation shared by the
    fused layers."""

    def _setup(self, device, dtype, seed):
        dev = resolve_device(device)
        self._fk = {"device": dev, "dtype": to_dtype(dtype)}
        self._init_gen = torch.Generator(device=dev)
        self._init_gen.manual_seed(seed)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed + 1)

    def _param(self, shape, fill=None, fans=None):
        """A parameter of `shape`: constant `fill`, or Xavier-uniform over
        (fan_in, fan_out) = `fans`."""
        if fill is not None:
            return nn.Parameter(torch.full(shape, float(fill), **self._fk))
        p = torch.empty(shape, **self._fk)
        limit = math.sqrt(6.0 / (fans[0] + fans[1]))
        p.uniform_(-limit, limit, generator=self._init_gen)
        return nn.Parameter(p)


class FusedMultiHeadAttention(_FusedBase):
    """Pre- or post-LN fused self-attention (reference layer.py:23)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None,
                 *, device=None, dtype="float32", seed=0):
        super().__init__()
        _no_attrs("FusedMultiHeadAttention", qkv_weight_attr=qkv_weight_attr,
                  qkv_bias_attr=qkv_bias_attr,
                  linear_weight_attr=linear_weight_attr,
                  linear_bias_attr=linear_bias_attr,
                  pre_ln_scale_attr=pre_ln_scale_attr,
                  pre_ln_bias_attr=pre_ln_bias_attr,
                  ln_scale_attr=ln_scale_attr, ln_bias_attr=ln_bias_attr)
        if ring_id != -1:
            raise NotImplementedError(
                "tensor-parallel fused attention is not ported")
        if kdim not in (None, embed_dim) or vdim not in (None, embed_dim):
            raise NotImplementedError(
                "fused attention is self-attention (kdim/vdim must equal "
                "embed_dim), as the reference op")
        self._setup(device, dtype, seed)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.transpose_qkv_wb = transpose_qkv_wb
        dm, hd3 = embed_dim, 3 * num_heads * self.head_dim
        if transpose_qkv_wb:
            self.qkv_weight = self._param((dm, 3 * dm), fans=(dm, 3 * dm))
            self.qkv_bias = self._param((3 * dm,), fill=0.0)
        else:
            self.qkv_weight = self._param(
                (3, num_heads, self.head_dim, dm), fans=(dm, hd3))
            self.qkv_bias = self._param((3, num_heads, self.head_dim),
                                        fill=0.0)
        self.linear_weight = self._param((dm, dm), fans=(dm, dm))
        self.linear_bias = self._param((dm,), fill=0.0)
        self.pre_ln_scale = self._param((dm,), fill=1.0)
        self.pre_ln_bias = self._param((dm,), fill=0.0)
        self.ln_scale = self._param((dm,), fill=1.0)
        self.ln_bias = self._param((dm,), fill=0.0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if key is not None and key is not query or \
                value is not None and value is not query:
            raise NotImplementedError(
                "fused attention is self-attention only (key/value must "
                "be the query), as the reference op")
        if cache is not None:
            raise NotImplementedError(
                "incremental decode through the fused layers is not ported")
        if self.transpose_qkv_wb:
            w, b = self.qkv_weight, self.qkv_bias
        else:
            # [3, H, D, dm] -> [dm, 3*H*D] (:97-103), a view
            hd3 = 3 * self.num_heads * self.head_dim
            w = self.qkv_weight.reshape(hd3, self.embed_dim).t()
            b = self.qkv_bias.reshape(hd3)
        return F.fused_multi_head_attention(
            query, w, b, self.linear_weight, self.linear_bias,
            self.num_heads, pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            epsilon=self.epsilon, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            training=self.training, generator=self.generator)


class FusedFeedForward(_FusedBase):
    """Pre- or post-LN fused feed-forward (reference layer.py:116)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 *, device=None, dtype="float32", seed=0):
        super().__init__()
        _no_attrs("FusedFeedForward",
                  linear1_weight_attr=linear1_weight_attr,
                  linear1_bias_attr=linear1_bias_attr,
                  linear2_weight_attr=linear2_weight_attr,
                  linear2_bias_attr=linear2_bias_attr,
                  ln1_scale_attr=ln1_scale_attr, ln1_bias_attr=ln1_bias_attr,
                  ln2_scale_attr=ln2_scale_attr, ln2_bias_attr=ln2_bias_attr)
        if ring_id != -1:
            raise NotImplementedError(
                "tensor-parallel fused FFN is not ported")
        self._setup(device, dtype, seed)
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        dm, ff = d_model, dim_feedforward
        self.linear1_weight = self._param((dm, ff), fans=(dm, ff))
        self.linear1_bias = self._param((ff,), fill=0.0)
        self.linear2_weight = self._param((ff, dm), fans=(ff, dm))
        self.linear2_bias = self._param((dm,), fill=0.0)
        self.ln_scale = self._param((dm,), fill=1.0)
        self.ln_bias = self._param((dm,), fill=0.0)

    def forward(self, src, cache=None):
        ln_kw = ({"ln1_scale": self.ln_scale, "ln1_bias": self.ln_bias}
                 if self.normalize_before else
                 {"ln2_scale": self.ln_scale, "ln2_bias": self.ln_bias})
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self.generator, **ln_kw)


class FusedTransformerEncoderLayer(nn.Module):
    """Fused attention + fused feed-forward block (reference
    layer.py:165). The attention block is seeded with ``seed``, the
    feed-forward block with ``seed + 2``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype="float32", seed=0):
        super().__init__()
        _no_attrs("FusedTransformerEncoderLayer", weight_attr=weight_attr,
                  bias_attr=bias_attr)
        attn_dropout_rate = dropout_rate if attn_dropout_rate is None \
            else attn_dropout_rate
        fk = {"device": device, "dtype": dtype}
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, seed=seed, **fk)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, seed=seed + 2, **fk)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "incremental decode through the fused layers is not ported")
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
