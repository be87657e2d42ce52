"""incubate.nn fused layers (counterpart of paddle_tpu/incubate/nn/layer.py):
FusedMultiHeadAttention (:23), FusedFeedForward (:116),
FusedTransformerEncoderLayer (:165), FusedMultiTransformer (:192),
FusedLinear (:281), FusedDropoutAdd (:301) and FusedEcMoe (:316), as
``nn.Layer``s over the fused functionals, which reach B4 (layer norm)
and B1 (flash attention; B2 through its backward).

Each weight comes from ``create_parameter`` with the reference's
``*_attr`` (a ParamAttr's initializer and name, else the reference's
default: XavierUniform, a bias Constant(0), a layer-norm scale
Constant(1)), with the reference's names and layouts, so a paddle_tpu
state_dict loads name for name (``convert.fused_params_from_numpy``):
``qkv_weight`` is [3, H, D, dm] and ``qkv_bias`` [3, H, D], flattened
and transposed into the functional's [dm, 3*H*D] at each forward
(:97-103); the other weights are [in, out]. As in the reference,
FusedFeedForward takes ``ln1_*_attr`` / ``ln2_*_attr`` and builds its
layer-norm parameters without them, and FusedTransformerEncoderLayer
takes ``weight_attr`` / ``bias_attr`` and does not pass them on.

Beside the reference's arguments each layer takes the keyword-only
``device`` (None: the eager default place, the card unless
``set_device`` chose the CPU), ``dtype``, ``init_generator`` (the
``torch.Generator`` the initial weights are drawn from; None: the
port's default generator there), and, where it drops, ``generator``
(the dropout masks' generator; None: the eager generator for a Tensor
input, torch's default generator for a torch one). Inputs may be the
eager API's Tensors or torch tensors, and come back as they went in.
"""
from __future__ import annotations

from ...nn.initializer import Constant
from ...nn.layer import Layer
from . import functional as F

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedDropoutAdd", "FusedEcMoe"]


class _Fused(Layer):
    """Parameter construction shared by the fused layers: on the layer's
    device, drawn from its init_generator."""

    def _setup(self, device, init_generator, generator=None):
        self._pkw = dict(device=device, generator=init_generator)
        self.generator = generator

    def _param(self, shape, attr=None, is_bias=False, ones=False):
        return self.create_parameter(
            shape, attr=attr, is_bias=is_bias,
            default_initializer=Constant(1.0) if ones else None,
            **self._pkw)


class FusedMultiHeadAttention(_Fused):
    """Pre- or post-LN fused self-attention (reference layer.py:23)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None,
                 *, device=None, dtype="float32", init_generator=None,
                 generator=None):
        super().__init__(dtype=dtype)
        if ring_id != -1:
            raise NotImplementedError(
                "tensor-parallel fused attention is not ported")
        if kdim not in (None, embed_dim) or vdim not in (None, embed_dim):
            raise NotImplementedError(
                "fused attention is self-attention (kdim/vdim must equal "
                "embed_dim), as the reference op")
        self._setup(device, init_generator, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.transpose_qkv_wb = transpose_qkv_wb
        dm = embed_dim
        if transpose_qkv_wb:
            self.qkv_weight = self._param((dm, 3 * dm), qkv_weight_attr)
            self.qkv_bias = self._param((3 * dm,), qkv_bias_attr,
                                        is_bias=True)
        else:
            self.qkv_weight = self._param(
                (3, num_heads, self.head_dim, dm), qkv_weight_attr)
            self.qkv_bias = self._param((3, num_heads, self.head_dim),
                                        qkv_bias_attr, is_bias=True)
        self.linear_weight = self._param((dm, dm), linear_weight_attr)
        self.linear_bias = self._param((dm,), linear_bias_attr,
                                       is_bias=True)
        self.pre_ln_scale = self._param((dm,), pre_ln_scale_attr, ones=True)
        self.pre_ln_bias = self._param((dm,), pre_ln_bias_attr,
                                       is_bias=True)
        self.ln_scale = self._param((dm,), ln_scale_attr, ones=True)
        self.ln_bias = self._param((dm,), ln_bias_attr, is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if key is not None and key is not query or \
                value is not None and value is not query:
            raise NotImplementedError(
                "fused attention is self-attention only (key/value must "
                "be the query), as the reference op")
        if cache is not None:
            raise NotImplementedError(
                "incremental decode: use incubate.nn.functional."
                "masked_multihead_attention / FusedMultiTransformer with "
                "cache_kvs")
        p = self._parameters
        if self.transpose_qkv_wb:
            w, b = p["qkv_weight"], p["qkv_bias"]
        else:
            # [3, H, D, dm] -> [dm, 3*H*D] (:97-103), a view
            hd3 = 3 * self.num_heads * self.head_dim
            w = p["qkv_weight"].reshape(hd3, self.embed_dim).t()
            b = p["qkv_bias"].reshape(hd3)
        return F.fused_multi_head_attention(
            query, w, b, p["linear_weight"], p["linear_bias"],
            self.num_heads, pre_layer_norm=self.normalize_before,
            pre_ln_scale=p["pre_ln_scale"], pre_ln_bias=p["pre_ln_bias"],
            ln_scale=p["ln_scale"], ln_bias=p["ln_bias"],
            epsilon=self.epsilon, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            training=self.training, generator=self.generator)


class FusedFeedForward(_Fused):
    """Pre- or post-LN fused feed-forward (reference layer.py:116)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 *, device=None, dtype="float32", init_generator=None,
                 generator=None):
        super().__init__(dtype=dtype)
        if ring_id != -1:
            raise NotImplementedError(
                "tensor-parallel fused FFN is not ported")
        self._setup(device, init_generator, generator)
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        dm, ff = d_model, dim_feedforward
        self.linear1_weight = self._param((dm, ff), linear1_weight_attr)
        self.linear1_bias = self._param((ff,), linear1_bias_attr,
                                        is_bias=True)
        self.linear2_weight = self._param((ff, dm), linear2_weight_attr)
        self.linear2_bias = self._param((dm,), linear2_bias_attr,
                                        is_bias=True)
        self.ln_scale = self._param((dm,), ones=True)
        self.ln_bias = self._param((dm,), is_bias=True)

    def forward(self, src, cache=None):
        p = self._parameters
        ln_kw = ({"ln1_scale": p["ln_scale"], "ln1_bias": p["ln_bias"]}
                 if self.normalize_before else
                 {"ln2_scale": p["ln_scale"], "ln2_bias": p["ln_bias"]})
        return F.fused_feedforward(
            src, p["linear1_weight"], p["linear2_weight"],
            linear1_bias=p["linear1_bias"], linear2_bias=p["linear2_bias"],
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self.generator, **ln_kw)


class FusedTransformerEncoderLayer(Layer):
    """Fused attention + fused feed-forward block (reference
    layer.py:165). Both blocks draw from `init_generator` (the attention
    block first) and drop with `generator`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype="float32", init_generator=None, generator=None):
        super().__init__(dtype=dtype)
        attn_dropout_rate = dropout_rate if attn_dropout_rate is None \
            else attn_dropout_rate
        kw = dict(device=device, dtype=dtype, init_generator=init_generator,
                  generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "incremental decode through the fused layers is not ported")
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(_Fused):
    """The whole-stack serving transformer (reference layer.py:192) over
    ``functional.fused_multi_transformer``: a prefill writes the caches,
    a decode step (``time_step``) reads them. Each ``*_attrs`` is one
    ParamAttr for every layer or a list of one a layer; the parameters
    are ``<name>_<layer>`` (``qkv_weight_0``, ...)."""

    _NAMES = ("ln_scale", "ln_bias", "qkv_weight", "qkv_bias",
              "linear_weight", "linear_bias", "ffn_ln_scale", "ffn_ln_bias",
              "ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias")

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None,
                 qkv_bias_attrs=None, linear_weight_attrs=None,
                 linear_bias_attrs=None, ffn_ln_scale_attrs=None,
                 ffn_ln_bias_attrs=None, ffn1_weight_attrs=None,
                 ffn1_bias_attrs=None, ffn2_weight_attrs=None,
                 ffn2_bias_attrs=None, epsilon=1e-5, num_layers=-1,
                 nranks=1, trans_qkvw=True, ring_id=-1, name=None,
                 *, device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        if num_layers == -1:
            num_layers = len(qkv_weight_attrs) \
                if isinstance(qkv_weight_attrs, (list, tuple)) else 1
        if ring_id != -1:
            raise NotImplementedError(
                "tensor-parallel serving is not ported")
        self._setup(device, init_generator)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.activation = activation
        self.epsilon = epsilon
        self.dropout_rate = dropout_rate
        self.trans_qkvw = trans_qkvw
        H, D, dm, ffn = num_heads, self.head_dim, embed_dim, dim_feedforward
        qkv_shape = (3, H, D, dm) if trans_qkvw else (dm, 3, H, D)
        specs = dict(
            ln_scale=((dm,), ln_scale_attrs, "ones"),
            ln_bias=((dm,), ln_bias_attrs, "bias"),
            qkv_weight=(qkv_shape, qkv_weight_attrs, None),
            qkv_bias=((3, H, D), qkv_bias_attrs, "bias"),
            linear_weight=((H * D, dm), linear_weight_attrs, None),
            linear_bias=((dm,), linear_bias_attrs, "bias"),
            ffn_ln_scale=((dm,), ffn_ln_scale_attrs, "ones"),
            ffn_ln_bias=((dm,), ffn_ln_bias_attrs, "bias"),
            ffn1_weight=((dm, ffn), ffn1_weight_attrs, None),
            ffn1_bias=((ffn,), ffn1_bias_attrs, "bias"),
            ffn2_weight=((ffn, dm), ffn2_weight_attrs, None),
            ffn2_bias=((dm,), ffn2_bias_attrs, "bias"))
        # made layer by layer in the reference's order (plist a name at a
        # time: every layer's ln_scale, then every layer's ln_bias, ...)
        for pname in self._NAMES:
            shape, attrs, kind = specs[pname]
            for i in range(num_layers):
                attr = attrs[i] if isinstance(attrs, (list, tuple)) \
                    else attrs
                self.add_parameter(f"{pname}_{i}", self._param(
                    shape, attr, is_bias=kind == "bias",
                    ones=kind == "ones"))

    def _list(self, pname):
        return [self._parameters[f"{pname}_{i}"]
                for i in range(self.num_layers)]

    def __getattr__(self, name):
        # the reference's per-kind lists (ln_scales, qkv_weights, ...):
        # each layer's Parameter of that kind
        for pname in FusedMultiTransformer._NAMES:
            plural = pname[:-1] + "es" if pname.endswith("bias") \
                else pname + "s"
            if name == plural:
                return [getattr(self, f"{pname}_{i}")
                        for i in range(self.num_layers)]
        return super().__getattr__(name)

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        return F.fused_multi_transformer(
            src, *(self._list(n) for n in self._NAMES),
            pre_layer_norm=self.normalize_before, epsilon=self.epsilon,
            cache_kvs=caches, pre_caches=pre_caches, seq_lens=seq_lens,
            rotary_embs=rotary_embs, rotary_emb_dims=rotary_emb_dims,
            time_step=time_step, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate, activation=self.activation,
            training=self.training, trans_qkvw=self.trans_qkvw)


class FusedLinear(_Fused):
    """x @ weight + bias through the fused matmul-bias op (reference
    layer.py:281); `transpose_weight` keeps weight [out, in]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self._setup(device, init_generator)
        self.transpose_weight = transpose_weight
        shape = (out_features, in_features) if transpose_weight else \
            (in_features, out_features)
        self.weight = self._param(shape, weight_attr)
        if bias_attr is False:
            self.add_parameter("bias", None)
        else:
            self.bias = self._param((out_features,), bias_attr,
                                    is_bias=True)

    def forward(self, x):
        return F.fused_linear(x, self._parameters["weight"],
                              self._parameters["bias"],
                              transpose_weight=self.transpose_weight)


class FusedDropoutAdd(_Fused):
    """dropout(x) + y in one op (reference layer.py:301)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 generator=None):
        super().__init__()
        self._setup(None, None, generator)
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F.fused_dropout_add(x, y, p=self.p, training=self.training,
                                   mode=self.mode, generator=self.generator)


class FusedEcMoe(_Fused):
    """Soft expert-choice MoE FFN over ``functional.fused_ec_moe``
    (reference layer.py:316); bmm1's weight is [experts, inter, hidden]."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None, *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        if act_type not in ("gelu", "relu"):
            raise ValueError("act_type must be gelu or relu")
        if bias_attr is False:
            raise NotImplementedError(
                "fused_ec_moe always applies expert biases (the "
                "reference kernel has no bias-free variant); pass "
                "bias_attr=None for zero-initialized trainable biases")
        self._setup(device, init_generator)
        self.act_type = act_type
        e, h, f = num_experts, hidden_size, inter_size
        self.bmm0_weight = self._param((e, h, f), weight_attr)
        self.bmm0_bias = self._param((e, 1, f), bias_attr, is_bias=True)
        self.bmm1_weight = self._param((e, f, h), weight_attr)
        self.bmm1_bias = self._param((e, 1, h), bias_attr, is_bias=True)

    def forward(self, x, gate):
        p = self._parameters
        return F.fused_ec_moe(x, gate, p["bmm0_weight"], p["bmm0_bias"],
                              p["bmm1_weight"], p["bmm1_bias"],
                              self.act_type, _bmm1_layout="efd")
