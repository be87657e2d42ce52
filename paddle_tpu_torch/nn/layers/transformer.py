"""Transformer layers (counterpart of paddle_tpu/nn/layers/transformer.py).

``MultiHeadAttention`` computes attention with
``functional.scaled_dot_product_attention``, which on the CUDA card
routes an eligible call (no mask, no live dropout, shapes the kernels
take) into the flash-attention kernels B1/B2, as the reference routes
it into its TPU kernel. Parameter names and layouts are the
reference's (Linear weights [in, out]), so a reference state_dict loads
name for name.

The layers are ``Layer``s on the reference's constructors, plus the
port's keyword-only ``device`` (None: the default place, which is the
card, raising without one, unless ``set_device("cpu")``), ``dtype``
and ``init_generator``, the ``torch.Generator`` the initial weights are
drawn from (None: the port's default generator; no layer keeps it).
Defaults are the reference's: Linear weights ``XavierUniform``, biases
0 (``weight_attr`` / ``bias_attr`` take a ``ParamAttr`` or an
initializer; ``bias_attr=False`` drops the bias), LayerNorm 1 and 0.
Dropout masks, here and in the composite attention, are drawn from the
``generator`` attribute of each ``Dropout`` and ``MultiHeadAttention``
(None: torch's default generator), which a model sets after
construction.

As in the reference, ``TransformerEncoder`` and ``TransformerDecoder``
deep-copy the one layer they are given, so every layer of the stack
starts with the same weights.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core.device import resolve_device
from .. import functional as F
from ..layer import Layer, layer_device
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__(dtype=dtype)
        fk = {"device": layer_device(device), "dtype": dtype}
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        attrs = (weight_attr, bias_attr)
        fk["init_generator"] = init_generator
        self.q_proj = Linear(embed_dim, embed_dim, *attrs, **fk)
        self.k_proj = Linear(kdim, embed_dim, *attrs, **fk)
        self.v_proj = Linear(vdim, embed_dim, *attrs, **fk)
        self.out_proj = Linear(embed_dim, embed_dim, *attrs, **fk)
        self.generator = None   # attention-dropout masks (composite path)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape([b, s, self.num_heads, self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape([b, s, self.embed_dim]))
        if isinstance(cache, self.Cache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """StaticCache: k and v projected from `key` / `value` once (a
        cross-attention's memory); otherwise an empty incremental Cache
        [b, 0, heads, head_dim] that each call extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__(dtype=dtype)
        fk = {"device": layer_device(device), "dtype": dtype}
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, init_generator=init_generator, **fk)
        attrs = (weight_attr, bias_attr)
        gk = dict(fk, init_generator=init_generator)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **gk)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **gk)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **fk)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **fk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(F, self.activation)(x)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self._act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        # the reference's copies: every layer starts as `encoder_layer`
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__(dtype=dtype)
        fk = {"device": layer_device(device), "dtype": dtype}
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        mha = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                   init_generator=init_generator, **fk)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **mha)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **mha)
        attrs = (weight_attr, bias_attr)
        gk = dict(fk, init_generator=init_generator)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **gk)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **gk)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **fk)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **fk)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **fk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(
            getattr(F, self.activation)(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        fk = {"device": layer_device(device), "dtype": dtype}
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                *args, init_generator=init_generator, **fk)
            enc_norm = LayerNorm(d_model, **fk) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                *args, init_generator=init_generator, **fk)
            dec_norm = LayerNorm(d_model, **fk) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """[length, length] f32 additive causal mask: 0 on and below the
        diagonal, -inf above. `device` None is the CUDA card."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.zeros(keep.shape, dtype=torch.float32,
                           device=keep.device).masked_fill(~keep,
                                                           float("-inf"))
