"""BERT encoder + MLM head (counterpart of paddle_tpu/models/bert.py).

Built on ``nn.TransformerEncoder`` (post-LN, GELU), as the reference is,
so its attention goes through ``scaled_dot_product_attention``: on the
CUDA card an unmasked call without live dropout runs the flash kernels
B1/B2 (non-causal); a call with ``attention_mask`` runs the composite,
as in the reference. Module and parameter names are the reference's
(``bert.embeddings.word_embeddings``, ``bert.encoder.layers.N.self_attn
.q_proj``, ``.linear1``, ``.norm1``, ``bert.pooler``, ``transform``,
``transform_norm``, ``decoder_bias``), Linear weights [in, out], so a
reference state_dict loads name for name (``convert.bert_params_from_
numpy``). The MLM decoder is tied to the word embeddings.

As in the reference, the encoder deep-copies one initialised layer, so
all its layers start with the same weights; the pooler's output is
computed and unused by the MLM loss, so the pooler (and, without
``token_type_ids``, the token-type embeddings) get no gradient:
TrainStep gives them zeros, as ``jax.grad`` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn import functional as F
from ..nn.initializer import Constant, Normal
from ..nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                         MultiHeadAttention, TransformerEncoder,
                         TransformerEncoderLayer)
from ..nn.layers.common import _drawn, _factory

__all__ = ["BertConfig", "bert_tiny", "bert_base", "BertEmbeddings",
           "BertModel", "BertForMaskedLM"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=256,
                      max_position_embeddings=128, **kw)


def bert_base(**kw):
    return BertConfig(**kw)


class BertEmbeddings(nn.Module):
    """Word + position (+ token-type) embeddings, each drawn from
    Normal(0, initializer_range), then LayerNorm and dropout.
    `init_generator`: the torch.Generator the weights are drawn from
    (None: torch's default generator of the device)."""

    def __init__(self, config: BertConfig, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__()
        fk = _factory(device, dtype)
        w = Normal(std=config.initializer_range)
        h = config.hidden_size
        for name, rows in (("word_embeddings", config.vocab_size),
                           ("position_embeddings",
                            config.max_position_embeddings),
                           ("token_type_embeddings",
                            config.type_vocab_size)):
            setattr(self, name, Embedding(rows, h, weight_attr=w,
                                          init_generator=init_generator,
                                          **fk))
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **fk)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Module):
    """Embeddings, a post-LN GELU TransformerEncoder of one layer
    deep-copied ``num_layers`` times, and a tanh pooler over the first
    token. Returns (hidden [b, s, h], pooled [b, h]). Construction as
    for BertEmbeddings."""

    def __init__(self, config: BertConfig, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__()
        fk = _factory(device, dtype)
        self.config = config
        self.embeddings = BertEmbeddings(
            config, init_generator=init_generator, **fk)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_heads, config.intermediate_size,
            dropout=config.hidden_dropout_prob, activation="gelu",
            attn_dropout=config.attention_dropout_prob,
            normalize_before=False, layer_norm_eps=config.layer_norm_eps,
            init_generator=init_generator, **fk)
        self.encoder = TransformerEncoder(enc_layer, config.num_layers)
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             init_generator=init_generator, **fk)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [b, s] 1/0 mask -> additive [b, 1, 1, s]
            m = attention_mask.reshape(attention_mask.shape[0], 1, 1, -1)
            attention_mask = (1.0 - m.float()) * -1e9
        x = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForMaskedLM(nn.Module):
    """BertModel with the MLM head: transform, GELU, LayerNorm, then the
    decoder tied to the word embeddings plus ``decoder_bias``. With
    `labels` ([b, s], -100 where no token is predicted) returns (loss,
    logits), else logits.

    device: None = the CUDA card (raises without one), or "cpu" by
    request. Weights are drawn on the device from a ``torch.Generator``
    seeded with ``seed``, by the reference's initializers: Normal(0,
    initializer_range) for the embeddings, XavierUniform for every
    Linear weight, 0 for biases and ``decoder_bias``, LayerNorm 1 and 0.
    Dropout masks (hidden and attention) are drawn from a second
    generator on the device, seeded with ``seed + 1``."""

    def __init__(self, config: BertConfig, *, device=None, dtype="float32",
                 seed: int = 0):
        super().__init__()
        fk = _factory(device, dtype)
        gen = torch.Generator(device=fk["device"])
        gen.manual_seed(seed)
        self.config = config
        self.bert = BertModel(config, init_generator=gen, **fk)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                init_generator=gen, **fk)
        self.transform_norm = LayerNorm(config.hidden_size,
                                        config.layer_norm_eps, **fk)
        self.decoder_bias = _drawn(Constant(0.0), (config.vocab_size,), fk,
                                   gen)
        # assigned after construction: the encoder's deep copies never
        # copy a generator, and TrainStep registers this one with its
        # graphs
        masks = torch.Generator(device=fk["device"])
        masks.manual_seed(seed + 1)
        for m in self.modules():
            if isinstance(m, (Dropout, MultiHeadAttention)):
                m.generator = masks

    @property
    def device(self) -> torch.device:
        return self.decoder_bias.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        hidden, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(hidden)))
        w = self.bert.embeddings.word_embeddings.weight._data
        logits = F.matmul(h, w, transpose_y=True) + self.decoder_bias
        if labels is not None:
            loss = F.cross_entropy(logits, labels, ignore_index=-100)
            return loss, logits
        return logits
