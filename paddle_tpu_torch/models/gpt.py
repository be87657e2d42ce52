"""GPT decoder-only LM (counterpart of paddle_tpu/models/gpt.py).

Module and parameter names follow paddle_tpu's exactly
(``gpt.embeddings.word_embeddings``, ``gpt.layers.N.ln1``,
``.attn.qkv_proj``, ``.attn.out_proj``, ``.mlp.fc1``/``fc2``, ``.ln2``,
``gpt.final_norm``), and Linear weights keep the [in, out] layout, so a
paddle_tpu state_dict loads name for name (see ``convert.py``). The
fused qkv columns are [q all heads | k | v].

Attention runs ``fused_flash_attention`` when the config sets
``use_flash_attention``, else ``scaled_dot_product_attention``, which on
the CUDA card routes eligible calls into the same kernels (as
paddle_tpu does on its TPU). With ``recompute``, training recomputes
every ``recompute_interval``-th decoder block in the backward
(``distributed.meta_parallel.recompute``), as paddle_tpu does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import to_dtype
from ..distributed.meta_parallel import recompute
from ..incubate.nn.functional import fused_flash_attention
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layers import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["GPTConfig", "gpt_tiny", "gpt2_small", "gpt3_1p3b", "gpt3_6p7b",
           "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion",
           "num_params"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0  # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    use_flash_attention: bool = False
    recompute: bool = False
    # remat save-policy and interval (paddle_tpu models/gpt.py:39-47),
    # validated as there
    recompute_policy: str = "full"
    recompute_interval: int = 1

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.recompute_interval < 1:
            raise ValueError(
                f"recompute_interval must be >= 1 (got "
                f"{self.recompute_interval}); use recompute=False to "
                "disable remat")
        if self.recompute_policy not in ("full", "dots",
                                         "dots_no_batch"):
            raise ValueError(
                f"unknown recompute_policy {self.recompute_policy!r}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_position_embeddings=256, **kw)


def gpt2_small(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024, **kw)


def gpt3_1p3b(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_position_embeddings=2048, **kw)


def gpt3_6p7b(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=4096, num_layers=32,
                     num_heads=32, max_position_embeddings=2048, **kw)


def _normal(config: GPTConfig, residual: bool = False) -> Normal:
    """A GPT weight's initializer: normal(0, initializer_range), the
    residual projections (out_proj, fc2) scaled by 1/sqrt(2 * layers),
    as the reference draws them; `fk`'s ``init_generator`` draws it."""
    std = config.initializer_range
    return Normal(0.0, std / math.sqrt(2 * config.num_layers)
                  if residual else std)


class GPTAttention(nn.Module):
    """Causal self-attention with a fused QKV projection. `generator`
    (set by GPTForCausalLM) draws the attention-dropout masks of the
    composite path; the flash path has no attention dropout, as in
    paddle_tpu (fused_flash_attention is called with dropout 0)."""

    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.hidden_size = config.hidden_size
        self.qkv_proj = Linear(config.hidden_size, 3 * config.hidden_size,
                               _normal(config), **fk)
        self.out_proj = Linear(config.hidden_size, config.hidden_size,
                               _normal(config, residual=True), **fk)
        self.attn_dropout_prob = config.attention_dropout_prob
        self.use_flash_attention = config.use_flash_attention
        self.generator = None

    def forward(self, x):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)                      # [b, s, h, d]
        if self.use_flash_attention:
            out = fused_flash_attention(q, k, v, causal=True)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout_prob,
                training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, self.hidden_size))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.fc1 = Linear(config.hidden_size, config.intermediate_size,
                          _normal(config), **fk)
        self.fc2 = Linear(config.intermediate_size, config.hidden_size,
                          _normal(config, residual=True), **fk)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size, config.layer_norm_eps, **fk)
        self.attn = GPTAttention(config, **fk)
        self.ln2 = LayerNorm(config.hidden_size, config.layer_norm_eps, **fk)
        self.mlp = GPTMLP(config, **fk)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln1(x)))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size,
                                         weight_attr=_normal(config), **fk)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=_normal(config), **fk)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        return self.dropout(x)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **fk)
        self.layers = LayerList(
            [GPTDecoderLayer(config, **fk) for _ in range(config.num_layers)])
        self.final_norm = LayerNorm(config.hidden_size,
                                    config.layer_norm_eps, **fk)

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        cfg = self.config
        remat = cfg.recompute and self.training
        pol = cfg.recompute_policy
        for i, layer in enumerate(self.layers):
            if remat and i % cfg.recompute_interval == 0:
                # paddle_tpu models/gpt.py:203-216
                x = recompute(layer, x,
                              policy=None if pol == "full" else pol)
            else:
                x = layer(x)
        return self.final_norm(x)


class GPTForCausalLM(nn.Module):
    """GPT with a (tied) LM head producing [b, s, vocab] logits.

    device: None = the CUDA card (raises without one), or "cpu" by
    request. Weights are drawn on the device from a ``torch.Generator``
    seeded with ``seed``: normal(0, initializer_range), with the
    residual projections (out_proj, fc2) scaled by 1/sqrt(2 * layers)
    as in paddle_tpu; biases 0, LayerNorm weights 1. Dropout masks are
    drawn from a second generator on the device, seeded with
    ``seed + 1``."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        init_gen = torch.Generator(device=dev)
        init_gen.manual_seed(seed)
        fk = {"device": dev, "dtype": to_dtype(dtype),
              "init_generator": init_gen}
        self.config = config
        self.gpt = GPTModel(config, **fk)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, _normal(config),
            bias_attr=False, **fk)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        for m in self.modules():
            if isinstance(m, (Dropout, GPTAttention)):
                m.generator = gen

    @property
    def device(self) -> torch.device:
        return self.gpt.final_norm.weight._data.device

    def attention_shape(self) -> dict:
        """The attention a training step runs, for `TrainStep`'s shape
        count (`observability.perf.count_cost`, ``train_step``)."""
        c = self.config
        return dict(layers=c.num_layers, heads=c.num_heads,
                    head_dim=c.hidden_size // c.num_heads, causal=True)

    def lm_logits(self, hidden):
        """Project hidden states to vocab logits (tied or untied head)."""
        if self.lm_head is None:
            w = self.gpt.embeddings.word_embeddings.weight._data
            return F.matmul(hidden, w, transpose_y=True)
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None):
        return self.lm_logits(self.gpt(input_ids, position_ids))


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross-entropy (labels = input shifted by the caller),
    paddle_tpu models/gpt.py:261: the mean over tokens, or the
    loss_mask-weighted mean."""

    def forward(self, logits, labels, loss_mask=None):
        loss = F.cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            loss_mask = loss_mask.reshape(loss.shape)
            return (loss * loss_mask).sum() / torch.clamp(
                loss_mask.sum(), min=1e-6)
        return loss.mean()


def num_params(config: GPTConfig) -> int:
    """Parameter count (for MFU math), paddle_tpu models/gpt.py:273."""
    h, v, L = config.hidden_size, config.vocab_size, config.num_layers
    i = config.intermediate_size
    per_layer = (3 * h * h + 3 * h) + (h * h + h) + (h * i + i) + (
        i * h + h) + 4 * h
    emb = v * h + config.max_position_embeddings * h
    head = 0 if config.tie_word_embeddings else v * h
    return emb + L * per_layer + 2 * h + head
