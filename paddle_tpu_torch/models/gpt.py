"""GPT decoder-only LM (counterpart of paddle_tpu/models/gpt.py).

Module and parameter names follow paddle_tpu's exactly
(``gpt.embeddings.word_embeddings``, ``gpt.layers.N.ln1``,
``.attn.qkv_proj``, ``.attn.out_proj``, ``.mlp.fc1``/``fc2``, ``.ln2``,
``gpt.final_norm``), and Linear weights keep the [in, out] layout, so a
paddle_tpu state_dict loads name for name (see ``convert.py``). The
fused qkv columns are [q all heads | k | v].

The forward pass without a cache runs the plain attention composite;
on a TPU paddle_tpu routes that call into its flash-attention kernel,
which the port brings with the training slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import to_dtype
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["GPTConfig", "gpt_tiny", "gpt2_small", "gpt3_1p3b",
           "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTModel", "GPTForCausalLM"]


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

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size

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


class GPTAttention(nn.Module):
    """Causal self-attention with a fused QKV projection."""

    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.hidden_size = config.hidden_size
        self.qkv_proj = Linear(config.hidden_size, 3 * config.hidden_size,
                               **fk)
        self.out_proj = Linear(config.hidden_size, config.hidden_size, **fk)

    def forward(self, x):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)                      # [b, s, h, d]
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.reshape(b, s, self.hidden_size))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **fk):
        super().__init__()
        self.fc1 = Linear(config.hidden_size, config.intermediate_size, **fk)
        self.fc2 = Linear(config.intermediate_size, config.hidden_size, **fk)

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
                                         config.hidden_size, **fk)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **fk)
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
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class GPTForCausalLM(nn.Module):
    """GPT with a (tied) LM head producing [b, s, vocab] logits.

    device: None = the CUDA card (raises without one), or "cpu" by
    request. Weights are drawn on the device from a ``torch.Generator``
    seeded with ``seed``: normal(0, initializer_range), with the
    residual projections (out_proj, fc2) scaled by 1/sqrt(2 * layers)
    as in paddle_tpu; biases 0, LayerNorm weights 1."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        if config.use_flash_attention or config.recompute:
            raise NotImplementedError(
                "use_flash_attention and recompute belong to the training "
                "slice, which the port does not have yet")
        dev = resolve_device(device)
        fk = {"device": dev, "dtype": to_dtype(dtype)}
        self.config = config
        self.gpt = GPTModel(config, **fk)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias=False, **fk)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        cfg = self.config
        gen = torch.Generator(device=self.gpt.final_norm.weight.device)
        gen.manual_seed(seed)
        std = cfg.initializer_range
        out_std = std / math.sqrt(2 * cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("bias") or ".ln" in name \
                    or "final_norm" in name:
                continue            # constructed as 0 (bias) / 1 (LN)
            s = out_std if (".out_proj." in name or ".fc2." in name) \
                else std
            p.normal_(0.0, s, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.final_norm.weight.device

    def lm_logits(self, hidden):
        """Project hidden states to vocab logits (tied or untied head)."""
        if self.lm_head is None:
            w = self.gpt.embeddings.word_embeddings.weight
            return torch.matmul(hidden, w.t())
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None):
        return self.lm_logits(self.gpt(input_ids, position_ids))
