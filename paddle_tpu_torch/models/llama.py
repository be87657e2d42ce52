"""LLaMA-family decoder LM: RMSNorm, rotary embeddings, SwiGLU and GQA
(counterpart of paddle_tpu/models/llama.py).

Module and parameter names follow paddle_tpu's exactly
(``llama.embed_tokens``, ``llama.layers.N.input_layernorm``,
``.self_attn.q_proj``/``k_proj``/``v_proj``/``o_proj``,
``.post_attention_layernorm``, ``.mlp.gate_proj``/``up_proj``/
``down_proj``, ``llama.norm``, ``lm_head``), and Linear weights keep the
[in, out] layout, so a paddle_tpu state_dict loads name for name
(``convert.llama_params_from_numpy``).

RMSNorm runs the plain op, as the reference's layer does (its fused
kernel B5 is reached only through ``incubate.nn.functional.
fused_rms_norm``). Attention runs ``fused_flash_attention`` when the
config sets ``use_flash_attention`` (GQA native in B1), else repeats the
kv heads and calls ``scaled_dot_product_attention``, which on the card
routes eligible calls into the same kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import to_dtype
from ..incubate.nn.functional import (fused_flash_attention,
                                      fused_rotary_position_embedding)
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layers import Embedding, LayerList, Linear, RMSNorm

__all__ = ["LlamaConfig", "llama_tiny", "llama2_7b", "llama2_13b",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0  # 0 -> num_heads (MHA); < num_heads -> GQA
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = False

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=256,
                       max_position_embeddings=256, **kw)


def llama2_7b(**kw):
    return LlamaConfig(**kw)


def llama2_13b(**kw):
    return LlamaConfig(hidden_size=5120, num_layers=40, num_heads=40,
                       intermediate_size=13824, **kw)


def _rope_cos_sin(seq_len, head_dim, theta, dtype, device=None):
    """Full-width rotary tables (cos, sin), each [seq_len, head_dim] in
    `dtype`: f32 frequencies, the two halves repeated (neox layout)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    freqs = torch.outer(pos, inv)                            # [s, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)                  # [s, d]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _normal(config: LlamaConfig) -> Normal:
    """The initializer of the embedding and every projection:
    normal(0, initializer_range), as the reference draws them; `fk`'s
    ``init_generator`` draws it."""
    return Normal(0.0, config.initializer_range)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **fk):
        super().__init__()
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = config.head_dim
        self.hidden_size = config.hidden_size
        self.rope_theta = config.rope_theta
        kv_out = self.num_kv_heads * self.head_dim
        h, w = config.hidden_size, _normal(config)
        self.q_proj = Linear(h, h, w, bias_attr=False, **fk)
        self.k_proj = Linear(h, kv_out, w, bias_attr=False, **fk)
        self.v_proj = Linear(h, kv_out, w, bias_attr=False, **fk)
        self.o_proj = Linear(h, h, w, bias_attr=False, **fk)
        self.use_flash_attention = config.use_flash_attention

    def forward(self, x, rope_cos_sin=None):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if rope_cos_sin is None:
            rope_cos_sin = _rope_cos_sin(s, self.head_dim, self.rope_theta,
                                         q.dtype, q.device)
        cos, sin = rope_cos_sin
        q, k = fused_rotary_position_embedding(q, k, sin=sin, cos=cos)
        if self.use_flash_attention:
            # GQA stays native: B1 maps q head h to kv head h // (H / Hk)
            out = fused_flash_attention(q, k, v, causal=True)
        else:
            if self.num_kv_heads != self.num_heads:
                rep = self.num_heads // self.num_kv_heads
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, self.hidden_size))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, **fk):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        w = _normal(config)
        self.gate_proj = Linear(h, i, w, bias_attr=False, **fk)
        self.up_proj = Linear(h, i, w, bias_attr=False, **fk)
        self.down_proj = Linear(i, h, w, bias_attr=False, **fk)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **fk):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **fk)
        self.self_attn = LlamaAttention(config, **fk)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **fk)
        self.mlp = LlamaMLP(config, **fk)

    def forward(self, x, rope_cos_sin=None):
        x = x + self.self_attn(self.input_layernorm(x), rope_cos_sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **fk):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      weight_attr=_normal(config), **fk)
        self.layers = LayerList(
            [LlamaDecoderLayer(config, **fk)
             for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **fk)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        # the rope tables are shared by every layer: built once
        cfg = self.config
        rope = _rope_cos_sin(input_ids.shape[-1], cfg.head_dim,
                             cfg.rope_theta, x.dtype, x.device)
        for layer in self.layers:
            x = layer(x, rope)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LLaMA with an untied LM head producing [b, s, vocab] logits.

    device: None = the CUDA card (raises without one), or "cpu" by
    request. Weights are drawn on the device from a ``torch.Generator``
    seeded with ``seed``: normal(0, initializer_range) for the embedding
    and every projection, as in paddle_tpu; RMSNorm weights 1. A 7B model
    is thus never drawn on the host."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        init_gen = torch.Generator(device=dev)
        init_gen.manual_seed(seed)
        fk = {"device": dev, "dtype": to_dtype(dtype),
              "init_generator": init_gen}
        self.config = config
        self.llama = LlamaModel(config, **fk)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              _normal(config), bias_attr=False, **fk)

    @property
    def device(self) -> torch.device:
        return self.llama.norm.weight._data.device

    def forward(self, input_ids):
        return self.lm_head(self.llama(input_ids))
