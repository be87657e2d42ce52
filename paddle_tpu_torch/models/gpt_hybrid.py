"""The hybrid-parallel GPT: tensor parallel (the mpu layers) x pipeline
(PipelineLayer) x data parallel / sharding (counterpart of
paddle_tpu/models/gpt_hybrid.py).

The reference's layout: a vocab-parallel word embedding, column- and
row-parallel attention and MLP, pipeline parts cut on decoder-block
boundaries and the tied LM head through a SharedLayerDesc. Module and
parameter names are the reference's, so a reference state_dict loads
name for name (``convert.hybrid_gpt_params_from_numpy``).

With one controller every layer holds the whole weight and computes
the dense function. In process-group mode at mp > 1 each rank holds its
shard: the fused QKV projection's columns are this rank's heads of q, of
k and of v (``num_heads // mp`` heads each; ``convert.mp_shard_state``
cuts a whole state so), attention runs on those heads, and the tied
head's vocab-split logits are gathered, so the model returns the full
logits as the reference does. Attention is
``scaled_dot_product_attention``, which on the card sends an eligible
call to the flash kernels.

Requires fleet.init(...) (the hybrid group) before construction.
"""
from __future__ import annotations

import math

import torch

from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import Layer
from ..nn.layers import Dropout, Embedding, LayerList, LayerNorm
from ..ops.registry import eager_method
from .gpt import GPTConfig

__all__ = ["HybridGPTAttention", "HybridGPTMLP", "HybridGPTBlock",
           "HybridGPTEmbedding", "HybridGPTNorm", "GPTForCausalLMHybrid",
           "gpt_pipeline_model"]


def _mpu():
    from ..distributed.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    return (VocabParallelEmbedding, ColumnParallelLinear,
            RowParallelLinear, ParallelCrossEntropy)


def _mp_ranks(layer) -> int:
    """The ranks a process-group mpu layer splits over (1 with one
    controller)."""
    g = layer._group
    return 1 if g is None else g.nranks


class HybridGPTAttention(Layer):
    """Megatron attention: column-parallel QKV, row-parallel output."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        _, Col, Row, _ = _mpu()
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.hidden_size = config.hidden_size
        w = Normal(std=config.initializer_range)
        ow = Normal(std=config.initializer_range /
                    math.sqrt(2 * config.num_layers))
        self.qkv_proj = Col(config.hidden_size, 3 * config.hidden_size,
                            weight_attr=w, gather_output=False)
        self.out_proj = Row(config.hidden_size, config.hidden_size,
                            weight_attr=ow, input_is_parallel=True)
        self.dropout_p = config.attention_dropout_prob

    @eager_method
    def forward(self, x):
        b, s, _ = x.shape
        heads = self.num_heads // _mp_ranks(self.qkv_proj)
        qkv = self.qkv_proj(x)      # [b, s, 3h], this rank's heads
        qkv = qkv.reshape(b, s, 3, heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout_p,
            training=self.training)
        return self.out_proj(out.reshape(b, s, heads * self.head_dim))


class HybridGPTMLP(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        _, Col, Row, _ = _mpu()
        w = Normal(std=config.initializer_range)
        ow = Normal(std=config.initializer_range /
                    math.sqrt(2 * config.num_layers))
        self.fc1 = Col(config.hidden_size, config.intermediate_size,
                       weight_attr=w, gather_output=False)
        self.fc2 = Row(config.intermediate_size, config.hidden_size,
                       weight_attr=ow, input_is_parallel=True)

    @eager_method
    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class HybridGPTBlock(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.attn = HybridGPTAttention(config)
        self.ln2 = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.mlp = HybridGPTMLP(config)
        self.dropout = Dropout(config.hidden_dropout_prob)

    @eager_method
    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln1(x)))
        x = x + self.dropout(self.mlp(self.ln2(x)))
        return x


class HybridGPTEmbedding(Layer):
    """A vocab-parallel word embedding and a replicated position
    embedding."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        Vocab, _, _, _ = _mpu()
        w = Normal(std=config.initializer_range)
        self.word_embeddings = Vocab(config.vocab_size, config.hidden_size,
                                     weight_attr=w)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=w)
        self.dropout = Dropout(config.hidden_dropout_prob)

    @eager_method
    def forward(self, input_ids):
        s = input_ids.shape[-1]
        pos = torch.arange(s, dtype=torch.int32, device=input_ids.device)
        return self.dropout(self.word_embeddings(input_ids) +
                            self.position_embeddings(pos))

    @eager_method
    def head(self, hidden):
        """The tied LM head: the vocab logits (in process-group mode the
        input's gradient summed over the group and the vocab-split
        logits gathered)."""
        emb = self.word_embeddings
        w = emb._parameters["weight"]
        if emb._group is None:
            return F.matmul(hidden, w, transpose_y=True)
        from ..distributed.meta_parallel.mp_layers import (_c_concat,
                                                            _c_identity)
        return _c_concat(F.matmul(_c_identity(hidden, emb._group), w,
                                  transpose_y=True), emb._group)


class HybridGPTNorm(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.norm = LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, x):
        return self.norm(x)


class GPTForCausalLMHybrid(Layer):
    """The hybrid GPT without a pipeline (TP + DP / sharding by fleet)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embeddings = HybridGPTEmbedding(config)
        self.layers = LayerList(
            [HybridGPTBlock(config) for _ in range(config.num_layers)])
        self.final_norm = HybridGPTNorm(config)

    @eager_method
    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for blk in self.layers:
            x = blk(x)
        x = self.final_norm(x)
        return self.embeddings.head(x)


def gpt_pipeline_model(config: GPTConfig, loss_fn=None,
                       recompute_interval=0):
    """The PipelineLayer description of the hybrid GPT (pp >= 1), the
    embeddings tied through a SharedLayerDesc."""
    from ..distributed.meta_parallel import (LayerDesc, PipelineLayer,
                                             SharedLayerDesc)

    descs = [
        SharedLayerDesc("embed", HybridGPTEmbedding, config),
    ]
    for _ in range(config.num_layers):
        descs.append(LayerDesc(HybridGPTBlock, config))
    descs.append(LayerDesc(HybridGPTNorm, config))
    descs.append(SharedLayerDesc(
        "embed", HybridGPTEmbedding, config,
        forward_func=lambda layer, x: layer.head(x)))

    if loss_fn is None:
        def loss_fn(logits, labels):
            return F.cross_entropy(logits, labels,
                                   reduction="none").mean()
    return PipelineLayer(layers=descs, loss_fn=loss_fn,
                         seg_method="layer:HybridGPTBlock",
                         recompute_interval=recompute_interval)
