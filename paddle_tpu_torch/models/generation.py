"""Autoregressive decoding for the GPT family (counterpart of
paddle_tpu/models/generation.py): the dense, per-request oracle that
the serving engine is held to.

The KV cache is preallocated at [b, max_len, heads, head_dim] and
written in place; attention over the padded cache is masked by
position. paddle_tpu compiles the decode loop into one executable; the
port runs the same steps as an eager loop.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..nn import functional as F

__all__ = ["generate"]


def _static_cache(model, batch, max_len, dtype):
    """One [b, max_len, heads, head_dim] k/v pair per layer."""
    cfg = model.config
    shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=model.device),
             "v": torch.zeros(shape, dtype=dtype, device=model.device)}
            for _ in range(cfg.num_layers)]


def _decode_attention(attn, x, cache, pos):
    """Chunk attention against the static cache, writing the chunk's k/v
    in place at [pos, pos+s). x: [b, s, hidden]; pos: tokens already in
    the cache."""
    b, s, _ = x.shape
    qkv = attn.qkv_proj(x).reshape(b, s, 3, attn.num_heads, attn.head_dim)
    q, k, v = qkv.unbind(dim=2)
    cache["k"][:, pos:pos + s] = k
    cache["v"][:, pos:pos + s] = v
    max_len = cache["k"].shape[1]
    kpos = torch.arange(max_len, device=x.device)[None, :]
    qpos = pos + torch.arange(s, device=x.device)[:, None]
    mask = (kpos <= qpos)[None, None]                    # [1, 1, s, L]
    out = F.scaled_dot_product_attention(q, cache["k"], cache["v"],
                                         attn_mask=mask)
    return attn.out_proj(out.reshape(b, s, attn.hidden_size)), cache


def _forward_with_cache(model, input_ids, caches, pos):
    """GPT trunk forward writing into the static caches at `pos`; only
    the LAST position's logits are returned."""
    gpt = model.gpt
    s = input_ids.shape[-1]
    position_ids = pos + torch.arange(s, device=input_ids.device)
    x = gpt.embeddings(input_ids, position_ids)
    for layer, cache in zip(gpt.layers, caches):
        h, _ = _decode_attention(layer.attn, layer.ln1(x), cache, pos)
        x = x + h
        x = x + layer.mlp(layer.ln2(x))
    x = gpt.final_norm(x)
    return model.lm_logits(x[:, -1:]), caches


def _pick_token(lf, generator, do_sample, temperature, top_p, top_k=0):
    """Greedy / temperature+top-k+top-p token selection, shared by
    `generate` and the serving engine. lf: [b, vocab] f32 logits;
    `generator` (a torch.Generator on lf's device) drives sampling and
    is unused by greedy. Returns next ids [b] int64."""
    if not do_sample:
        return torch.argmax(lf, dim=-1)
    lt = lf / max(temperature, 1e-6)
    if top_k and 0 < top_k < lt.shape[-1]:
        kth = torch.topk(lt, int(top_k), dim=-1).values[..., -1:]
        lt = lt.masked_fill(lt < kth, float("-inf"))
    probs = torch.softmax(lt, dim=-1)
    if top_p < 1.0:
        # nucleus: keep the smallest high-probability set whose mass
        # reaches top_p (the token that crosses it included)
        sp, idx = torch.sort(probs, dim=-1, descending=True)
        drop = (torch.cumsum(sp, dim=-1) - sp) >= top_p
        sp = sp.masked_fill(drop, 0.0)
        pick = torch.multinomial(sp, 1, generator=generator)
        return idx.gather(-1, pick).squeeze(-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_p=1.0, top_k=0, eos_token_id=None,
             seed=0, device=None):
    """Greedy / sampled decode for GPT causal LMs.

    input_ids: [b, prompt_len] ints (array or tensor). Returns a
    [b, prompt_len + max_new_tokens] int32 tensor (positions after an
    eos stay eos). device: None = the CUDA card; the model must live on
    the resolved device."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(
            f"generate: model lives on {model.device}, not on {dev}")
    ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
    b, prompt_len = ids.shape
    cfg = model.config
    max_len = prompt_len + max_new_tokens
    if max_len > cfg.max_position_embeddings:
        raise ValueError(
            f"generate: {max_len} tokens exceed max_position_embeddings "
            f"({cfg.max_position_embeddings})")
    # the cache rounds up to a 128 bucket as paddle_tpu's does; the
    # padded tail is masked out of every attention row
    max_len = min(((max_len + 127) // 128) * 128,
                  cfg.max_position_embeddings)
    was_training = model.training
    model.eval()
    emb_dtype = model.gpt.embeddings.word_embeddings.weight.dtype
    caches = _static_cache(model, b, max_len, emb_dtype)
    gen = None
    if do_sample:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    try:
        logits, caches = _forward_with_cache(model, ids, caches, 0)
        nxt = _pick_token(logits[:, -1].float(), gen, do_sample,
                          temperature, top_p, top_k)
        out = torch.cat([ids, torch.zeros((b, max_new_tokens),
                                          dtype=torch.int64, device=dev)],
                        dim=1)
        out[:, prompt_len] = nxt
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        for step in range(1, max_new_tokens):
            pos = prompt_len + step - 1
            if eos_token_id is not None:
                finished = finished | (nxt == eos_token_id)
            logits, caches = _forward_with_cache(model, nxt[:, None],
                                                 caches, pos)
            nxt = _pick_token(logits[:, -1].float(), gen, do_sample,
                              temperature, top_p, top_k)
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
            out[:, prompt_len + step] = nxt
    finally:
        if was_training:
            model.train()
    return out.to(torch.int32)
