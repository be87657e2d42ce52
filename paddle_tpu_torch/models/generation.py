"""Autoregressive decoding for the GPT and LLaMA families (counterpart
of paddle_tpu/models/generation.py): the dense, per-request oracle that
the serving engine is held to (``_family`` picks the family).

The KV cache is preallocated at [b, max_len, kv_heads, head_dim] (GQA
kv heads stored un-repeated) and written in place; attention over the
padded cache is masked by position, with the position a 0-d device
tensor. paddle_tpu compiles the prefill and the whole decode loop into
cached executables (`use_fused_step=True`, the default); the port
captures the prefill and one decode step as CUDA graphs over a cached
static state and replays the step once a token. `use_fused_step=False`
is the eager per-step loop, the conformance oracle.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from ..core.device import resolve_device
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..jit.cuda_graph import CapturedStep, GraphCache
from ..nn import functional as F
from .llama import _rope_cos_sin

__all__ = ["generate"]


def _static_cache(model, batch, max_len, dtype):
    """One [b, max_len, kv_heads, head_dim] k/v pair per layer; a model
    with num_kv_heads < num_heads stores its GQA cache un-repeated."""
    cfg = model.config
    kv_heads = getattr(cfg, "num_kv_heads", None) or cfg.num_heads
    shape = (batch, max_len, kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=model.device),
             "v": torch.zeros(shape, dtype=dtype, device=model.device)}
            for _ in range(cfg.num_layers)]


def _decode_attention(attn, x, cache, pos):
    """Chunk attention against the static cache, writing the chunk's k/v
    in place at positions [pos, pos+s). x: [b, s, hidden]; pos: a 0-d
    int64 tensor on x's device, the tokens already in the cache (a
    device value, so one captured graph serves every position)."""
    b, s, _ = x.shape
    qkv = attn.qkv_proj(x).reshape(b, s, 3, attn.num_heads, attn.head_dim)
    q, k, v = qkv.unbind(dim=2)
    at = pos + torch.arange(s, device=x.device)              # [s]
    cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
    max_len = cache["k"].shape[1]
    kpos = torch.arange(max_len, device=x.device)[None, :]
    mask = (kpos <= at[:, None])[None, None]             # [1, 1, s, L]
    out = F.scaled_dot_product_attention(q, cache["k"], cache["v"],
                                         attn_mask=mask)
    return attn.out_proj(out.reshape(b, s, attn.hidden_size)), cache


def _forward_with_cache(model, input_ids, caches, pos):
    """GPT trunk forward writing into the static caches at `pos` (0-d
    device tensor); only the LAST position's logits are returned."""
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


def _llama_decode_attention(attn, x, cache, pos, rope_full):
    """LLaMA chunk attention against the static cache: rotary at the
    chunk's absolute positions (rows of tables built to max_len, taken
    at `pos`, a 0-d device tensor), GQA kv heads stored un-repeated in
    the cache and repeated for the attention."""
    b, s, _ = x.shape
    q = attn.q_proj(x).reshape(b, s, attn.num_heads, attn.head_dim)
    k = attn.k_proj(x).reshape(b, s, attn.num_kv_heads, attn.head_dim)
    v = attn.v_proj(x).reshape(b, s, attn.num_kv_heads, attn.head_dim)
    at = pos + torch.arange(s, device=x.device)              # [s]
    cos_full, sin_full = rope_full
    q, k = fused_rotary_position_embedding(
        q, k, sin=sin_full.index_select(0, at),
        cos=cos_full.index_select(0, at))
    cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
    kr, vr = cache["k"], cache["v"]
    if attn.num_kv_heads != attn.num_heads:
        rep = attn.num_heads // attn.num_kv_heads
        kr = kr.repeat_interleave(rep, dim=2)
        vr = vr.repeat_interleave(rep, dim=2)
    max_len = kr.shape[1]
    kpos = torch.arange(max_len, device=x.device)[None, :]
    mask = (kpos <= at[:, None])[None, None]             # [1, 1, s, L]
    out = F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
    return attn.o_proj(out.reshape(b, s, attn.hidden_size)), cache


def _llama_forward_with_cache(model, input_ids, caches, pos):
    """LLaMA trunk forward writing into the static caches at `pos` (0-d
    device tensor); only the LAST position's logits are returned."""
    trunk = model.llama
    cfg = model.config
    x = trunk.embed_tokens(input_ids)
    rope_full = _rope_cos_sin(caches[0]["k"].shape[1], cfg.head_dim,
                              cfg.rope_theta, x.dtype, x.device)
    for layer, cache in zip(trunk.layers, caches):
        h, _ = _llama_decode_attention(
            layer.self_attn, layer.input_layernorm(x), cache, pos,
            rope_full)
        x = x + h
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    x = trunk.norm(x)
    return model.lm_head(x[:, -1:]), caches


def _family(model):
    """(cached_forward, embedding_dtype) of each causal-LM family the
    decode stack supports."""
    if hasattr(model, "gpt"):
        return (_forward_with_cache,
                model.gpt.embeddings.word_embeddings.weight._data.dtype)
    if hasattr(model, "llama"):
        return (_llama_forward_with_cache,
                model.llama.embed_tokens.weight._data.dtype)
    raise NotImplementedError(
        "generate() supports the GPT and LLaMA families")


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


# cached decode loops a model keeps, least recently used dropped first
# (the reference's bound, generation.py:320)
_LOOP_CACHE = 8


class _FusedLoop:
    """The static state of `generate(use_fused_step=True)` for one key
    (sampling settings, eos id, batch size, cache bucket): the caches,
    the sampling generator, the step's token, position, finished and
    output buffers, and on the card the captured graphs: one of the
    prefill per prompt length (an LRU of `_LOOP_CACHE`) and one of the
    decode step, replayed once a token (the counterpart of the
    reference's `_build_fused_prefill` and `_build_fused_loop`). On the
    CPU the same functions run eagerly."""

    def __init__(self, model, fwd_fn, b, max_len, dtype, dev, pick,
                 eos_token_id):
        self.model, self.fwd_fn = model, fwd_fn
        self.pick, self.eos = pick, eos_token_id
        self.dev = dev
        self.caches = _static_cache(model, b, max_len, dtype)
        self.gen = torch.Generator(device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.pos0 = torch.zeros((), **i64)
        self.pos = torch.zeros((), **i64)
        self.nxt = torch.zeros((b,), **i64)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((b, max_len), **i64)
        # prompt_len -> (static ids [b, prompt_len], its prefill graph);
        # the decode step's graph shares their pool
        self.prefills = GraphCache(_LOOP_CACHE)
        self.step_graph = None
        self.params = _param_ptrs(model)

    def _prefill(self, ids):
        logits, _ = self.fwd_fn(self.model, ids, self.caches, self.pos0)
        return logits[:, -1].float()

    def prefill(self, ids):
        """Last-position f32 logits [b, vocab] of the prompt `ids`,
        written into the zeroed caches from position 0."""
        for c in self.caches:
            c["k"].zero_()
            c["v"].zero_()
        if self.dev.type == "cpu":
            return self._prefill(ids)
        n = ids.shape[1]
        entry = self.prefills.get(n)
        if entry is None:
            buf = ids.clone()
            entry = self.prefills.put(n, (buf, CapturedStep(
                "generate_prefill", lambda: self._prefill(buf),
                pool=self.prefills.pool())))
        buf, graph = entry
        buf.copy_(ids)
        return graph.replay()

    def step(self):
        """One decode token for the batch: the reference's scan body
        (generation.py:200-214) with the position a device scalar."""
        logits, _ = self.fwd_fn(self.model, self.nxt[:, None], self.caches,
                                self.pos)
        new = self.pick(logits[:, -1].float(), self.gen)
        if self.eos is not None:
            self.finished.logical_or_(self.nxt == self.eos)
            new = torch.where(self.finished, self.eos, new)
        self.out.index_copy_(1, (self.pos + 1).view(1), new[:, None])
        self.nxt.copy_(new)
        self.pos.add_(1)

    def decode(self, ids, first, n_steps):
        """`n_steps` decode tokens after the prompt `ids` and its first
        sampled token `first`; returns the [b, prompt_len + n_steps + 1]
        output buffer's rows."""
        prompt_len = ids.shape[1]

        def load():
            self.nxt.copy_(first)
            self.pos.fill_(prompt_len)
            self.finished.zero_()
            self.out[:, :prompt_len] = ids
            self.out[:, prompt_len] = first

        load()
        if n_steps and self.dev.type != "cpu" and self.step_graph is None:
            self.step_graph = CapturedStep(
                "generate_decode", self.step, pool=self.prefills.pool(),
                generators=(self.gen,))
            load()
        for _ in range(n_steps):
            if self.step_graph is None:
                self.step()
            else:
                self.step_graph.replay()
        return self.out[:, :prompt_len + n_steps + 1]


def _param_ptrs(model):
    """The addresses a captured graph reads the model's weights at."""
    return tuple(t.data_ptr() for t in nn.Module.state_dict(model).values())


def _fused_loop(model, fwd_fn, key, b, max_len, dtype, dev, pick, eos):
    """The model's cached `_FusedLoop` for `key`, made on a miss (the
    least recently used of `_LOOP_CACHE` dropped) or when the model's
    weights have moved since its graphs were captured."""
    loops = model.__dict__.setdefault("_fused_decode_loops",
                                      collections.OrderedDict())
    loop = loops.get(key)
    if loop is not None and loop.params != _param_ptrs(model):
        del loops[key]
        loop = None
    if loop is None:
        if len(loops) >= _LOOP_CACHE:
            loops.popitem(last=False)
        loop = loops[key] = _FusedLoop(model, fwd_fn, b, max_len, dtype,
                                       dev, pick, eos)
    loops.move_to_end(key)
    return loop


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_p=1.0, top_k=0, eos_token_id=None,
             seed=0, use_fused_step=True, device=None):
    """Greedy / sampled decode for GPT and LLaMA causal LMs.

    input_ids: [b, prompt_len] ints (array or tensor). Returns a
    [b, prompt_len + max_new_tokens] int32 tensor (positions after an
    eos stay eos). use_fused_step=True runs the prefill and each decode
    step as CUDA graphs over a cached static state (`_FusedLoop`, the
    reference's one executable of the whole loop); False keeps the eager
    per-step loop, the conformance oracle. On the CPU both run eagerly
    and give the same tokens. device: None = the CUDA card; the model
    must live on the resolved device."""
    fwd_fn, emb_dtype = _family(model)
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

    def pick(lf, gen):
        return _pick_token(lf, gen, do_sample, temperature, top_p, top_k)

    was_training = model.training
    model.eval()
    try:
        if use_fused_step:
            # the reference keys its loops by the sampling settings, the
            # eos id and the step bucket (generation.py:314-324); here
            # one graph of a step serves every step count, and the
            # static buffers fix the batch size and the cache bucket
            key = (do_sample, float(temperature), float(top_p),
                   int(top_k), eos_token_id, b, max_len)
            loop = _fused_loop(model, fwd_fn, key, b, max_len, emb_dtype,
                               dev, pick, eos_token_id)
            loop.gen.manual_seed(seed)
            nxt = pick(loop.prefill(ids), loop.gen)
            out = loop.decode(ids, nxt, max_new_tokens - 1)
            return out.to(torch.int32)
        caches = _static_cache(model, b, max_len, emb_dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def at(p):
            return torch.full((), p, dtype=torch.int64, device=dev)

        logits, caches = fwd_fn(model, ids, caches, at(0))
        nxt = pick(logits[:, -1].float(), gen)
        out = torch.cat([ids, torch.zeros((b, max_new_tokens),
                                          dtype=torch.int64, device=dev)],
                        dim=1)
        out[:, prompt_len] = nxt
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        for step in range(1, max_new_tokens):
            pos = prompt_len + step - 1
            if eos_token_id is not None:
                finished = finished | (nxt == eos_token_id)
            logits, caches = fwd_fn(model, nxt[:, None], caches, at(pos))
            nxt = pick(logits[:, -1].float(), gen)
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
            out[:, prompt_len + step] = nxt
        return out.to(torch.int32)
    finally:
        if was_training:
            model.train()
