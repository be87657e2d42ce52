"""Continuous-batching LLM serving engine over the paged KV cache
(counterpart of paddle_tpu/inference/llm_engine.py).

The scheduler is host Python plus the native block allocator, and every
decision it makes is paddle_tpu's: admission order, prefix-cache leases,
total-token buckets, power-of-two decode chunks, page leasing, the
trash page and the preemption victim. The two engines' `stats` agree
exactly on the same traffic.

  * Ragged packed prefill: every admission wave (fresh prompts and
    prefix-resume tails alike) packs its rows' uncached tokens into ONE
    [total_tokens] stream with per-token (row, position) metadata and
    runs `kernels.ragged_paged_attention` once per layer: the
    hand-written CUDA kernel on the card, its plain PyTorch version on
    the CPU. paddle_tpu compiles this function into one executable per
    token bucket; here it runs eagerly.
  * Decode runs the whole batch one chunk (`decode_chunk` tokens) at a
    time. paddle_tpu stages each step's k/v in a side buffer because a
    pool that is both scattered into and read in one XLA scan body
    loses in-place aliasing. PyTorch updates tensors in place, so each
    step writes its k/v straight into the pool and attends over the
    row's pages at positions <= its length. On the card a step is one
    CUDA graph per page-table width bucket (`_width_bucket`), replayed
    `chunk` times over static inputs; the pools never move and the
    engine's generator is registered with every graph. Between chunks
    the host reads back only the [B, chunk] tokens.
  * The GPT and LLaMA families (``_family_for``). LLaMA's q and k are
    rotated (f32 half tables built once for max_model_len) before the
    pool write, in the packed wave and in each decode step; its GQA kv
    heads stay un-repeated in the pool.
  * Automatic prefix caching (enable_prefix_caching, default on): full
    prompt blocks are content-hashed in the PagedKVCache, a request
    sharing a page-aligned prefix leases the computed pages and prefills
    only its tail, and finished sequences' pages park in an LRU.

Not in this port yet (each raises NotImplementedError): speculative
decoding, tensor-parallel placement (mesh/shard_param), the persistent
executable cache, int8 pools (kv_quant_scales), the step watchdog,
load shedding (shed_load/max_waiting), request deadlines, precomputed
prefix hashes and the observability series and spans.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..incubate.nn.functional.serving import _apply_rotary
from ..jit.cuda_graph import CapturedStep
from ..kernels.ragged_paged_attention import (ragged_paged_attention,
                                              ragged_plan)
from ..models.generation import _pick_token
from ..models.llama import _rope_cos_sin
from .paged_cache import PagedKVCache

__all__ = ["LLMEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    request_id: object
    prompt_ids: np.ndarray
    output_ids: np.ndarray          # generated tokens (no prompt)
    finish_reason: str              # "eos" | "length"


@dataclasses.dataclass(eq=False)
class _Request:
    rid: object
    prompt: np.ndarray                       # int32 [prompt_len]
    max_new_tokens: int                      # TOTAL generation budget
    resume_out: List[int] = dataclasses.field(default_factory=list)
    hash_chain: Optional[list] = None        # memoized block_hashes()

    @property
    def context_len(self) -> int:
        """Tokens the prefill must (re)build: prompt + resumed output."""
        return len(self.prompt) + len(self.resume_out)


class _Seq:
    __slots__ = ("rid", "prompt", "max_new", "slot", "length", "out",
                 "admit_seq", "cached_len")

    def __init__(self, req: _Request, slot: int, admit_seq: int):
        self.rid = req.rid
        self.prompt = req.prompt
        self.max_new = req.max_new_tokens
        self.slot = slot
        self.length = 0                 # tokens currently in the cache
        self.out: List[int] = list(req.resume_out)
        self.admit_seq = admit_seq      # monotonic admission order
        self.cached_len = 0             # prefix tokens leased from cache

    @property
    def token_budget(self) -> int:
        """Max cache tokens this sequence can ever occupy."""
        return len(self.prompt) + self.max_new


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _width_bucket(width: int, cap: int) -> int:
    """Page-table width a decode graph is captured for: `width` pages
    rounded up to a multiple of a quarter of its power-of-two floor (1,
    2, ..., 8, 10, 12, 14, 16, 20, 24, ...), at most `cap`. The padding
    stays under a quarter of the width, so under a quarter more slots
    to attend over, and rows growing a page at a time meet at most four
    buckets an octave."""
    quarter = max(1, _pow2_floor(max(width, 1)) // 4)
    return min(cap, _bucket(width, quarter))


class _GPTFamily:
    """GPT: fused qkv projection ([q | k | v] columns), learned position
    embeddings, no rope."""

    def __init__(self, model):
        self.model = model
        cfg = model.config
        self.kv_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.dtype = model.gpt.embeddings.word_embeddings.weight.dtype

    def rope_tables(self, max_len, device):
        return None

    def rotate(self, q, k, cos_sin):
        return q, k

    def embed(self, ids, pos):
        """ids/pos [...] -> [..., hidden] (dropout-free: serving)."""
        emb = self.model.gpt.embeddings
        return emb.word_embeddings.weight[ids] \
            + emb.position_embeddings.weight[pos]

    def layers(self):
        return list(self.model.gpt.layers)

    def qkv(self, layer, x):
        """x [T, hidden] -> packed [T, (H + 2kvH) * D]."""
        return layer.attn.qkv_proj(layer.ln1(x))

    def attn_out(self, layer, x, o):
        return x + layer.attn.out_proj(o)

    def mlp(self, layer, x):
        return x + layer.mlp(layer.ln2(x))

    def final(self, x):
        return self.model.gpt.final_norm(x)

    def logits(self, x):
        return self.model.lm_logits(x)


class _LlamaFamily:
    """LLaMA: split q/k/v projections (GQA kv heads un-repeated in the
    pool), RMSNorm, rotary embeddings in the neox half-split layout."""

    def __init__(self, model):
        self.model = model
        cfg = model.config
        self.kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.dtype = model.llama.embed_tokens.weight.dtype

    def rope_tables(self, max_len, device):
        """[2, max_len, head_dim // 2] f32: the cos and sin half tables."""
        cfg = self.model.config
        cos, sin = _rope_cos_sin(max_len, cfg.head_dim, cfg.rope_theta,
                                 torch.float32, device)
        d2 = cfg.head_dim // 2
        return torch.stack([cos[:, :d2], sin[:, :d2]])

    def rotate(self, q, k, cos_sin):
        """q [T, H, D] and k [T, kvH, D] rotated in f32 and cast back to
        their dtypes (the reference's ragged wave and decode step,
        llm_engine.py:1308-1314, :1509-1515)."""
        cos, sin = cos_sin
        return (_apply_rotary(q, cos, sin, True).to(q.dtype),
                _apply_rotary(k, cos, sin, True).to(k.dtype))

    def embed(self, ids, pos):
        return self.model.llama.embed_tokens.weight[ids]

    def layers(self):
        return list(self.model.llama.layers)

    def qkv(self, layer, x):
        """x [T, hidden] -> [T, (H + 2kvH) * D]: the three projections
        side by side."""
        h = layer.input_layernorm(x)
        a = layer.self_attn
        return torch.cat([a.q_proj(h), a.k_proj(h), a.v_proj(h)], dim=-1)

    def attn_out(self, layer, x, o):
        return x + layer.self_attn.o_proj(o)

    def mlp(self, layer, x):
        return x + layer.mlp(layer.post_attention_layernorm(x))

    def final(self, x):
        return self.model.llama.norm(x)

    def logits(self, x):
        return self.model.lm_head(x)


def _family_for(model):
    if hasattr(model, "gpt"):
        return _GPTFamily(model)
    if hasattr(model, "llama"):
        return _LlamaFamily(model)
    raise NotImplementedError(
        "LLMEngine serves the GPT and LLaMA families")


def _rope_at(rope, pos):
    """(cos, sin) [T, 1, D/2] f32 rows of the half tables `rope` at
    positions `pos` [T], or None for a family without rope. Gathered once
    per wave or decode step and shared by every layer."""
    if rope is None:
        return None
    return rope[0][pos][:, None, :], rope[1][pos][:, None, :]


def _bmm_f32(a, b):
    """a @ b over the leading batch dimension with f32 products and sums.
    On the card cuBLAS multiplies half-precision operands into f32
    (torch.bmm's out_dtype); the CPU build has no such product, so there
    the operands are widened first: the same products, since a product
    of two bf16 values is exact in f32."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _pool_decode_attention(q, kpool, vpool, tbl, lens, scale, block_size):
    """One-token-per-row attention over each row's pages.

    q: [B, H, D] (the current token, already written to the pool);
    kpool/vpool: [NB*bs, kvH, D] token-major; tbl: [B, P] int64 page
    table (page i of row b holds its positions i*bs .. i*bs+bs-1);
    lens: [B], attend to positions <= lens[b]. Same function as
    paddle_tpu's whole-pool masked form (_pool_decode_attention,
    llm_engine.py:476): a row's owned pages in table order hold exactly
    its positions, so gathering them replaces masking the whole pool.
    An inactive row's table is the trash page and its length 0, so it
    attends one (ignored) slot, as it does in paddle_tpu's engine.

    The reference's arithmetic: q·scale and p rounded to the pool's
    dtype, products and sums in f32, f32 scores and softmax. Each row's
    gathered pages [T, kvH*D] are read in place by one batched product
    per row and side: q enters as a block-diagonal [H, kvH*D] (each
    head's q in its kv head's columns, zeros elsewhere), so the scores
    are [H, T] with nothing added but exact zeros, and P·V yields
    [H, kvH*D], of which each head keeps its own kv head's block. (The
    zeros carry a non-finite value of one kv head's k at a slot into
    every head's score there; a finite pool gives the reference's
    scores.)"""
    B, H, D = q.shape
    kvH = kpool.shape[1]
    rep = H // kvH
    T = tbl.shape[1] * block_size
    kc = kpool.view(-1, block_size, kvH, D)[tbl].reshape(B, T, kvH * D)
    vc = vpool.view(-1, block_size, kvH, D)[tbl].reshape(B, T, kvH * D)
    q4 = (q.float() * scale).to(kpool.dtype).reshape(B, kvH, rep, 1, D)
    eye = torch.eye(kvH, dtype=kpool.dtype, device=q.device)
    qbd = (q4 * eye[:, None, :, None]).reshape(B, H, kvH * D)
    s = _bmm_f32(qbd, kc.transpose(1, 2))                     # [B, H, T]
    gpos = torch.arange(T, device=q.device)
    valid = gpos[None, :] <= lens[:, None]                   # [B, T]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(vpool.dtype)
    o = _bmm_f32(p, vc).reshape(B, kvH, rep, kvH, D)         # f32
    return torch.diagonal(o, dim1=1, dim2=3).permute(0, 3, 1, 2) \
        .reshape(B, H * D)


class LLMEngine:
    """Continuous-batching serving engine (paged KV cache runtime).

    Usage:
        engine = LLMEngine(model, max_batch=8)
        engine.add_request("a", prompt_ids, max_new_tokens=64)
        while engine.has_unfinished:
            for r in engine.step():
                ... r.output_ids ...
    or simply `results = engine.generate(prompts, max_new_tokens=64)`.

    device: None = the CUDA card (raises without one), or "cpu" by
    request; the model must live on that device."""

    def __init__(self, model, max_batch: int = 8,
                 num_blocks: Optional[int] = None, block_size: int = 64,
                 max_model_len: Optional[int] = None,
                 decode_chunk: int = 8, prompt_quantum: int = 128,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_p: float = 1.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None,
                 seed: int = 0, kv_quant_scales=None,
                 shed_load: bool = False,
                 max_waiting: Optional[int] = None,
                 step_timeout_s: Optional[float] = None,
                 enable_prefix_caching: bool = True,
                 speculative_config=None,
                 mesh=None, shard_param=None,
                 exec_cache_dir: Optional[str] = None, device=None):
        for name, val in (("kv_quant_scales", kv_quant_scales),
                          ("shed_load", shed_load or None),
                          ("max_waiting", max_waiting),
                          ("step_timeout_s", step_timeout_s),
                          ("speculative_config", speculative_config),
                          ("mesh", mesh), ("shard_param", shard_param),
                          ("exec_cache_dir", exec_cache_dir)):
            if val is not None:
                raise NotImplementedError(
                    f"LLMEngine({name}=...) is not ported yet")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}")
        cfg = model.config
        self.model = model
        self.fam = _family_for(model)
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len
                                 or cfg.max_position_embeddings)
        self.npb_full = -(-self.max_model_len // self.block_size)
        if num_blocks is None:
            # enough for every slot at full length, plus the trash page
            num_blocks = self.max_batch * self.npb_full + 1
        self.decode_chunk = int(decode_chunk)
        self.prompt_quantum = int(prompt_quantum)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.eos_token_id = eos_token_id
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        model.eval()
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_blocks=int(num_blocks),
            kv_heads=self.fam.kv_heads, block_size=self.block_size,
            head_dim=self.fam.head_dim,
            dtype=self.fam.dtype,
            layout="token",
            enable_prefix_caching=bool(enable_prefix_caching),
            device=self.device)
        self.enable_prefix_caching = self.cache.enable_prefix_caching
        # the trash page: inactive batch rows point their whole block
        # table here so their (ignored) writes never touch live pages
        self._trash_page = self.cache.allocator.alloc(1)[0]
        # rope half tables built once (None for a family without rope)
        self._rope = self.fam.rope_tables(self.max_model_len, self.device)

        self.waiting: collections.deque = collections.deque()
        self.slots: List[Optional[_Seq]] = [None] * self.max_batch
        self._admit_counter = 0
        self.stats = dict(
            preemptions=0, prefills=0, decode_chunks=0, decode_tokens=0,
            prefix_cache_hit_tokens=0, prefix_cache_miss_tokens=0,
            ragged_launches=0)
        # in-step pool-occupancy high-water (pages off the free list)
        self.peak_used_blocks = 0
        # the decode step's static state: the step counter and the
        # chunk's tokens, and by width bucket its inputs and (on the
        # card) its captured graph
        self._dec_step = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._dec_out = torch.zeros((self.max_batch, self.decode_chunk),
                                    dtype=torch.int64, device=self.device)
        self._dec_inputs: Dict[int, torch.Tensor] = {}
        self._dec_graphs: Dict[int, CapturedStep] = {}
        # checking only: True runs the card's decode steps eagerly, the
        # plain version the graphs are held to (chip_smoke.py, the cuda
        # tests); the CPU always runs them eagerly
        self._eager_decode = self.device.type == "cpu"

    # -- request lifecycle -------------------------------------------------
    def add_request(self, request_id, prompt_ids, max_new_tokens: int = 32,
                    deadline_s: Optional[float] = None,
                    obs_carry: Optional[tuple] = None,
                    prefix_hashes: Optional[list] = None):
        """Queue a request. Raises ValueError when prompt +
        max_new_tokens exceeds max_model_len, MemoryError when it can
        never fit in the pool."""
        for name, val in (("deadline_s", deadline_s),
                          ("obs_carry", obs_carry),
                          ("prefix_hashes", prefix_hashes)):
            if val is not None:
                raise NotImplementedError(
                    f"add_request({name}=...) is not ported yet")
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        total = len(prompt) + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {request_id!r}: prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new_tokens}) = {total} exceeds "
                f"max_model_len ({self.max_model_len})")
        need = -(-total // self.block_size)
        if need > self.cache.allocator.num_blocks - 1:
            raise MemoryError(
                f"request {request_id!r} needs {need} cache blocks but "
                f"the pool only has "
                f"{self.cache.allocator.num_blocks - 1} usable")
        self.waiting.append(_Request(request_id, prompt,
                                     int(max_new_tokens)))

    @property
    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    # -- scheduling --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @staticmethod
    def _merged_tokens(seq_or_req) -> np.ndarray:
        """prompt + carried output tokens: the context a prefill must
        (re)build, and what the prefix index is keyed on."""
        out = getattr(seq_or_req, "resume_out", None)
        if out is None:
            out = seq_or_req.out
        if not out:
            return seq_or_req.prompt
        return np.concatenate([seq_or_req.prompt,
                               np.asarray(out, np.int32)])

    def _admit(self) -> List[_Seq]:
        """Admit waiting requests into free slots while context pages
        fit, leasing each one's longest cached prefix. Returns the newly
        admitted (prefill-pending) sequences."""
        fresh = []
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            merged = self._merged_tokens(req)
            if self.enable_prefix_caching and req.hash_chain is None:
                req.hash_chain = self.cache.block_hashes(merged)
            plan_cached, feasible, plan_pages = self.cache.prefix_plan(
                merged, req.context_len, hashes=req.hash_chain)
            if not feasible:
                break
            self.waiting.popleft()
            self._admit_counter += 1
            seq = _Seq(req, slot, self._admit_counter)
            ncached = self.cache.add_sequence(
                seq.rid, req.context_len, tokens=merged,
                match=(plan_cached, plan_pages))
            seq.cached_len = ncached
            seq.length = req.context_len
            self.slots[slot] = seq
            fresh.append(seq)
            self.stats["prefix_cache_hit_tokens"] += ncached
            self.stats["prefix_cache_miss_tokens"] += \
                req.context_len - ncached
        return fresh

    def _preempt_one(self, exclude=None) -> bool:
        """Free the most-recently admitted sequence's pages and requeue
        it (prompt + generated-so-far) for re-prefill."""
        cands = [s for s in self.slots
                 if s is not None and s is not exclude]
        if not cands:
            return False
        victim = max(cands, key=lambda s: s.admit_seq)
        self.stats["preemptions"] += 1
        self.cache.free_sequence(victim.rid)
        self.slots[victim.slot] = None
        self.waiting.appendleft(_Request(
            victim.rid, victim.prompt, victim.max_new,
            resume_out=list(victim.out)))
        return True

    def _grow(self, seq: _Seq, by: int) -> bool:
        """Lease pages to cover `by` more tokens; preempt others until it
        fits (or nothing is left to preempt)."""
        while True:
            try:
                self.cache.extend(seq.rid, by)
                return True
            except MemoryError:
                if not self._preempt_one(exclude=seq):
                    return False

    # -- device steps ------------------------------------------------------
    def _run_prefills(self, seqs: List[_Seq]) -> List[int]:
        """ONE ragged packed pass over every admitted sequence's uncached
        tokens. Returns each sequence's first sampled token."""
        entries, merged = self._prefill_entries(seqs)
        toks = self._run_ragged(entries)
        self._commit_prefill(seqs, merged)
        return [int(toks[s.slot][-1]) for s in seqs]

    def _prefill_entries(self, seqs: List[_Seq]):
        """Ragged-batch rows for a prefill wave: each sequence
        contributes its UNCACHED suffix at its cached offset. Returns
        (entries, {rid: merged prompt+carried tokens})."""
        self.stats["prefills"] += len(seqs)
        entries = []
        merged_by_rid = {}
        for s in seqs:
            merged = self._merged_tokens(s)
            merged_by_rid[s.rid] = merged
            st = s.cached_len
            # COW guard: the suffix write range must not touch shared
            # pages (a no-op under page-aligned matching)
            self.cache.ensure_writable(s.rid, st)
            entries.append((s, np.asarray(merged[st:], np.int32), st))
        return entries, merged_by_rid

    def _commit_prefill(self, seqs: List[_Seq],
                        merged_by_rid: Dict) -> None:
        if not self.cache.enable_prefix_caching:
            return
        for s in seqs:
            if self.slots[s.slot] is s:
                self.cache.commit_prefix(s.rid, merged_by_rid[s.rid])

    def _token_bucket(self, n: int) -> int:
        """Total-token bucket of a ragged launch: power-of-two below the
        prompt quantum (floored at 8), quantum multiples above."""
        if n >= self.prompt_quantum:
            return _bucket(n, self.prompt_quantum)
        return max(8, _pow2_ceil(max(n, 1)))

    def _ragged_wave(self, ids, rows, pos, kvs, off, wf, sel, with_pool):
        """The packed-wave function (the eager counterpart of
        paddle_tpu's per-bucket "engine_ragged" executable). Rows of any
        length ride in a [tb] packed stream with per-token (row,
        position) metadata; attention over the paged pool plus the
        packed fresh k/v runs through ragged_paged_attention.
        with_pool=False is the no-cached-context wave. Each row's last
        hidden state is gathered through `sel` before the lm head, so
        the [tb, vocab] logits are never built.

        ids/rows/pos [tb]: the packed token stream (rows -1 = dead
        padding); wf [n_live]: flat pool row of each live packed token
        (live tokens come first); kvs [B]: cached tokens readable per
        row; off [B, NB]: block -> start position; sel [B]: each row's
        last packed position. Returns the sampled tokens [B]."""
        fam = self.fam
        bs = self.block_size
        kvH, hd = fam.kv_heads, fam.head_dim
        nH = self.model.config.num_heads
        scale = 1.0 / math.sqrt(hd)
        kcs, vcs = self.cache.key_caches, self.cache.value_caches
        tb = ids.shape[0]
        n_live = wf.shape[0]
        x = fam.embed(ids, pos)                              # [tb, h]
        cos_sin = _rope_at(self._rope, pos.long())
        # the kernels' index operands depend on the wave's metadata only:
        # built once here, read by every layer's launch
        plan = ragged_plan(rows, pos, kvs, off, bs, with_pool)
        for li, layer in enumerate(fam.layers()):
            qkv = fam.qkv(layer, x)
            q = qkv[:, :nH * hd].reshape(tb, nH, hd)
            k = qkv[:, nH * hd:(nH + kvH) * hd].reshape(tb, kvH, hd)
            v = qkv[:, (nH + kvH) * hd:].reshape(tb, kvH, hd)
            q, k = fam.rotate(q, k, cos_sin)
            # the pool read covers positions < kv_start only, and this
            # wave writes positions >= kv_start, so reading before
            # writing matches paddle_tpu's order
            o = ragged_paged_attention(
                q, k, v, kcs[li], vcs[li], rows, pos, kvs, off,
                block_size=bs, scale=scale, with_pool=with_pool, _plan=plan)
            kcs[li].index_copy_(0, wf, k[:n_live].to(kcs[li].dtype))
            vcs[li].index_copy_(0, wf, v[:n_live].to(vcs[li].dtype))
            x = fam.attn_out(layer, x, o.reshape(tb, nH * hd).to(x.dtype))
            x = fam.mlp(layer, x)
        lg = fam.logits(fam.final(x)[sel])                   # [B, vocab]
        return _pick_token(lg.float(), self._gen, self.do_sample,
                           self.temperature, self.top_p, self.top_k)

    @torch.no_grad()
    def _run_ragged(self, entries) -> Dict[int, np.ndarray]:
        """Pack rows into ONE ragged launch and run it.

        entries: [(seq, tokens int32 [m], start)]: each row computes its
        tokens at positions start..start+m-1 while reading its cached
        context (positions < start) from the pool through the ownership
        map; writes land at the row's leased pages. Returns {slot: the
        row's sampled token, shape [1]}."""
        B = self.max_batch
        NB = self.cache.allocator.num_blocks
        bs = self.block_size
        T_raw = sum(len(t) for _s, t, _st in entries)
        with_pool = any(st > 0 for _s, _t, st in entries)
        tb = self._token_bucket(T_raw)
        ids = np.zeros((tb,), np.int64)
        rows = np.full((tb,), -1, np.int32)
        pos = np.zeros((tb,), np.int32)
        kvs = np.zeros((B,), np.int32)
        off = np.full((B, NB), -1, np.int32)
        wf = np.zeros((T_raw,), np.int64)
        sel = np.zeros((B,), np.int64)
        c = 0
        for s, toks, st in entries:
            m = len(toks)
            b = s.slot
            ids[c:c + m] = toks
            rows[c:c + m] = b
            gpos = st + np.arange(m, dtype=np.int32)
            pos[c:c + m] = gpos
            kvs[b] = st
            pages = np.asarray(self.cache.pages(s.rid), np.int32)
            off[b, pages] = np.arange(len(pages), dtype=np.int32) * bs
            wf[c:c + m] = pages[gpos // bs] * bs + gpos % bs
            sel[b] = c + m - 1
            c += m
        dev = self.device
        nxt = self._ragged_wave(
            *(torch.from_numpy(a).to(dev)
              for a in (ids, rows, pos, kvs, off, wf, sel)), with_pool)
        self.stats["ragged_launches"] += 1
        nxt = nxt.cpu().numpy().astype(np.int32)
        return {s.slot: nxt[s.slot:s.slot + 1] for s, _t, _st in entries}

    def _run_decode_chunk(self) -> Dict[int, np.ndarray]:
        """One chunk of decode steps for every active slot. Returns
        {slot: np tokens [chunk]}."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        # chunk size: power-of-two bucket, never past the model cap
        headroom = min(self.max_model_len - s.length for s in active)
        chunk = _pow2_floor(max(1, min(self.decode_chunk, headroom)))
        # lease pages for the chunk up front (preempting if needed),
        # capped at each sequence's remaining token budget; writes past
        # the budget fall through to the trash page via table padding
        for s in active:
            if self.slots[s.slot] is not s:     # got preempted meanwhile
                continue
            want = min(s.length + chunk, max(s.token_budget, s.length))
            by = want - self.cache.length(s.rid)
            if by > 0 and not self._grow(s, by):
                raise MemoryError(
                    "paged pool too small for even one sequence's "
                    "decode chunk — enlarge num_blocks")
            self.cache.ensure_writable(s.rid, s.length)
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        self._note_pool_highwater()
        B = self.max_batch
        bs = self.block_size
        cur = np.zeros((B,), np.int64)
        lens = np.zeros((B,), np.int64)
        # page table (page index -> physical block; trash-padded): the
        # write target of every step and the pages each row attends
        tbl = np.full((B, self.npb_full), self._trash_page, np.int64)
        for s in active:
            cur[s.slot] = self._last_token(s)
            lens[s.slot] = s.length
            pages = self.cache.pages(s.rid)
            tbl[s.slot, :len(pages)] = pages
        # pages the chunk reaches, rounded up to the width bucket its
        # graph was captured for; the padding is trash pages past every
        # row's length, which the attention masks out
        width = -(-int(lens.max() + chunk) // bs)
        toks = self._decode_chunk(
            cur, lens, tbl[:, :_width_bucket(width, self.npb_full)], chunk)
        self.stats["decode_chunks"] += 1
        out = {}
        for s in active:
            out[s.slot] = toks[s.slot]
            s.length += chunk
        return out

    def _decode_step(self, inp):
        """One decode step for the whole batch (the math of paddle_tpu's
        _decode_fn scan body). inp [B, 2 + W] int64 holds each row's
        current token, its length when the chunk began and its page table
        (W pages). The step's position is that length plus the step
        counter; the step writes its k/v into the pool in place at the
        row's page for it, attends over the row's pages at positions <=
        it, then writes the sampled token over the current one and into
        the chunk's output at the step, and advances the counter. It
        takes nothing from the host, so the same function replays as a
        CUDA graph on the card and runs eagerly on the CPU."""
        fam = self.fam
        bs = self.block_size
        kvH, hd = fam.kv_heads, fam.head_dim
        nH = self.model.config.num_heads
        B = self.max_batch
        scale = 1.0 / math.sqrt(hd)
        kcs, vcs = self.cache.key_caches, self.cache.value_caches
        # the table as its own contiguous tensor: indexing the pools
        # with the strided view runs PyTorch's gather ~3x slower
        cur, tbl = inp[:, 0], inp[:, 2:].contiguous()
        pos = inp[:, 1] + self._dec_step                     # [B]
        page = torch.clamp(pos // bs, max=tbl.shape[1] - 1)
        flat = tbl.gather(1, page[:, None])[:, 0] * bs + pos % bs
        x = fam.embed(cur, pos)                              # [B, h]
        cos_sin = _rope_at(self._rope, pos)
        for li, layer in enumerate(fam.layers()):
            qkv = fam.qkv(layer, x)
            q = qkv[:, :nH * hd].reshape(B, nH, hd)
            k = qkv[:, nH * hd:(nH + kvH) * hd].reshape(B, kvH, hd)
            v = qkv[:, (nH + kvH) * hd:].reshape(B, kvH, hd)
            q, k = fam.rotate(q, k, cos_sin)
            kcs[li].index_copy_(0, flat, k.to(kcs[li].dtype))
            vcs[li].index_copy_(0, flat, v.to(vcs[li].dtype))
            o = _pool_decode_attention(q, kcs[li], vcs[li], tbl, pos,
                                       scale, bs)
            x = fam.attn_out(layer, x, o.to(x.dtype))
            x = fam.mlp(layer, x)
        lg = fam.logits(fam.final(x))                        # [B, vocab]
        nxt = _pick_token(lg.float(), self._gen, self.do_sample,
                          self.temperature, self.top_p, self.top_k)
        cur.copy_(nxt)
        self._dec_out.index_copy_(1, self._dec_step.view(1), nxt[:, None])
        self._dec_step.add_(1)

    @torch.no_grad()
    def _decode_chunk(self, cur, lens, tbl, chunk) -> np.ndarray:
        """`chunk` decode steps for the whole batch: paddle_tpu runs them
        as one executable per chunk bucket. cur/lens [B] and the
        trash-padded page table tbl [B, W] (host int64 arrays, W a width
        bucket) are copied into W's static inputs. On the card each step
        replays the graph of `_decode_step` captured at W's first chunk;
        on the CPU (or with `_eager_decode`) the same step runs eagerly. Returns [B, chunk] int32
        tokens, read back once: the chunk's only host sync."""
        W = tbl.shape[1]
        host = torch.from_numpy(np.concatenate(
            [cur[:, None], lens[:, None], tbl], axis=1))
        inp = self._dec_inputs.get(W)
        if inp is None:
            inp = self._dec_inputs[W] = torch.empty_like(
                host, device=self.device)

        def load():
            inp.copy_(host)
            self._dec_step.zero_()

        load()
        if self._eager_decode:
            for _ in range(chunk):
                self._decode_step(inp)
        else:
            graph = self._dec_graphs.get(W)
            if graph is None:
                graph = self._dec_graphs[W] = CapturedStep(
                    "engine_decode", lambda: self._decode_step(inp),
                    generators=(self._gen,))
                load()
            for _ in range(chunk):
                graph.replay()
        return self._dec_out[:, :chunk].cpu().numpy().astype(np.int32)

    def _last_token(self, seq: _Seq) -> int:
        return int(seq.out[-1]) if seq.out else int(seq.prompt[-1])

    def _note_pool_highwater(self) -> None:
        used = self.cache.allocator.num_blocks \
            - self.cache.allocator.num_free
        if used > self.peak_used_blocks:
            self.peak_used_blocks = used

    # -- main loop ---------------------------------------------------------
    def step(self) -> List[GenerationResult]:
        """Admit + prefill new sequences, run one decode chunk, retire
        finished sequences (paddle_tpu's step/_step_impl). Returns the
        results finished this step."""
        finished: List[GenerationResult] = []
        fresh = self._admit()
        if fresh:
            for seq, first in zip(fresh, self._run_prefills(fresh)):
                seq.out.append(first)
                self.stats["decode_tokens"] += 1
                self._maybe_finish(seq, finished)
        for slot, toks in self._run_decode_chunk().items():
            seq = self.slots[slot]
            if seq is None:
                continue
            for t in toks:
                if len(seq.out) >= seq.max_new:
                    break
                seq.out.append(int(t))
                self.stats["decode_tokens"] += 1
                if (self.eos_token_id is not None
                        and int(t) == self.eos_token_id):
                    break
            if self.cache.enable_prefix_caching:
                # register newly FILLED full blocks before the sequence
                # can retire, capped at what the chunk actually wrote
                ntok = min(seq.length, len(seq.prompt) + len(seq.out))
                if self.cache.cached_prefix_len(seq.rid) \
                        + self.block_size <= ntok:
                    self.cache.commit_prefix(
                        seq.rid, self._merged_tokens(seq), upto=ntok)
            self._maybe_finish(seq, finished)
        return finished

    def _maybe_finish(self, seq: _Seq, finished: List[GenerationResult]):
        done_eos = (self.eos_token_id is not None and seq.out
                    and seq.out[-1] == self.eos_token_id)
        done_len = len(seq.out) >= seq.max_new
        if not (done_eos or done_len):
            return
        finished.append(GenerationResult(
            request_id=seq.rid, prompt_ids=seq.prompt,
            output_ids=np.asarray(seq.out, np.int32),
            finish_reason="eos" if done_eos else "length"))
        self.cache.free_sequence(seq.rid)
        self.slots[seq.slot] = None

    def generate(self, prompts, max_new_tokens: int = 32
                 ) -> List[GenerationResult]:
        """Submit all prompts, run to completion, return results in
        submission order."""
        for i, p in enumerate(prompts):
            self.add_request(i, p, max_new_tokens)
        done: Dict[object, GenerationResult] = {}
        while self.has_unfinished:
            for r in self.step():
                done[r.request_id] = r
        return [done[i] for i in range(len(prompts))]
