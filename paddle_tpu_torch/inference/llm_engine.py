"""Continuous-batching LLM serving engine over the paged KV cache
(counterpart of paddle_tpu/inference/llm_engine.py).

The scheduler is host Python plus the native block allocator, and every
decision it makes is paddle_tpu's: admission order, prefix-cache leases,
total-token buckets, power-of-two decode chunks, page leasing, the
trash page, the preemption victim, speculative leases, verify-bucket
pinning and rollback, deadlines, load shedding and eviction. The two
engines' `stats` agree exactly on the same traffic.

  * Ragged packed waves: every admission wave (fresh prompts and
    prefix-resume tails alike) and every speculative verify wave packs
    its rows' tokens into ONE [total_tokens] stream with per-token (row,
    position) metadata and runs `kernels.ragged_paged_attention` once
    per layer: the hand-written CUDA kernel on the card, its plain
    PyTorch version on the CPU. paddle_tpu compiles this function into
    one executable per token bucket; here it runs eagerly.
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
  * Speculative decoding (speculative_config, greedy only): a proposer
    drafts up to k tokens a row, one packed verify wave samples a token
    at every position of every row's [last token, drafts...] window in
    a token bucket pinned at B * (k + 1), the matching prefix and the
    bonus token commit, and `PagedKVCache.truncate` rolls the lease
    back to them.
  * int8 pools (kv_quant_scales, from `calibrate_kv_scales`): k and v
    are quantized with per-layer, per-kv-head static scales where they
    are written (packed waves and decode steps); the ragged kernel takes
    the dequant scales, and the decode attention folds them into its
    scores and output.
  * The request lifecycle: load shedding (shed_load, max_waiting),
    deadlines (deadline_s, on the injectable `_now` clock),
    `abort_request`, poisoned-request isolation of the packed prefill
    and the decode chunk, the step watchdog (step_timeout_s) and
    precomputed prefix hashes. Failures are isolated only when they
    are raised before a device launch (the `resilience.faults` points,
    the leases, the proposer); a failure raised by a launch itself
    (a packed wave, a verify wave, a decode chunk: a kernel, a graph
    replay, a CUDA error) propagates out of `step()`.

  * Observability (``observability``), recorded only while enabled, at
    the reference's call sites and under its names: the series of
    `_metrics` (step, prefill, packed-wave, decode-chunk and verify
    latencies; queue, page-pool and prefix-cache gauges; prefix and
    speculative token counters; the per-request TTFT, TTFT budget, TPOT,
    queue-wait and e2e histograms and finish reasons; the HBM gauges),
    every `stats` counter mirrored onto
    ``paddle_tpu_engine_events_total`` (`_EngineStats`), one connected
    trace per request (its root span "request" and the events
    "request.queue_wait", ".prefill", ".decode_chunk", ".verify",
    ".preempt"; `obs_carry` adopts an earlier life's), the spans
    "engine.step", "engine.prefill", "engine.ragged",
    "engine.decode_chunk" and "engine.verify", the ``engine_decode`` and
    ``engine_ragged`` rooflines (`perf.count_cost`), and the flight
    triggers "step_latency", "deadline_miss" and "preempt_storm".
    Every recorder sits around a launch, never inside a captured decode
    step: a graph replays the kernels its capture saw and none of the
    Python. Timing: the packed wave and the decode chunk read their
    tokens back to the host, so a host clock around them covers their
    device time; a chunk that captured a graph is not a roofline
    sample, as the reference skips a compiling first call. Departures:
    ``paddle_tpu_hbm_live_array_bytes`` is the caching allocator's
    allocated bytes (``torch.cuda.memory_allocated``; the reference
    walks ``jax.live_arrays()``, which has no counterpart), 0 on the
    CPU; the packed waves build no executable (they run eagerly), so
    they report no compile and their TTFT budget's compile_stall is 0;
    the decode graphs' captures are the "engine_decode" compiles.

Not in this port yet (each raises NotImplementedError): tensor-parallel
placement (mesh/shard_param), the persistent executable cache
(exec_cache_dir) and KV-page export/import.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import flight as _fl
from ..observability import metrics as _om
from ..observability import perf as _pf
from ..observability import tracing as _ot
from ..incubate.nn.functional.serving import _apply_rotary, _quantize_kv
from ..jit.cuda_graph import CapturedStep
from ..kernels.ragged_paged_attention import (ragged_paged_attention,
                                              ragged_plan)
from ..models.generation import _family, _pick_token, _static_cache
from ..models.llama import _rope_cos_sin
from ..resilience import faults
from ..utils.watchdog import watchdog
from .paged_cache import PagedKVCache
from .speculative import accept_drafts

__all__ = ["LLMEngine", "GenerationResult", "calibrate_kv_scales"]


# ---------------------------------------------------------------------------
# observability (process-global series; per-engine exact counts live on
# engine.stats). Handles are created once and cached: the disabled path
# through any of them is a single module-flag check.
# ---------------------------------------------------------------------------
_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _om.registry()
        _METRICS = {
            "step": r.histogram(
                "paddle_tpu_engine_step_seconds",
                "LLMEngine.step() wall time (admission + prefills + one "
                "decode chunk + retirement)"),
            "prefill": r.histogram(
                "paddle_tpu_engine_prefill_seconds",
                "one packed prefill wave incl. host prep"),
            "decode": r.histogram(
                "paddle_tpu_engine_decode_chunk_seconds",
                "one decode chunk (its graph replays and the tokens' "
                "read-back) incl. host prep"),
            "queue": r.gauge(
                "paddle_tpu_engine_queue_depth",
                "requests per scheduler queue after a step",
                ("queue",)),
            "pool": r.gauge(
                "paddle_tpu_engine_page_pool_blocks",
                "paged KV cache pool occupancy after a step",
                ("state",)),
            "events": r.counter(
                "paddle_tpu_engine_events_total",
                "engine.stats counters (preemptions, prefills, "
                "decode_chunks, decode_tokens, failed/rejected "
                "requests, deadline_expired) aggregated across engines",
                ("event",)),
            "prefix": r.counter(
                "paddle_tpu_engine_prefix_cache_tokens_total",
                "prompt tokens served from the prefix cache (hit) vs "
                "prefilled from scratch (miss), counted at admission",
                ("outcome",)),
            "spec": r.counter(
                "paddle_tpu_engine_spec_tokens_total",
                "speculative draft tokens by verification outcome: "
                "accepted = matched the target model's greedy pick "
                "and committed in bulk, rejected = rolled back (KV "
                "truncated, pages unref'd)",
                ("outcome",)),
            "spec_rate": r.gauge(
                "paddle_tpu_engine_spec_acceptance_ratio",
                "cumulative fraction of drafted tokens accepted by "
                "verification (accepted / drafted), updated after "
                "every verify step"),
            "verify": r.histogram(
                "paddle_tpu_engine_verify_seconds",
                "one speculative verify wave (k+1 positions per row) "
                "incl. host prep"),
            "ragged": r.histogram(
                "paddle_tpu_engine_ragged_seconds",
                "one ragged packed-batch launch (mixed prefill/"
                "prefix-resume/verify rows in a single wave) incl. "
                "host prep"),
            "prefix_pages": r.gauge(
                "paddle_tpu_engine_prefix_cache_pages",
                "prefix-cache page index occupancy after a step: "
                "indexed = hash-addressable pages (leased or parked), "
                "lru = parked cached-but-unreferenced pages",
                ("state",)),
            # -- request-scoped SLO series (one observation per
            # request-lifecycle event; request identity stays in trace
            # spans, never in labels) --
            "ttft": r.histogram(
                "paddle_tpu_request_ttft_seconds",
                "per-request time to first token: enqueue -> first "
                "sampled token (includes queue wait and prefill)"),
            "ttft_budget": r.histogram(
                "paddle_tpu_request_ttft_budget_seconds",
                "per-request TTFT latency-budget decomposition, one "
                "observation per component when the first token lands:"
                " queue_wait = (re)enqueue -> admission, summed across"
                " requeues; prefill_compute = first-build prefill wall"
                " the request rode; affinity_miss = re-prefill wall "
                "spent REBUILDING context already computed once "
                "(preemption resume, or a re-serve passed in through "
                "obs_carry); compile_stall = packed-wave compile wall "
                "the request waited behind (0 here: the packed waves "
                "build no executable); other = the remainder. "
                "Components sum to the request's "
                "paddle_tpu_request_ttft_seconds observation",
                ("component",)),
            "tpot": r.histogram(
                "paddle_tpu_request_tpot_seconds",
                "per-request mean inter-token latency over the decode "
                "phase, observed once per finished request"),
            "queue_wait": r.histogram(
                "paddle_tpu_request_queue_wait_seconds",
                "time from (re)enqueue to admission into a batch slot "
                "(observed per admission, incl. post-preemption "
                "resumes)"),
            "e2e": r.histogram(
                "paddle_tpu_request_e2e_seconds",
                "end-to-end latency of successfully finished requests "
                "(enqueue -> eos/length)"),
            "req_finished": r.counter(
                "paddle_tpu_request_finished_total",
                "terminal request outcomes by finish_reason",
                ("reason",)),
            # -- HBM telemetry (compile telemetry: the shared
            # _om.compile_metrics() registration) --
            "hbm_pool": r.gauge(
                "paddle_tpu_hbm_page_pool_bytes",
                "paged KV pool HBM after a step: reserved = the whole "
                "pool allocation, used = currently leased pages",
                ("state",)),
            "hbm_live": r.gauge(
                "paddle_tpu_hbm_live_array_bytes",
                "bytes held by live tensors on the card (the caching "
                "allocator's allocated bytes), sampled at engine step "
                "boundaries (at most one read per second)"),
        }
        _METRICS["compiles"], _METRICS["compile_time"] = \
            _om.compile_metrics()
    return _METRICS


class _EngineStats(dict):
    """The stats dict, mirrored onto the registry while staying a real
    dict: every increment site (`stats[k] += n`) keeps its exact
    per-engine semantics, and the write mirrors the delta onto the
    process-global `paddle_tpu_engine_events_total{event=k}` counter
    (a no-op while observability is disabled). The prefix-cache and
    speculative token tallies are not mirrored: they land on their own
    counters (`paddle_tpu_engine_prefix_cache_tokens_total`,
    `paddle_tpu_engine_spec_tokens_total`)."""

    _UNMIRRORED = frozenset(
        ("prefix_cache_hit_tokens", "prefix_cache_miss_tokens",
         "spec_drafted_tokens", "spec_accepted_tokens"))

    def __setitem__(self, key, value):
        if _om._ENABLED and key not in self._UNMIRRORED:
            delta = value - self.get(key, 0)
            if delta > 0:
                _metrics()["events"].labels(event=key).inc(delta)
        super().__setitem__(key, value)


class _BeforeLaunch(Exception):
    """A failure raised while a wave or chunk was built, before its
    launch (its __cause__ is the original): the poisoned-request
    isolation retries those; a launch's own failure propagates."""


@dataclasses.dataclass
class GenerationResult:
    request_id: object
    prompt_ids: np.ndarray
    output_ids: np.ndarray          # generated tokens (no prompt)
    finish_reason: str   # "eos" | "length" | "error" | "deadline" |
                         # "rejected" | "aborted"
    error: Optional[str] = None     # failure detail when not ok

    @property
    def ok(self) -> bool:
        return self.finish_reason in ("eos", "length")


@dataclasses.dataclass(eq=False)
class _Life:
    """A request's observability state over its whole lifetime, shared
    by reference by each of its `_Request` and `_Seq` lives (preemption
    and a re-serve hand the same object on), so a resumed life's events
    join the ORIGINAL trace and TTFT / e2e stay anchored at the first
    enqueue."""
    trace_id: Optional[str] = None
    root_span: Optional[str] = None
    t_enq: float = 0.0                       # first enqueue (perf_counter)
    t_first: Optional[float] = None          # first token landed
    # TTFT latency-budget accumulators (seconds); recompute: a life
    # rebuilds a context computed once already (a preemption resume, a
    # re-serve), so its prefill wall charges to affinity_miss
    bud_queue: float = 0.0
    bud_prefill: float = 0.0
    bud_miss: float = 0.0
    bud_compile: float = 0.0
    recompute: bool = False


@dataclasses.dataclass(eq=False)        # identity eq: waiting.remove()
class _Request:                         # must not compare prompts
    rid: object
    prompt: np.ndarray                       # int32 [prompt_len]
    max_new_tokens: int                      # TOTAL generation budget
    resume_out: List[int] = dataclasses.field(default_factory=list)
    deadline: Optional[float] = None         # absolute `_now()` seconds
    hash_chain: Optional[list] = None        # memoized block_hashes()
    life: _Life = dataclasses.field(default_factory=_Life)
    t_queued: float = 0.0                    # latest (re)enqueue

    @property
    def context_len(self) -> int:
        """Tokens the prefill must (re)build: prompt + resumed output."""
        return len(self.prompt) + len(self.resume_out)


class _Seq:
    __slots__ = ("rid", "prompt", "max_new", "slot", "length", "out",
                 "admit_seq", "deadline", "cached_len", "life")

    def __init__(self, req: _Request, slot: int, admit_seq: int):
        self.rid = req.rid
        self.prompt = req.prompt
        self.max_new = req.max_new_tokens
        self.slot = slot
        self.length = 0                 # tokens currently in the cache
        self.out: List[int] = list(req.resume_out)
        self.admit_seq = admit_seq      # monotonic admission order
        self.deadline = req.deadline
        self.cached_len = 0             # prefix tokens leased from cache
        self.life = req.life            # shared with the request

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
        self.dtype = model.gpt.embeddings.word_embeddings.weight._data.dtype

    def rope_tables(self, max_len, device):
        return None

    def rotate(self, q, k, cos_sin):
        return q, k

    def embed(self, ids, pos):
        """ids/pos [...] -> [..., hidden] (dropout-free: serving)."""
        emb = self.model.gpt.embeddings
        return emb.word_embeddings.weight._data[ids] \
            + emb.position_embeddings.weight._data[pos]

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

    def gather_only(self):
        """The tables read by index only, never in a matrix product: the
        position embeddings, and the word embeddings under an untied
        head."""
        emb = self.model.gpt.embeddings
        out = [emb.position_embeddings.weight._data]
        if self.model.lm_head is not None:
            out.append(emb.word_embeddings.weight._data)
        return out


class _LlamaFamily:
    """LLaMA: split q/k/v projections (GQA kv heads un-repeated in the
    pool), RMSNorm, rotary embeddings in the neox half-split layout."""

    def __init__(self, model):
        self.model = model
        cfg = model.config
        self.kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.dtype = model.llama.embed_tokens.weight._data.dtype

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
        return self.model.llama.embed_tokens.weight._data[ids]

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

    def gather_only(self):
        """The token embeddings: read by index only (the head is its own
        weight)."""
        return [self.model.llama.embed_tokens.weight._data]


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
    of two bf16 (or two f16) values is exact in f32."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())




@torch.no_grad()
def calibrate_kv_scales(model, sample_ids):
    """Per-layer, per-kv-head int8 quant scales (127 / amax) from one
    dense cached forward over a representative prompt (the reference's
    calibrate_kv_scales, llm_engine.py:440, over the port's
    `models.generation` family forward).

    sample_ids: int array (or tensor) [b, s]. Returns (k_scales,
    v_scales), each [num_layers, kv_heads] float32 numpy."""
    fwd_fn, emb_dtype = _family(model)
    if isinstance(sample_ids, torch.Tensor):
        sample_ids = sample_ids.cpu().numpy()
    ids = np.asarray(sample_ids, dtype=np.int32)
    b, s = ids.shape
    dev = model.device
    caches = _static_cache(model, b, s, emb_dtype)
    was_training = model.training
    model.eval()
    try:
        fwd_fn(model, torch.as_tensor(ids, device=dev).long(), caches,
               torch.zeros((), dtype=torch.int64, device=dev))
    finally:
        if was_training:
            model.train()
    ks, vs = [], []
    for c in caches:
        # cache layout [b, max_len, kv_heads, head_dim]
        amax_k = c["k"].float().abs().amax(dim=(0, 1, 3))
        amax_v = c["v"].float().abs().amax(dim=(0, 1, 3))
        ks.append(127.0 / amax_k.clamp_min(1e-6))
        vs.append(127.0 / amax_v.clamp_min(1e-6))
    return (torch.stack(ks).cpu().numpy().astype(np.float32),
            torch.stack(vs).cpu().numpy().astype(np.float32))


def _pool_decode_attention(q, kpool, vpool, tbl, lens, scale, block_size,
                           kdq=None, vdq=None):
    """One-token-per-row attention over each row's pages.

    q: [B, H, D] (the current token, already written to the pool);
    kpool/vpool: [NB*bs, kvH, D] token-major; tbl: [B, P] int64 page
    table (page i of row b holds its positions i*bs .. i*bs+bs-1);
    lens: [B], attend to positions <= lens[b]; kdq/vdq: [kvH] f32
    dequant scales of an int8 pool. Same function as paddle_tpu's
    whole-pool masked form (_pool_decode_attention, llm_engine.py:476):
    a row's owned pages in table order hold exactly its positions, so
    gathering them replaces masking the whole pool. An inactive row's
    table is the trash page and its length 0, so it attends one
    (ignored) slot, as it does in paddle_tpu's engine.

    The reference's arithmetic: q·scale and p rounded to the pool's
    dtype, products and sums in f32, f32 scores and softmax; an int8
    pool is widened to f32 with q and p kept in f32, the dequant scales
    multiplying the scores and the output (llm_engine.py:499-525). Each
    row's gathered pages [T, kvH*D] are read in place by one batched
    product per row and side: q enters as a block-diagonal [H, kvH*D]
    (each head's q in its kv head's columns, zeros elsewhere), so the
    scores are [H, T] with nothing added but exact zeros, and P·V yields
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
    cdt = kpool.dtype
    if cdt == torch.int8:
        cdt = torch.float32
        kc, vc = kc.float(), vc.float()
    q4 = (q.float() * scale).to(cdt).reshape(B, kvH, rep, 1, D)
    eye = torch.eye(kvH, dtype=cdt, device=q.device)
    qbd = (q4 * eye[:, None, :, None]).reshape(B, H, kvH * D)
    s = _bmm_f32(qbd, kc.transpose(1, 2))                     # [B, H, T]
    if kdq is not None:
        s = s * kdq.repeat_interleave(rep)[None, :, None]
    gpos = torch.arange(T, device=q.device)
    valid = gpos[None, :] <= lens[:, None]                   # [B, T]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(cdt)
    o = _bmm_f32(p, vc).reshape(B, kvH, rep, kvH, D)         # f32
    o = torch.diagonal(o, dim1=1, dim2=3).permute(0, 3, 1, 2)  # [B,kvH,r,D]
    if vdq is not None:
        o = o * vdq[None, :, None, None]
    return o.reshape(B, H * D)


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
    request; the model must live on that device.

    kv_quant_scales: (k_scales, v_scales), each [num_layers, kv_heads]
    (`calibrate_kv_scales`), turns the pools to int8. speculative_config:
    an `inference.SpeculativeConfig` turns on speculative decoding
    (greedy only: do_sample=True is refused). shed_load: admission
    failures become "rejected" results instead of raising; max_waiting
    caps the waiting queue. step_timeout_s arms the watchdog around
    each device launch."""

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
        for name, val in (("mesh", mesh), ("shard_param", shard_param),
                          ("exec_cache_dir", exec_cache_dir)):
            if val is not None:
                raise NotImplementedError(
                    f"LLMEngine({name}=...) is not ported yet")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}")
        # fleet identity: a bare engine process ships its series as
        # process_role "engine" (a weak suggestion)
        from ..observability import fleet as _ofleet
        _ofleet.suggest_role("engine")
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
        # int8 pools: per-layer, per-kv-head static quant scales and
        # their reciprocals, the dequant scales (static tensors: the
        # decode graphs read them in place)
        self._kq = self._vq = self._kdq = self._vdq = None
        cache_dtype = self.fam.dtype
        if kv_quant_scales is not None:
            kq, vq = kv_quant_scales
            want = (cfg.num_layers, self.fam.kv_heads)
            self._kq, self._vq = (
                (t if isinstance(t, torch.Tensor)
                 else torch.from_numpy(np.array(t, np.float32)))
                .to(device=self.device, dtype=torch.float32)
                for t in (kq, vq))
            for got in (self._kq, self._vq):
                if tuple(got.shape) != want:
                    raise ValueError(
                        f"kv_quant_scales must be [{cfg.num_layers}, "
                        f"{self.fam.kv_heads}]; got {tuple(got.shape)}")
            self._kdq = 1.0 / self._kq
            self._vdq = 1.0 / self._vq
            cache_dtype = torch.int8
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_blocks=int(num_blocks),
            kv_heads=self.fam.kv_heads, block_size=self.block_size,
            head_dim=self.fam.head_dim,
            dtype=cache_dtype,
            layout="token",
            enable_prefix_caching=bool(enable_prefix_caching),
            device=self.device)
        self.enable_prefix_caching = self.cache.enable_prefix_caching
        # the trash page: inactive batch rows point their whole block
        # table here so their (ignored) writes never touch live pages
        self._trash_page = self.cache.allocator.alloc(1)[0]
        # rope half tables built once (None for a family without rope)
        self._rope = self.fam.rope_tables(self.max_model_len, self.device)
        # pool bytes are fixed at construction (the step's HBM gauges)
        self._pool_bytes = \
            sum(k.numel() * k.element_size() for k in self.cache.key_caches) \
            + sum(v.numel() * v.element_size()
                  for v in self.cache.value_caches)
        self._hbm_sampled_at = -1.0
        # the shapes the engine_decode / engine_ragged expectations are
        # counted from (observability.perf.count_cost)
        self._cost_shape = self._count_shapes(cache_dtype)

        self.waiting: collections.deque = collections.deque()
        self.slots: List[Optional[_Seq]] = [None] * self.max_batch
        self._admit_counter = 0
        # load shedding / deadlines / watchdog
        self.shed_load = bool(shed_load)
        self.max_waiting = max_waiting
        self.step_timeout_s = step_timeout_s
        self._failed: List[GenerationResult] = []   # drained by step()
        self._now = time.monotonic                  # stubbable clock
        # speculative decoding: drafts are verified greedily, so
        # sampling must be off (sampled verification would change the
        # output distribution)
        self.speculative_config = speculative_config
        self._proposer = None
        self._spec_k = 0
        if speculative_config is not None:
            if self.do_sample:
                raise ValueError(
                    "speculative_config requires greedy decoding "
                    "(do_sample=False); sampled verification is not "
                    "supported")
            self._proposer = speculative_config.build_proposer()
            self._spec_k = int(speculative_config.num_speculative_tokens)
        # per-engine exact counts; writes mirror onto the observability
        # registry (see _EngineStats)
        self.stats = _EngineStats(
            preemptions=0, prefills=0, decode_chunks=0,
            decode_tokens=0, failed_requests=0, rejected_requests=0,
            aborted_requests=0,
            deadline_expired=0, prefix_cache_hit_tokens=0,
            prefix_cache_miss_tokens=0, spec_steps=0,
            spec_drafted_tokens=0, spec_accepted_tokens=0,
            spec_proposer_errors=0, spec_step_errors=0,
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
        self._graph_pool = None     # the decode graphs' own, made at need
        # checking only: True runs the card's decode steps eagerly, the
        # plain version the graphs are held to (chip_smoke.py, the cuda
        # tests); the CPU always runs them eagerly
        self._eager_decode = self.device.type == "cpu"
        # whether the last decode chunk captured a graph (not a roofline
        # sample, as the reference skips a compiling first call)
        self._captured = False

    def _count_shapes(self, cache_dtype):
        """The model's counts for `perf.count_cost`: the parameters a
        token multiplies by (every parameter but the tables read by
        index only) and their bytes, the head's, and the bytes of one
        token's k and v over every layer's pool."""
        cfg = self.model.config
        params = list(torch.nn.Module.parameters(self.model))
        gather = {id(t) for t in self.fam.gather_only()}
        mm = [p for p in params if id(p) not in gather]
        hidden = cfg.hidden_size
        elem = torch.empty((), dtype=cache_dtype).element_size()
        return dict(
            params=float(sum(p.numel() for p in mm)),
            param_bytes=float(sum(p.numel() * p.element_size()
                                  for p in mm)),
            head_params=float(cfg.vocab_size * hidden),
            layers=cfg.num_layers, heads=cfg.num_heads,
            head_dim=self.fam.head_dim,
            kv_token_bytes=float(cfg.num_layers * 2 * self.fam.kv_heads
                                 * self.fam.head_dim * elem),
            logit_bytes=float(cfg.vocab_size * torch.empty(
                (), dtype=self.fam.dtype).element_size()))

    # -- request lifecycle -------------------------------------------------
    def _finish_obs(self, rid, reason: str, life: _Life,
                    n_out: int) -> None:
        """Terminal accounting every finish path funnels through: the
        outcome counter, e2e / TPOT observations (successful requests
        only: failures would poison the latency SLOs), and the
        request's ROOT span covering enqueue -> finish, which parents
        every lifecycle event recorded along the way."""
        if not (_om._ENABLED or _ot._ENABLED):
            return
        t_fin = time.perf_counter()
        if _om._ENABLED:
            m = _metrics()
            m["req_finished"].labels(reason=reason).inc()
            if reason in ("eos", "length"):
                m["e2e"].observe(t_fin - life.t_enq)
                if life.t_first is not None and n_out > 1:
                    m["tpot"].observe(
                        (t_fin - life.t_first) / (n_out - 1))
        if _ot._ENABLED and life.trace_id is not None:
            _ot.add_event(
                "request", life.t_enq * 1e6, (t_fin - life.t_enq) * 1e6,
                trace=(life.trace_id, life.root_span, None),
                args={"request_id": str(rid), "finish_reason": reason})

    def _reject(self, request_id, prompt, reason: str, exc_type=None):
        """Load-shedding admission: record a rejected result instead of
        raising (shed_load=True), or raise (the default)."""
        if not self.shed_load:
            raise (exc_type or RuntimeError)(reason)
        self.stats["rejected_requests"] += 1
        life = _Life(t_enq=time.perf_counter())
        if _ot._ENABLED:
            life.trace_id, life.root_span = (_ot.new_trace_id(),
                                             _ot.new_span_id())
        self._finish_obs(request_id, "rejected", life, 0)
        self._failed.append(GenerationResult(
            request_id=request_id, prompt_ids=prompt,
            output_ids=np.zeros((0,), np.int32),
            finish_reason="rejected", error=reason))

    def add_request(self, request_id, prompt_ids, max_new_tokens: int = 32,
                    deadline_s: Optional[float] = None,
                    obs_carry: Optional[tuple] = None,
                    prefix_hashes: Optional[list] = None):
        """Queue a request. A prompt + max_new_tokens past max_model_len
        (ValueError), a request that can never fit in the pool
        (MemoryError) or a full waiting queue (RuntimeError) raises, or
        with shed_load=True becomes a "rejected" result of the next
        step. deadline_s: a time-to-live from now (on `_now`): a request
        not finished by then fails with finish_reason "deadline", queued
        or running, while the others keep serving. prefix_hashes: this
        prompt's `cache.block_hashes` chain, computed elsewhere;
        admission uses it instead of hashing again.

        obs_carry: a (trace_id, root_span, t_enq[, reserve]) tuple from
        an EARLIER life of this request (a request re-served after its
        first engine failed): the request stays ONE connected trace and
        its TTFT, queue-wait and e2e keep charging the time the earlier
        life burned. A true 4th element marks a re-serve: the new
        life's prefill wall charges to the affinity_miss component of
        the TTFT budget instead of prefill_compute."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        total = len(prompt) + max_new_tokens
        if total > self.max_model_len:
            return self._reject(
                request_id, prompt,
                f"request {request_id!r}: prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new_tokens}) = {total} exceeds "
                f"max_model_len ({self.max_model_len})", ValueError)
        need = -(-total // self.block_size)
        if need > self.cache.allocator.num_blocks - 1:
            return self._reject(
                request_id, prompt,
                f"request {request_id!r} needs {need} cache blocks but "
                f"the pool only has "
                f"{self.cache.allocator.num_blocks - 1} usable",
                MemoryError)
        if self.max_waiting is not None and \
                len(self.waiting) >= self.max_waiting:
            return self._reject(
                request_id, prompt,
                f"request {request_id!r}: waiting queue is full "
                f"({self.max_waiting})", RuntimeError)
        deadline = (self._now() + deadline_s
                    if deadline_s is not None else None)
        # one trace per request lifetime (ids only while tracing is on;
        # the timestamps are taken either way: SLO accounting needs them
        # if metrics get enabled mid-flight)
        t_now = time.perf_counter()
        if obs_carry is not None:
            trace_id, root, t_enq = obs_carry[:3]
            life = _Life(trace_id, root, t_enq, recompute=bool(
                obs_carry[3]) if len(obs_carry) > 3 else False)
        else:
            life = _Life(t_enq=t_now)
            if _ot._ENABLED:
                life.trace_id, life.root_span = (_ot.new_trace_id(),
                                                 _ot.new_span_id())
        self.waiting.append(_Request(
            request_id, prompt, int(max_new_tokens), deadline=deadline,
            hash_chain=list(prefix_hashes) if prefix_hashes else None,
            life=life, t_queued=t_now))

    def abort_request(self, request_id) -> bool:
        """Cancel a queued or running request: its leased pages return
        to the pool now (full hash-indexed prefix blocks park in the
        prefix-cache LRU, as at a normal finish), and it completes with
        finish_reason "aborted" at the next step(). Returns False when
        the id is neither queued nor running here."""
        for req in self.waiting:
            if req.rid == request_id:
                self.waiting.remove(req)
                self.stats["aborted_requests"] += 1
                self._finish_obs(req.rid, "aborted", req.life,
                                 len(req.resume_out))
                self._failed.append(GenerationResult(
                    request_id=req.rid, prompt_ids=req.prompt,
                    output_ids=np.asarray(req.resume_out, np.int32),
                    finish_reason="aborted",
                    error="aborted while queued"))
                return True
        for seq in self.slots:
            if seq is not None and seq.rid == request_id:
                self.stats["aborted_requests"] += 1
                self.cache.free_sequence(seq.rid)
                self.slots[seq.slot] = None
                self._finish_obs(seq.rid, "aborted", seq.life,
                                 len(seq.out))
                self._failed.append(GenerationResult(
                    request_id=seq.rid, prompt_ids=seq.prompt,
                    output_ids=np.asarray(seq.out, np.int32),
                    finish_reason="aborted",
                    error="aborted mid-generation"))
                return True
        return False

    @property
    def has_unfinished(self) -> bool:
        return (bool(self.waiting) or bool(self._failed)
                or any(s is not None for s in self.slots))

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
            if _om._ENABLED:
                m = _metrics()
                pm = m["prefix"]
                if ncached:
                    pm.labels(outcome="hit").inc(ncached)
                pm.labels(outcome="miss").inc(req.context_len - ncached)
                qw = time.perf_counter() - req.t_queued
                seq.life.bud_queue += qw    # TTFT budget: queue wait
                m["queue_wait"].observe(qw)
            if _ot._ENABLED and req.life.trace_id is not None:
                now = time.perf_counter()
                _ot.add_event(
                    "request.queue_wait", req.t_queued * 1e6,
                    (now - req.t_queued) * 1e6,
                    trace=(req.life.trace_id, _ot.new_span_id(),
                           req.life.root_span),
                    args={"request_id": str(req.rid),
                          "resumed": bool(req.resume_out),
                          "cached_tokens": ncached})
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
        now = time.perf_counter()
        life = victim.life
        if _ot._ENABLED and life.trace_id is not None:
            _ot.add_event(
                "request.preempt", now * 1e6, 0.0,
                trace=(life.trace_id, _ot.new_span_id(), life.root_span),
                args={"request_id": str(victim.rid),
                      "generated": len(victim.out)})
        self.waiting.appendleft(_Request(
            victim.rid, victim.prompt, victim.max_new,
            resume_out=list(victim.out), deadline=victim.deadline,
            life=life, t_queued=now))
        life.recompute = True
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
        tokens. Returns each sequence's first sampled token; a failure
        while the wave is built raises `_BeforeLaunch`."""
        t0 = time.perf_counter()
        with _ot.span("engine.prefill", seqs=len(seqs)):
            try:
                entries, merged = self._prefill_entries(seqs)
            except Exception as e:
                raise _BeforeLaunch() from e
            out = self._launch_prefills(seqs, entries, merged)
        t1 = time.perf_counter()
        _metrics()["prefill"].observe(t1 - t0)
        if _om._ENABLED:
            # TTFT budget: every sequence of the wave waited its whole
            # wall; a recompute life's charges to affinity_miss (the
            # packed waves build no executable: no compile stall)
            work = t1 - t0
            for s in seqs:
                if self.slots[s.slot] is not s:
                    continue
                if s.life.recompute:
                    s.life.bud_miss += work
                else:
                    s.life.bud_prefill += work
        if _ot._ENABLED:
            # per-request attribution of the packed pass: each sequence
            # gets a child event in ITS trace spanning the wave
            for s in seqs:
                if s.life.trace_id is None or self.slots[s.slot] is not s:
                    continue
                _ot.add_event(
                    "request.prefill", t0 * 1e6, (t1 - t0) * 1e6,
                    trace=(s.life.trace_id, _ot.new_span_id(),
                           s.life.root_span),
                    args={"request_id": str(s.rid),
                          "cached_tokens": s.cached_len,
                          "prefill_tokens": s.length - s.cached_len})
        return out

    def _launch_prefills(self, seqs, entries, merged) -> List[int]:
        """ONE ragged packed pass over the wave `_prefill_entries`
        built for `seqs`. Returns each sequence's first sampled
        token."""
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
            faults.fault_point("engine.prefill.seq", rid=s.rid)
            merged = self._merged_tokens(s)
            merged_by_rid[s.rid] = merged
            st = s.cached_len
            # COW guard: the suffix write range must not touch shared
            # pages (a no-op under page-aligned matching)
            self.cache.ensure_writable(s.rid, st)
            entries.append((s, np.asarray(merged[st:], np.int32), st,
                            False))
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

    def _ragged_wave(self, ids, rows, pos, kvs, off, wf, sel, with_pool,
                     all_pos=False):
        """The packed-wave function (the eager counterpart of
        paddle_tpu's per-bucket "engine_ragged" executable). Rows of any
        length ride in a [tb] packed stream with per-token (row,
        position) metadata; attention over the paged pool plus the
        packed fresh k/v runs through ragged_paged_attention.
        with_pool=False is the no-cached-context wave. A prefill wave
        gathers each row's last hidden state through `sel` before the lm
        head, so the [tb, vocab] logits are never built; a verify wave
        (all_pos) samples a token at every packed position.

        ids/rows/pos [tb]: the packed token stream (rows -1 = dead
        padding); wf [n_live]: flat pool row of each live packed token
        (live tokens come first); kvs [B]: cached tokens readable per
        row; off [B, NB]: block -> start position; sel [B]: each row's
        last packed position. Returns the sampled tokens: [B], or [tb]
        for a verify wave."""
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
                block_size=bs, scale=scale,
                kdq=None if self._kdq is None else self._kdq[li],
                vdq=None if self._vdq is None else self._vdq[li],
                with_pool=with_pool, _plan=plan)
            kw, vw = self._pool_values(li, k[:n_live], v[:n_live])
            kcs[li].index_copy_(0, wf, kw)
            vcs[li].index_copy_(0, wf, vw)
            x = fam.attn_out(layer, x, o.reshape(tb, nH * hd).to(x.dtype))
            x = fam.mlp(layer, x)
        x = fam.final(x)
        lg = fam.logits(x if all_pos else x[sel])   # [tb or B, vocab]
        return _pick_token(lg.float(), self._gen, self.do_sample,
                           self.temperature, self.top_p, self.top_k)

    def _pool_values(self, li, k, v):
        """k/v [n, kvH, D] as layer li's pools store them: quantized with
        its scales for an int8 pool (round half to even, clipped to
        +-127: the reference's _quantize_kv(x, scale, 1, 127, -127)),
        else cast to the pool dtype."""
        kp, vp = self.cache.key_caches[li], self.cache.value_caches[li]
        if self._kq is not None:
            return (_quantize_kv(k, self._kq[li], 1, 127., -127.),
                    _quantize_kv(v, self._vq[li], 1, 127., -127.))
        return k.to(kp.dtype), v.to(vp.dtype)

    def _step_watchdog(self, what: str):
        """Hang detector around a device launch (step_timeout_s)."""
        if not self.step_timeout_s:
            return contextlib.nullcontext()
        return watchdog(self.step_timeout_s, what=what)

    @torch.no_grad()
    def _run_ragged(self, entries) -> Dict[int, np.ndarray]:
        """Pack rows into ONE ragged launch and run it.

        entries: [(seq, tokens int32 [m], start, all_positions)]: each
        row computes its tokens at positions start..start+m-1 while
        reading its cached context (positions < start) from the pool
        through the ownership map; writes land at the row's leased
        pages. A wave is a prefill wave (all_positions False everywhere)
        or a verify wave (True everywhere). Returns {slot: every packed
        position's sampled token [m]} for a verify wave, {slot: the
        row's last position's [1]} for a prefill wave."""
        B = self.max_batch
        NB = self.cache.allocator.num_blocks
        bs = self.block_size
        T_raw = sum(len(e[1]) for e in entries)
        with_pool = any(e[2] > 0 for e in entries)
        all_pos = entries[0][3]
        if all_pos:
            # verify waves pin ONE bucket sized for every slot drafting
            # the full k (the reference's one-executable rule: draft
            # lengths vary step to step and must not move the bucket)
            tb = self._token_bucket(B * (self._spec_k + 1))
        else:
            tb = self._token_bucket(T_raw)
        ids = np.zeros((tb,), np.int64)
        rows = np.full((tb,), -1, np.int32)
        pos = np.zeros((tb,), np.int32)
        kvs = np.zeros((B,), np.int32)
        off = np.full((B, NB), -1, np.int32)
        wf = np.zeros((T_raw,), np.int64)
        sel = np.zeros((B,), np.int64)
        spans = {}
        c = 0
        for s, toks, st, _ap in entries:
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
            spans[b] = (c, m)
            c += m
        dev = self.device
        t0 = time.perf_counter()
        with _ot.span("engine.ragged", rows=len(entries), tokens=T_raw,
                      bucket=tb, path=dev.type):
            with self._step_watchdog("engine ragged launch"):
                nxt = self._ragged_wave(
                    *(torch.from_numpy(a).to(dev)
                      for a in (ids, rows, pos, kvs, off, wf, sel)),
                    with_pool, all_pos)
                nxt = nxt.cpu().numpy().astype(np.int32)
        t1 = time.perf_counter()
        self.stats["ragged_launches"] += 1
        if _om._ENABLED:
            # roofline: the wave's tokens are read back above, so the
            # host clock around it covers its device time
            _metrics()["ragged"].observe(t1 - t0)
            _pf.observe_roofline("engine_ragged", t1 - t0,
                                 self._ragged_cost(entries, all_pos))
        if all_pos:
            return {b: nxt[cc:cc + m] for b, (cc, m) in spans.items()}
        return {b: nxt[b:b + 1] for b in spans}

    def _ragged_cost(self, entries, all_pos):
        """The packed wave's expectation (`perf.count_cost`): its live
        tokens, the context each attends, the rows' cached pages."""
        tokens = attended = cached = 0
        for _s, toks, st, _ap in entries:
            m = len(toks)
            tokens += m
            cached += st
            attended += m * st + m * (m + 1) // 2
        head_rows = tokens if all_pos else len(entries)
        c = self._cost_shape
        return _pf.count_cost(
            "engine_ragged", tokens=tokens, head_rows=head_rows,
            attended=attended, cached=cached,
            logits_bytes=head_rows * c["logit_bytes"], **c)

    def _decode_cost(self, rows, steps, attended):
        """A decode chunk's expectation (`perf.count_cost`)."""
        c = self._cost_shape
        return _pf.count_cost(
            "engine_decode", steps=steps, rows=rows, attended=attended,
            logits_bytes=rows * c["logit_bytes"], **c)

    def _run_decode_chunk(self, only: Optional[_Seq] = None
                          ) -> Dict[int, np.ndarray]:
        """One chunk of decode steps for every active slot (or for
        `only`: the poisoned-request isolation retry). Returns {slot: np
        tokens [chunk]}; a failure of the lease phase raises
        `_BeforeLaunch`."""
        t0 = time.perf_counter()
        with _ot.span("engine.decode_chunk"):
            try:
                lease = self._lease_decode_chunk(only)
            except Exception as e:
                raise _BeforeLaunch() from e
            out = self._launch_decode_chunk(lease)
        if out:     # skip empty calls (no active slots)
            t1 = time.perf_counter()
            _metrics()["decode"].observe(t1 - t0)
            if _ot._ENABLED:
                for slot in out:
                    s = self.slots[slot]
                    if s is None or s.life.trace_id is None:
                        continue
                    _ot.add_event(
                        "request.decode_chunk", t0 * 1e6,
                        (t1 - t0) * 1e6,
                        trace=(s.life.trace_id, _ot.new_span_id(),
                               s.life.root_span),
                        args={"request_id": str(s.rid)})
        return out

    def _lease_decode_chunk(self, only: Optional[_Seq] = None):
        """The host phase of a decode chunk for every active slot (or
        for `only`, every other row inactive: the poisoned-request
        isolation retry), before its launch: each
        row's fault point and its lease of the chunk's pages, capped at
        its remaining token budget (preempting if needed; writes past
        the budget fall through to the trash page via table padding;
        delta-based, so a retry never double-leases). Returns (rows,
        chunk), or None when no row is left."""
        active = [s for s in self.slots
                  if s is not None and (only is None or s is only)]
        if not active:
            return None
        # chunk size: power-of-two bucket, never past the model cap
        headroom = min(self.max_model_len - s.length for s in active)
        chunk = _pow2_floor(max(1, min(self.decode_chunk, headroom)))
        for s in active:
            if self.slots[s.slot] is not s:     # got preempted meanwhile
                continue
            faults.fault_point("engine.decode.seq", rid=s.rid)
            want = min(s.length + chunk, max(s.token_budget, s.length))
            by = want - self.cache.length(s.rid)
            if by > 0 and not self._grow(s, by):
                raise MemoryError(
                    "paged pool too small for even one sequence's "
                    "decode chunk — enlarge num_blocks")
            self.cache.ensure_writable(s.rid, s.length)
        active = [s for s in self.slots
                  if s is not None and (only is None or s is only)]
        if not active:
            return None
        self._note_pool_highwater()
        return active, chunk

    def _launch_decode_chunk(self, lease) -> Dict[int, np.ndarray]:
        """Run the leased chunk on the device (a failure here propagates:
        nothing is isolated past the launch). Every row outside the
        lease points at the trash page, so an isolation retry replays
        the width bucket's graph like any chunk. Returns {slot: np
        tokens [chunk]}."""
        if lease is None:
            return {}
        active, chunk = lease
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
        t0 = time.perf_counter()
        with self._step_watchdog("engine decode chunk"):
            toks = self._decode_chunk(
                cur, lens, tbl[:, :_width_bucket(width, self.npb_full)],
                chunk)
        if _om._ENABLED and not self._captured:
            # the chunk's tokens are read back inside _decode_chunk, so
            # this host clock covers its device time (host prep of the
            # inputs excluded); a chunk that captured is no sample
            attended = sum(chunk * s.length + chunk * (chunk + 1) // 2
                           for s in active)
            _pf.observe_roofline(
                "engine_decode", time.perf_counter() - t0,
                self._decode_cost(len(active), chunk, attended))
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
        row's page for it (quantized for an int8 pool), attends over the
        row's pages at positions <= it, then writes the sampled token
        over the current one and into the chunk's output at the step,
        and advances the counter. It takes nothing from the host, so the
        same function replays as a CUDA graph on the card and runs
        eagerly on the CPU."""
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
            kw, vw = self._pool_values(li, k, v)
            kcs[li].index_copy_(0, flat, kw)
            vcs[li].index_copy_(0, flat, vw)
            o = _pool_decode_attention(
                q, kcs[li], vcs[li], tbl, pos, scale, bs,
                kdq=None if self._kdq is None else self._kdq[li],
                vdq=None if self._vdq is None else self._vdq[li])
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
        self._captured = False
        if self._eager_decode:
            for _ in range(chunk):
                self._decode_step(inp)
        else:
            graph = self._dec_graphs.get(W)
            if graph is None:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                # the graph's expectation: one step over every row and
                # the width's every slot, as the capture computes it
                B = self.max_batch
                graph = self._dec_graphs[W] = CapturedStep(
                    "engine_decode", lambda: self._decode_step(inp),
                    pool=self._graph_pool, generators=(self._gen,),
                    expected=self._decode_cost(
                        B, 1, B * W * self.block_size))
                self._captured = True
                load()
            for _ in range(chunk):
                graph.replay()
        return self._dec_out[:, :chunk].cpu().numpy().astype(np.int32)

    def _last_token(self, seq: _Seq) -> int:
        return int(seq.out[-1]) if seq.out else int(seq.prompt[-1])

    def _note_pool_highwater(self) -> None:
        """The pool's in-step occupancy high-water: pages off the free
        list right after a lease, before any rollback releases them."""
        used = self.cache.allocator.num_blocks \
            - self.cache.allocator.num_free
        if used > self.peak_used_blocks:
            self.peak_used_blocks = used

    # -- speculative decoding ---------------------------------------------
    def _propose_drafts(self, active: List[_Seq]):
        """Host-side drafting: {slot: int32 drafts}, {slot: context} and
        the step's verify width k. Each row's draft budget is clamped to
        its model-length headroom (the window writes k+1 positions) and
        its remaining generation budget. A proposer that raises costs
        that row its drafts this step, never the step."""
        drafts: Dict[int, np.ndarray] = {}
        ctxs: Dict[int, np.ndarray] = {}
        k_step = 0
        for s in active:
            kmax = min(self._spec_k,
                       self.max_model_len - s.length - 1,
                       s.max_new - len(s.out) - 1)
            d = np.zeros((0,), np.int32)
            ctx = self._merged_tokens(s)
            ctxs[s.slot] = ctx
            if kmax > 0:
                try:
                    d = np.asarray(self._proposer.propose(
                        ctx, int(kmax)), np.int32).reshape(-1)[:kmax]
                except Exception:
                    self.stats["spec_proposer_errors"] += 1
            drafts[s.slot] = d
            k_step = max(k_step, len(d))
        return drafts, ctxs, k_step

    def _run_spec_step(self, finished: List[GenerationResult]) -> bool:
        """One speculative step for every active slot: propose drafts,
        lease each row's verify window (`_spec_lease`), run ONE packed
        verify wave over every window position (`_spec_device_phase`),
        commit the longest matching prefix and the bonus token, and roll
        the lease back to the committed length. Returns False when it
        did not run (nothing drafted, under half the batch drafting, or
        a failure before the launch): the caller then runs the chunked
        decode. A failure of the verify wave itself propagates."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return False
        drafts, ctxs, k_step = self._propose_drafts(active)
        # a mostly-undrafted batch decodes faster on the chunked path
        # (an undrafted row advances one token a verify step, a chunk a
        # decode step): speculate only when at least half drafts
        drafting = sum(1 for d in drafts.values() if len(d))
        if k_step <= 0 or 2 * drafting < len(active):
            return False
        try:
            entries = self._spec_lease(drafts)
        except Exception:
            # before the launch (a fault point, a lease's MemoryError):
            # this step degrades to the chunked decode, which carries
            # the poisoned-request isolation. Nothing is committed yet
            # and the leases are delta-accounted, so it decodes from
            # exactly the pre-step state.
            self.stats["spec_step_errors"] += 1
            return False
        if entries is None:
            return True                 # everything preempted mid-lease
        tgt, active = self._spec_device_phase(entries)
        self.stats["spec_steps"] += 1
        step_drafted = step_accepted = 0
        for s in active:
            b = s.slot
            d = drafts[b]
            t_row = tgt[b]                  # [1+len(d)] greedy targets
            a = accept_drafts(d, t_row)
            committed = t_row[:a + 1]       # accepted drafts + bonus
            n_before = len(s.out)
            for t in committed:
                if len(s.out) >= s.max_new:
                    break
                s.out.append(int(t))
                if (self.eos_token_id is not None
                        and int(t) == self.eos_token_id):
                    break
            n_app = len(s.out) - n_before
            self.stats["decode_tokens"] += n_app
            # KV rollback: the cache holds valid KV exactly for the
            # committed tokens; rejected positions' writes fall past the
            # truncated lease (pages unref'd, never hash-indexed)
            new_len = s.length + n_app
            self.cache.truncate(s.rid, new_len)
            s.length = new_len
            # accepted = drafts that COMMITTED (a match clamped by eos
            # or max_new was rolled back like a mismatch)
            a = min(a, n_app)
            step_drafted += len(d)
            step_accepted += a
            self.stats["spec_drafted_tokens"] += len(d)
            self.stats["spec_accepted_tokens"] += a
            if _ot._ENABLED and s.life.trace_id is not None:
                _ot.add_event(
                    "request.verify", self._t_verify0 * 1e6,
                    (self._t_verify1 - self._t_verify0) * 1e6,
                    trace=(s.life.trace_id, _ot.new_span_id(),
                           s.life.root_span),
                    args={"request_id": str(s.rid),
                          "drafted": int(len(d)),
                          "accepted": int(a),
                          "committed": int(n_app)})
            if self.cache.enable_prefix_caching:
                # as after a decode chunk: only fully ACCEPTED full
                # blocks can reach the hash index
                ntok = min(s.length, len(s.prompt) + len(s.out))
                if self.cache.cached_prefix_len(s.rid) \
                        + self.block_size <= ntok:
                    merged = np.concatenate(
                        [ctxs[b], np.asarray(s.out[n_before:], np.int32)])
                    self.cache.commit_prefix(s.rid, merged, upto=ntok)
            self._maybe_finish(s, finished)
        if _om._ENABLED:
            m = _metrics()
            if step_accepted:
                m["spec"].labels(outcome="accepted").inc(step_accepted)
            if step_drafted - step_accepted:
                m["spec"].labels(outcome="rejected").inc(
                    step_drafted - step_accepted)
            if self.stats["spec_drafted_tokens"]:
                m["spec_rate"].set(self.stats["spec_accepted_tokens"]
                                   / self.stats["spec_drafted_tokens"])
        return True

    def _spec_lease(self, drafts):
        """The host phase of a verify step, before its launch: each
        row's fault point and the lease of its LIVE 1+len(drafts) window
        (preempting if needed), capped at its remaining token budget as
        a decode chunk's is. Returns the verify wave's entries [(seq,
        [last committed token, drafts...], length, True)], or None when
        preemption emptied the batch."""
        for s in [s for s in self.slots if s is not None]:
            if self.slots[s.slot] is not s:     # got preempted meanwhile
                continue
            faults.fault_point("engine.verify.seq", rid=s.rid)
            live = 1 + len(drafts.get(s.slot, ()))
            want = min(s.length + live, max(s.token_budget, s.length))
            by = want - self.cache.length(s.rid)
            if by > 0 and not self._grow(s, by):
                raise MemoryError(
                    "paged pool too small for even one sequence's "
                    "verify window — enlarge num_blocks")
            self.cache.ensure_writable(s.rid, s.length)
        active = [s for s in self.slots if s is not None]
        if not active:
            return None
        self._note_pool_highwater()
        entries = []
        for s in active:
            d = drafts.get(s.slot, np.zeros((0,), np.int32))
            drafts[s.slot] = d
            window = np.concatenate(
                [np.asarray([self._last_token(s)], np.int32), d])
            entries.append((s, window, s.length, True))
        return entries

    def _spec_device_phase(self, entries):
        """The verify wave: every window position of every row scored in
        one packed launch. Returns ({slot: np.int32 [1+len(drafts)]
        greedy targets}, the rows)."""
        k_step = max(len(e[1]) for e in entries) - 1
        t0 = time.perf_counter()
        with _ot.span("engine.verify", rows=len(entries), k=k_step):
            tgt = self._run_ragged(entries)
        t1 = time.perf_counter()
        self._t_verify0, self._t_verify1 = t0, t1
        if _om._ENABLED:
            _metrics()["verify"].observe(t1 - t0)
        return tgt, [e[0] for e in entries]

    # -- failures ----------------------------------------------------------
    def _fail_seq(self, seq: _Seq, reason: str, finish_reason: str,
                  finished: List[GenerationResult]) -> None:
        """Evict a running sequence as failed; the engine keeps serving
        every other admitted request."""
        self.stats["failed_requests"] += 1
        self.cache.free_sequence(seq.rid)
        self.slots[seq.slot] = None
        self._finish_obs(seq.rid, finish_reason, seq.life, len(seq.out))
        finished.append(GenerationResult(
            request_id=seq.rid, prompt_ids=seq.prompt,
            output_ids=np.asarray(seq.out, np.int32),
            finish_reason=finish_reason, error=reason))

    def _expire_deadlines(self, finished: List[GenerationResult]) -> None:
        """Fail requests whose time-to-live elapsed: waiting ones are
        dropped, running ones evicted (their pages return to the
        pool)."""
        now = self._now()
        expired = [r for r in self.waiting
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self.waiting.remove(req)
            self.stats["deadline_expired"] += 1
            self.stats["failed_requests"] += 1
            self._finish_obs(req.rid, "deadline", req.life,
                             len(req.resume_out))
            if _fl._ARMED:
                _fl.trigger("deadline_miss", detail={
                    "request_id": str(req.rid), "where": "queued",
                    "overrun_s": now - req.deadline})
            finished.append(GenerationResult(
                request_id=req.rid, prompt_ids=req.prompt,
                output_ids=np.asarray(req.resume_out, np.int32),
                finish_reason="deadline",
                error="deadline exceeded by "
                      f"{now - req.deadline:.3f}s while queued"))
        for seq in [s for s in self.slots if s is not None]:
            if seq.deadline is not None and now >= seq.deadline:
                self.stats["deadline_expired"] += 1
                if _fl._ARMED:
                    _fl.trigger("deadline_miss", detail={
                        "request_id": str(seq.rid), "where": "running",
                        "overrun_s": now - seq.deadline})
                self._fail_seq(seq, "deadline expired mid-generation",
                               "deadline", finished)

    def _safe_prefills(self, seqs: List[_Seq],
                       finished: List[GenerationResult]):
        """Packed prefill with poisoned-request isolation: if building
        the wave raises (a fault point, a COW guard), each sequence is
        retried alone (a smaller bucket of the same packed wave) and only
        the ones that still raise before their launch are failed and
        evicted. A launch that raises propagates."""
        try:
            return list(zip(seqs, self._run_prefills(seqs)))
        except _BeforeLaunch:
            pairs = []
            for s in seqs:
                if self.slots[s.slot] is not s:  # preempted meanwhile
                    continue
                try:
                    (first,) = self._run_prefills([s])
                except _BeforeLaunch as e:
                    err = e.__cause__
                    self._fail_seq(
                        s, f"prefill raised {type(err).__name__}: {err}",
                        "error", finished)
                    continue
                pairs.append((s, first))
            return pairs

    def _safe_decode_chunk(self, finished: List[GenerationResult]
                           ) -> Dict[int, np.ndarray]:
        """The decode chunk with poisoned-request isolation: if its
        lease phase raises, each sequence is leased and run alone, and
        only the ones whose lease still raises are failed and evicted.
        If no sequence survives alone the failure is systemic (an
        undersized pool): it is raised, unless shed_load says degrade
        anyway. A launch that raises propagates."""
        try:
            return self._run_decode_chunk()
        except _BeforeLaunch as first:
            out: Dict[int, np.ndarray] = {}
            survivors = 0
            casualties = []
            for s in [s for s in self.slots if s is not None]:
                if self.slots[s.slot] is not s:  # preempted meanwhile
                    continue
                try:
                    out.update(self._run_decode_chunk(only=s))
                except _BeforeLaunch as e:
                    casualties.append((s, e.__cause__))
                    continue
                survivors += 1
            if casualties and not survivors and not self.shed_load:
                raise first.__cause__
            for s, e in casualties:
                self._fail_seq(
                    s, f"decode raised {type(e).__name__}: {e}",
                    "error", finished)
            return out

    # -- main loop ---------------------------------------------------------
    def step(self) -> List[GenerationResult]:
        """Drain rejected and aborted results, expire deadlines, admit +
        prefill new sequences, run one speculative step or one decode
        chunk, retire finished sequences (paddle_tpu's _step_impl, in
        its order). Returns the results finished this step, failed,
        rejected, aborted and expired ones included (check `.ok`)."""
        t0 = time.perf_counter()
        pre0 = self.stats["preemptions"] if _fl._ARMED else 0
        with _ot.span("engine.step") as sp:
            finished = self._step_impl()
        dt = time.perf_counter() - t0
        if _om._ENABLED:
            m = _metrics()
            m["step"].observe(dt)
            m["queue"].labels(queue="waiting").set(len(self.waiting))
            m["queue"].labels(queue="running").set(
                sum(s is not None for s in self.slots))
            free = self.cache.allocator.num_free
            nb = self.cache.allocator.num_blocks
            m["pool"].labels(state="free").set(free)
            m["pool"].labels(state="used").set(nb - free)
            m["prefix_pages"].labels(state="indexed").set(
                self.cache.cached_pages)
            m["prefix_pages"].labels(state="lru").set(
                self.cache.lru_pages)
            # HBM at the step boundary: the pool is the engine's
            # dominant persistent allocation; the live bytes (the
            # caching allocator's, read at most once a second) the
            # process's whole footprint on the card
            m["hbm_pool"].labels(state="reserved").set(self._pool_bytes)
            m["hbm_pool"].labels(state="used").set(
                self._pool_bytes * (nb - free) // max(nb, 1))
            now = time.perf_counter()
            if now - self._hbm_sampled_at >= 1.0:
                m["hbm_live"].set(
                    torch.cuda.memory_allocated(self.device)
                    if self.device.type == "cuda" else 0)
                self._hbm_sampled_at = now
        if _fl._ARMED:
            cfg = _fl.config()
            thr = cfg.step_latency_threshold_s if cfg else None
            storm = cfg.preempt_storm if cfg else None
            if thr is not None and dt > thr:
                _fl.trigger("step_latency", detail={
                    "step_seconds": dt, "threshold_s": thr,
                    "trace_id": sp.trace_id, "span_id": sp.span_id},
                    extra={"engine_stats": dict(self.stats)})
            elif storm and \
                    self.stats["preemptions"] - pre0 >= storm:
                _fl.trigger("preempt_storm", detail={
                    "preemptions_in_step":
                        self.stats["preemptions"] - pre0,
                    "threshold": storm,
                    "trace_id": sp.trace_id, "span_id": sp.span_id},
                    extra={"engine_stats": dict(self.stats)})
        return finished

    def _step_impl(self) -> List[GenerationResult]:
        finished: List[GenerationResult] = []
        if self._failed:                    # rejections and aborts
            finished.extend(self._failed)
            self._failed.clear()
        faults.fault_point("engine.step")
        self._expire_deadlines(finished)
        fresh = self._admit()
        if fresh:
            for seq, first in self._safe_prefills(fresh, finished):
                seq.out.append(first)
                self.stats["decode_tokens"] += 1
                if seq.life.t_first is None:    # resumed lives keep it
                    seq.life.t_first = time.perf_counter()
                    if _om._ENABLED:
                        self._observe_ttft(seq)
                self._maybe_finish(seq, finished)
        if self._proposer is not None and self._run_spec_step(finished):
            # the speculative step committed tokens, rolled the leases
            # back and retired finished sequences itself
            return finished
        for slot, toks in self._safe_decode_chunk(finished).items():
            seq = self.slots[slot]
            if seq is None:
                continue
            n_before = len(seq.out)
            for t in toks:
                if len(seq.out) >= seq.max_new:
                    break
                seq.out.append(int(t))
                if (self.eos_token_id is not None
                        and int(t) == self.eos_token_id):
                    break
            # counted once a row, not a token: a `stats` write mirrors
            # onto the registry while observability is on
            self.stats["decode_tokens"] += len(seq.out) - n_before
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

    @staticmethod
    def _observe_ttft(seq: _Seq) -> None:
        """The first token's TTFT and its budget: the accumulated
        components plus a residual, so the five observations sum to the
        TTFT observation exactly."""
        m = _metrics()
        life = seq.life
        ttft = life.t_first - life.t_enq
        m["ttft"].observe(ttft)
        known = (life.bud_queue + life.bud_prefill + life.bud_miss
                 + life.bud_compile)
        bh = m["ttft_budget"]
        bh.labels(component="queue_wait").observe(life.bud_queue)
        bh.labels(component="prefill_compute").observe(life.bud_prefill)
        bh.labels(component="affinity_miss").observe(life.bud_miss)
        bh.labels(component="compile_stall").observe(life.bud_compile)
        bh.labels(component="other").observe(max(ttft - known, 0.0))

    def _maybe_finish(self, seq: _Seq, finished: List[GenerationResult]):
        done_eos = (self.eos_token_id is not None and seq.out
                    and seq.out[-1] == self.eos_token_id)
        done_len = len(seq.out) >= seq.max_new
        if not (done_eos or done_len):
            return
        reason = "eos" if done_eos else "length"
        self._finish_obs(seq.rid, reason, seq.life, len(seq.out))
        finished.append(GenerationResult(
            request_id=seq.rid, prompt_ids=seq.prompt,
            output_ids=np.asarray(seq.out, np.int32),
            finish_reason=reason))
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
