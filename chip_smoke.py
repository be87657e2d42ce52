#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which must pass:

  1. the card (nvidia-smi name and power limit); build the CUDA kernels
     (nvcc, sm_90a: ragged paged attention's simple and sm90 designs,
     flash attention, B1's and B2's sm90 designs, norms, the
     multi-tensor update) and the block
     allocator (g++) from the checkout's sources, all at once, timed;
  2. the serving kernel (B3) against its plain PyTorch version in f32 on
     the card, at the engine's shapes (gpt3_1p3b's 16 heads, GQA, int8,
     padding, and llama2_7b's 32 heads), each design that takes a case
     within its limit (the simple one KERNEL_ATOL, the sm90 one twice
     the reference's own bf16 rounding), dead rows exactly 0, two faults
     planted in the plain version's masks rejected; timed by CUDA events
     and by CUDA-graph replay with the plan built outside, beside the
     plan alone, the plain version, the roofline bound of the same work
     and one torch.nn.functional.scaled_dot_product_attention call on
     the rows padded into a batch (a yardstick only);
  3. the flash-attention kernels (B1 forward, B2 backward) against their
     plain versions in nine cases (gpt2_small's and gpt3_1p3b's training
     shapes, GQA, segment ids, non-causal, cross-length causal both ways,
     head_dim 256, and the fused encoder's non-causal call on k/v views
     of a packed qkv projection), in bf16 and in f32,
     element by element relative to each row's size, with two faults
     planted in the kernels' outputs that the check must reject; the
     design each B1 and B2 call ran (sm90 for bf16 at head_dim 64/128,
     the simple kernels otherwise, or the phase fails) and its launches;
     timed beside their bound, the plain versions and
     torch.nn.functional.scaled_dot_product_attention (a yardstick
     only: the port never calls it); B1 and B2 in bf16 by single-call
     events and by CUDA-graph replay, beside the simple kernels and
     SDPA's forward (and its backward alone, by replay) in the same run;
  4. gpt3_1p3b (bf16, all 24 layers, random weights from seed 0) served
     by LLMEngine: 16 requests sharing a 512-token prefix, 64 new tokens
     each; B3's launch counters are read around this run (every launch
     sm90, one plan built per packed wave);
  5. the engine against the port's dense `generate` in f32 (TF32 off)
     on a 2-layer model at gpt3_1p3b's widths (B3's simple design);
  6. gpt2_small (all 12 layers, random weights from seed 0) trained by
     TrainStep in bf16 O1 with AdamW and flash attention, batch 16,
     seq 1024: 2 warm-up steps and 10 timed ones, the first call an
     eager step that is then captured as one CUDA graph, every later
     call a replay; the counters of B1/B2, the update kernel and the
     graphs, by design, are read around this run (a counter counts the
     eager step's launch and the captured one); the step timed by wall
     and by replay of its graph (the device's idle share), the update
     alone by replay beside its bound, B1/B2 by events in the eager
     step, peak memory;
  7. TrainStep with the flash kernels through its graph against the
     plain attention composite through its graph and against the
     kernels in eager steps, in f32 (TF32 off), on 2 layers at
     gpt2_small's widths: per-step losses, and the parameters after 3
     steps (the largest difference and the share of elements that
     differ);
  8. the norm kernels (B4 layer norm, B5 RMS norm) against their plain
     versions at the main paths' shapes and two edge cases, in bf16 and
     f32, with the affine on and off, element by element, with two
     faults planted that the check must reject; timed by CUDA-graph
     replay (device time only) beside their bound, the plain versions
     and one torch.nn.functional.layer_norm / rms_norm call (a
     yardstick only);
  9. llama2_7b (bf16, all 32 layers, random weights from seed 0) served
     by LLMEngine as in phase 4; B3's counters are read around it, as
     in phase 4, and B5 runs through incubate fused_rms_norm on every
     decoder layer's input captured during the first packed wave, held
     to the layer's own RMSNorm within the reference's split of the two
     forms, with B5's counters read around those calls;
 10. phase 5 for LLaMA: 2 layers at llama2_7b's widths with 8 kv heads
     (GQA through B3's simple design, whose launches it reports, and the
     decode path);
 11. 12 FusedTransformerEncoderLayers at bert_base's widths (post-LN,
     eval, bf16, batch 16 x seq 512): B4's and B1's counters read
     around one forward (24 and 12), B1's operands in that forward
     recorded and its results held to its plain version, the forward
     timed, and a 2-layer f32 copy on the card held to the same stack
     run on the CPU;
 12. the multi-tensor Adam update kernel against its plain version at
     gpt2_small's 148 parameter shapes: AdamW in f32 with two groups'
     decays, bf16 moments, Adam with coupled L2, bf16 parameters with
     f32 masters; element by element in ulps, a planted fault (one
     tensor's lr x 1.01) rejected; timed by events and by CUDA-graph
     replay beside its bound, the plain version and
     torch._fused_adamw_ (a yardstick only);
 13. bench.py::bench_gpt_1p3b's config trained at full width and depth
     (gpt3_1p3b: 24 layers, batch 4 x seq 2048, bf16 O1, AdamW with
     bf16 moments, flash attention, every third block recomputed,
     random weights from seed 0) through TrainStep's graph, 2 + 6
     calls: B1/B2 must take their sm90 design, the counters read around
     the eager first step and the capture must show 32 B1 launches a
     step (24 blocks and the 8 recomputed ones), 24 of B2 and 2 of the
     update (292 tensors, 192 a launch), every loss finite; the step by
     wall and by replay, the idle share, tokens/s, MFU and peak memory;
     then the same config without recompute, for what recompute costs
     and saves;
 14. recompute through TrainStep's graph against eager steps without
     it: gpt3_1p3b's widths at 4 layers, bf16 O1, dropout 0.1, one
     seed, 3 steps, at recompute intervals 1 and 3 under the "full" and
     "dots" policies: losses and parameters within phase 7's rule, the
     largest difference printed.

The last three lines of standard output are a JSON record of the
kernels, the card's name and power limit, and the final
{"ok": true, "device": ...} line. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# roofline bound of a launch is the larger of bytes / HBM rate and
# flops / bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12          # outside the tensor cores

# kernel vs plain tolerance (absolute, on f32 outputs of order 1): the
# plain version runs in f32 on the same bf16 values the kernel reads,
# and the kernel also computes in f32, so the two differ only in
# summation order (~1e-6). 1e-3 still catches a single key wrongly
# masked in or out of a ~500-key row (an error of order 1e-3..1e-2).
KERNEL_ATOL = 1e-3
# the design every B3 launch of the serving runs (phases 4 and 9) takes
B3_MAIN_DESIGN = "sm90"
# decode graphs a serving run may capture: one per page-table width
# bucket its chunks meet (tests/test_torch_decode_graph.py holds the
# bucket rule to this on the runs' traffic)
MAX_DECODE_GRAPHS = 4
B3_SOURCES = {"sm90": "ragged_paged_attention_sm90.cu",
              "simple": "ragged_paged_attention.cu"}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def kernel_events(**targets):
    """Measurement only: while the block runs, each wrapper named by
    targets (name=(module, attribute)) is timed by CUDA events around
    every call outside a CUDA-graph capture (a replay calls no wrapper);
    yields {name: [(start, end), ...]}, read after a synchronise. The
    wrappers are restored on exit."""
    import torch
    events = {name: [] for name in targets}
    saved = {name: getattr(m, a) for name, (m, a) in targets.items()}

    def timed(name, fn):
        def run(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)      # a capture runs nothing
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*args, **kw)
            e.record()
            events[name].append((s, e))
            return r
        return run

    for name, (m, a) in targets.items():
        setattr(m, a, timed(name, saved[name]))
    try:
        yield events
    finally:
        for name, (m, a) in targets.items():
            setattr(m, a, saved[name])


@contextlib.contextmanager
def capture_counts(read):
    """Measurement only: while the block runs, `read()` (a tuple of
    launch counters) is taken at the start and at the end of every
    CUDA-graph capture; yields [(before, after), ...], one pair a
    capture. A counter counts a launch of an eager run and one of a
    capture (which runs nothing) alike: this splits the two."""
    import torch
    spans = []
    base = torch.cuda.graph

    class counted(base):
        def __enter__(self):
            self._counts_before = read()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            spans.append((self._counts_before, read()))
            return out

    torch.cuda.graph = counted
    try:
        yield spans
    finally:
        torch.cuda.graph = base


@contextlib.contextmanager
def kernel_calls(module, attr):
    """Checking only: while the block runs, every call of the wrapper
    module.attr is recorded as (args, result), for holding the kernel's
    results on the main path against its plain version afterwards. The
    wrapper is restored on exit; nothing is launched by the recording."""
    calls = []
    saved = getattr(module, attr)

    def run(*args):
        r = saved(*args)
        calls.append((args, r))
        return r

    setattr(module, attr, run)
    try:
        yield calls
    finally:
        setattr(module, attr, saved)


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of `fn` over `iters` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, reps=20, iters=10):
    """Median device time of one `fn` call: `reps` calls captured in one
    CUDA graph and replayed `iters` times between CUDA events. Unlike
    cuda_ms, no host time enters: a call shorter than its wrapper's
    host path (argument checks, allocation, the launch) is timed as what
    the device spends on it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: card and builds
# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Build every native library at once (one compiler per source, all
    started together); returns {name: seconds}."""
    from paddle_tpu_torch.inference import paged_cache
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.kernels import norms
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    jobs = {"ragged_paged_attention.cu (nvcc)": rpa._load_kernel,
            "ragged_paged_attention_sm90.cu (nvcc)": rpa._load_sm90,
            "flash_attention.cu (nvcc)": fa._load_kernel,
            "flash_fwd_sm90.cu (nvcc)": fa._load_sm90,
            "flash_bwd_sm90.cu (nvcc)": fa._load_sm90_bwd,
            "norms.cu (nvcc)": norms._load_kernel,
            "multi_tensor_adam.cu (nvcc)": mta._load_kernel,
            "_block_allocator.cpp (g++)": paged_cache._load_lib}
    secs, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:          # reported below, run fails
            errors[name] = e
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    return secs


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version at the engine's shapes
# ---------------------------------------------------------------------------
def _token_bucket(n, quantum=128):
    """The engine's total-token bucket (LLMEngine._token_bucket)."""
    if n >= quantum:
        return -(-n // quantum) * quantum
    b = 8
    while b < n:
        b *= 2
    return b


def _case(name, rng, *, rows_spec, H=16, Hk=16, D=128, bs=64, NB=257,
          int8=False, shared_prefix_pages=0):
    """One packed launch. rows_spec: [(cached_tokens, new_tokens)] per
    live row (a row with 0 new tokens is an empty slot). Pages are drawn
    at random from the pool; the first `shared_prefix_pages` pages of
    every row are the same physical pages (a shared cached prefix)."""
    import torch
    B = len(rows_spec)
    T_raw = sum(m for _c, m in rows_spec)
    T = _token_bucket(T_raw)
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    shared = [free.pop() for _ in range(shared_prefix_pages)]
    c = 0
    for b, (cached, m) in enumerate(rows_spec):
        if m == 0:
            continue
        rows[c:c + m] = b
        pos[c:c + m] = cached + np.arange(m)
        kv_start[b] = cached
        npg = -(-(cached + m) // bs)
        pages = shared[:min(npg, len(shared))]
        pages = pages + [free.pop() for _ in range(npg - len(pages))]
        off[b, pages] = np.arange(npg) * bs
        c += m
    dev = "cuda"
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, bf)

    x = dict(q=rnd(T, H, D), k_new=rnd(T, Hk, D), v_new=rnd(T, Hk, D),
             rows=torch.from_numpy(rows).to(dev),
             pos=torch.from_numpy(pos).to(dev),
             kv_start=torch.from_numpy(kv_start).to(dev),
             off=torch.from_numpy(off).to(dev), kdq=None, vdq=None)
    with_pool = bool(kv_start.any())
    if int8:
        for k in ("kpool", "vpool"):
            x[k] = torch.from_numpy(rng.integers(
                -127, 128, (NB * bs, Hk, D)).astype(np.int8)).to(dev)
        x["kdq"] = torch.from_numpy(rng.uniform(
            0.005, 0.02, (Hk,)).astype(np.float32)).to(dev)
        x["vdq"] = torch.from_numpy(rng.uniform(
            0.005, 0.02, (Hk,)).astype(np.float32)).to(dev)
    else:
        x["kpool"] = rnd(NB * bs, Hk, D)
        x["vpool"] = rnd(NB * bs, Hk, D)
    meta = dict(name=name, T=T, T_live=T_raw, H=H, Hk=Hk, D=D, bs=bs,
                with_pool=with_pool, rows=rows, pos=pos, kv_start=kv_start,
                off=off)
    return x, meta


def _bound(meta, pool_itemsize):
    """(bound_ms, bound_by, bytes, flops) of one launch: each input byte
    read once (q, k_new, v_new of live tokens, metadata, the rows' valid
    pool slots counted once across rows sharing them), the f32 output
    written once; 4*D flops per valid (q head, key) pair."""
    rows, pos, kv_start, off = (meta[k] for k in ("rows", "pos",
                                                  "kv_start", "off"))
    H, Hk, D, bs = meta["H"], meta["Hk"], meta["D"], meta["bs"]
    live = rows >= 0
    pool_keys = np.zeros(len(kv_start), np.int64)
    slots = set()
    if meta["with_pool"]:
        for b in range(len(kv_start)):
            for p in np.flatnonzero(off[b] >= 0):
                n = int(np.clip(kv_start[b] - off[b, p], 0, bs))
                pool_keys[b] += n
                slots.update(range(p * bs, p * bs + n))
    pairs = 0
    for t in np.flatnonzero(live):
        r = rows[t]
        pairs += pool_keys[r] + int(((rows == r) & (pos <= pos[t])).sum())
    flops = 4 * D * H * pairs
    n_live = int(live.sum())
    nbytes = (n_live * (H + 2 * Hk) * D * 2 + 8 * len(rows)
              + len(slots) * Hk * D * pool_itemsize * 2
              + len(rows) * H * D * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


# B3's specs at the engine's shapes: (name, _case keywords)
def _ragged_specs(rng):
    prefix_tails = [(512, int(m)) for m in rng.integers(8, 33, 8)]
    return [
        ("fresh wave, no pool",
         dict(rows_spec=[(0, 512 + int(m)) for m in rng.integers(8, 33, 8)])),
        ("prefix-resume wave", dict(rows_spec=prefix_tails,
                                    shared_prefix_pages=8)),
        ("int8 pool + dequant", dict(rows_spec=prefix_tails,
                                     shared_prefix_pages=8, int8=True)),
        ("GQA H=16 Hk=4", dict(rows_spec=prefix_tails, Hk=4,
                               shared_prefix_pages=8)),
        ("dead padding rows",
         dict(rows_spec=[(100, 16), (0, 0), (777, 1), (0, 0), (64, 9),
                         (300, 5), (0, 0), (1000, 3)])),
        # llama2_7b's waves in phase 9: 32 heads, as many kv heads
        ("llama2_7b fresh wave H=32",
         dict(rows_spec=[(0, 512 + int(m)) for m in rng.integers(8, 33, 8)],
              H=32, Hk=32)),
        ("llama2_7b prefix-resume H=32",
         dict(rows_spec=prefix_tails, H=32, Hk=32, shared_prefix_pages=8)),
    ]


# faults planted in the plain version's masks (f32); their effect on the
# output, added to each design's result, must fail that design's check
RAGGED_PLANTED = ("one page's valid slots dropped",
                  "one fresh key past the diagonal let in")


def _ragged_planted(rpa, f32_args, common, meta, want) -> dict:
    """{fault: output change} of RAGGED_PLANTED on this case (a fault with
    no place in the case, such as a dropped page without a pool, is
    left out): the plain version in f32 run with the fault in its
    masks, less `want`. The dropped page is the first valid page of the
    first row with a pool; the key let in is the next token of the row
    of the query with the fewest valid keys."""
    import torch
    rows, pos, kv_start, off, bs = (meta[k] for k in (
        "rows", "pos", "kv_start", "off", "bs"))
    live = rows >= 0
    spots = {}
    if meta["with_pool"]:
        r = int(next(b for b in rows[live] if kv_start[b] > 0))
        pg = int(np.argmin(np.where(off[r] >= 0, off[r].astype(np.int64),
                                     2 ** 31)))
        n = int(min(kv_start[r] - off[r, pg], bs))
        spots[RAGGED_PLANTED[0]] = ("pool", np.flatnonzero(rows == r),
                                    slice(pg * bs, pg * bs + n))
    nkeys = [(kv_start[rows[t]] + int(((rows == rows[t])
                                       & (pos <= pos[t])).sum()), t)
             for t in np.flatnonzero(live)
             if ((rows == rows[t]) & (pos == pos[t] + 1)).any()]
    if nkeys:
        t = min(nkeys)[1]
        u = int(np.flatnonzero((rows == rows[t]) & (pos == pos[t] + 1))[0])
        spots[RAGGED_PLANTED[1]] = ("pack", np.array([t]), u)
    saved = rpa._masks_reference
    out = {}
    for what, (kind, toks, cols) in spots.items():
        def planted(*a, **kw):
            pool_ok, pack_ok = saved(*a, **kw)
            m = (pool_ok if kind == "pool" else pack_ok).clone()
            for t in toks:
                m[int(t), cols] = kind != "pool"
            return (m, pack_ok) if kind == "pool" else (pool_ok, m)
        rpa._masks_reference = planted
        try:
            bad = rpa._ragged_reference(*f32_args, meta["bs"],
                                        common["scale"], kdq=common["kdq"],
                                        vdq=common["vdq"],
                                        with_pool=common["with_pool"])
        finally:
            rpa._masks_reference = saved
        out[what] = bad - want
        del bad
    torch.cuda.synchronize()
    return out


def _sdpa_yardstick(x, meta, scale):
    """(call, unpack) for one torch.nn.functional.scaled_dot_product_attention
    call that computes the case's function (a yardstick only: the port
    never calls it for B3), or None for an int8 pool. Operands are
    padded and gathered outside the timed call: each live row's tokens,
    sorted by position, are one batch entry [B_live, H, Lq_max, D].
    Without a pool each row starts at position 0, so top-left is_causal
    is right for its valid tokens; with a pool the keys are the row's
    valid pool slots (in page order) then its fresh keys [B_live, Hk,
    Lk_max, D], under a boolean mask. unpack(o) scatters SDPA's output
    back to the packed [T, H, D] rows."""
    import torch
    import torch.nn.functional as tF
    if x["kpool"].dtype == torch.int8:
        return None
    rows, pos, kv_start, off, bs = (meta[k] for k in (
        "rows", "pos", "kv_start", "off", "bs"))
    wp = meta["with_pool"]
    live_rows = sorted({int(r) for r in rows if r >= 0})
    toks = [np.flatnonzero(rows == r) for r in live_rows]
    toks = [t[np.argsort(pos[t], kind="stable")] for t in toks]
    ctx = []
    for r in live_rows:
        sl = []
        if wp:
            for p in np.argsort(np.where(off[r] >= 0, off[r].astype(np.int64),
                                         2 ** 31), kind="stable"):
                n = int(np.clip(kv_start[r] - off[r, p], 0, bs))
                if off[r, p] < 0 or n == 0:
                    break
                sl.extend(range(p * bs, p * bs + n))
        ctx.append(np.asarray(sl, np.int64))
    Bl, H, D = len(live_rows), meta["H"], meta["D"]
    Hk = meta["Hk"]
    Lq = max(len(t) for t in toks)
    Lk = max(len(c) + len(t) for c, t in zip(ctx, toks))
    dev = x["q"].device
    qp = torch.zeros((Bl, H, Lq, D), dtype=x["q"].dtype, device=dev)
    kp = torch.zeros((Bl, Hk, Lk, D), dtype=x["q"].dtype, device=dev)
    vp = torch.zeros_like(kp)
    mask = torch.zeros((Bl, 1, Lq, Lk), dtype=torch.bool, device=dev)
    for i, (t, c) in enumerate(zip(toks, ctx)):
        ti = torch.from_numpy(t).to(dev)
        qp[i, :, :len(t)] = x["q"][ti].transpose(0, 1)
        if len(c):
            ci = torch.from_numpy(c).to(dev)
            kp[i, :, :len(c)] = x["kpool"][ci].transpose(0, 1)
            vp[i, :, :len(c)] = x["vpool"][ci].transpose(0, 1)
        kp[i, :, len(c):len(c) + len(t)] = x["k_new"][ti].transpose(0, 1)
        vp[i, :, len(c):len(c) + len(t)] = x["v_new"][ti].transpose(0, 1)
        ok = np.zeros((Lq, Lk), bool)
        ok[:, :len(c)] = True
        ok[:len(t), len(c):len(c) + len(t)] = pos[t][None, :] <= pos[t][:, None]
        ok[len(t):, 0] = True            # padded queries: any one key
        mask[i, 0] = torch.from_numpy(ok).to(dev)
    gqa = Hk != H
    if wp:
        call = lambda: tF.scaled_dot_product_attention(
            qp, kp, vp, attn_mask=mask, scale=scale, enable_gqa=gqa)
    else:
        call = lambda: tF.scaled_dot_product_attention(
            qp, kp, vp, is_causal=True, scale=scale, enable_gqa=gqa)

    def unpack(o):
        out = torch.zeros((len(rows), H, D), dtype=torch.float32,
                          device=dev)
        for i, t in enumerate(toks):
            out[torch.from_numpy(t).to(dev)] = \
                o[i, :, :len(t)].transpose(0, 1).float()
        return out
    return call, unpack


def ragged_case(rpa, name, kw, rng, timed=True) -> dict:
    """B3 at one phase 2 case: every design that takes the case (the
    simple one always; the tiled one for bf16 at head_dim 64/128) held
    to the plain version in f32 on the same bf16 values, each within its
    limit, with dead rows exactly 0 and the planted faults rejected; then
    (`timed`) each design by single-call events and by CUDA-graph replay
    with the plan built outside, the plan alone, the plain version, and
    the SDPA yardstick by events and by replay."""
    import torch
    x, meta = _case(name, rng, **kw)
    wp = meta["with_pool"]
    common = dict(block_size=meta["bs"], scale=1.0 / np.sqrt(meta["D"]),
                  kdq=x["kdq"], vdq=x["vdq"], with_pool=wp)
    args = [x[k] for k in ("q", "k_new", "v_new", "kpool", "vpool",
                           "rows", "pos", "kv_start", "off")]
    meta_args = (x["rows"], x["pos"], x["kv_start"], x["off"], meta["bs"],
                 wp)
    plan = rpa.ragged_plan(*meta_args)
    auto = rpa._rpa_design(x["q"].dtype, x["kpool"].dtype if wp else None,
                           meta["D"], True)
    designs = [d for d in rpa._RPA_DESIGNS if d == "simple" or d == auto]

    def kern(design):
        return lambda: rpa._ragged_cuda(*args, **common, _plan=plan,
                                        design=design)

    def plain():
        return rpa.ragged_paged_attention(*args, path="torch", **common)

    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    want = rpa.ragged_paged_attention(*f32, path="torch", **common)
    # the reference's own rounding: the plain version in its cast order
    # (q * scale and p cast to bf16 before the products) against f32
    gap = float((plain() - want).abs().max())
    tols = {"simple": KERNEL_ATOL, "sm90": max(KERNEL_ATOL, 2 * gap)}
    planted = _ragged_planted(rpa, f32, common, meta, want)
    dead = torch.from_numpy(meta["rows"] < 0).to(want.device)
    rec = dict(case=name, T=meta["T"], T_live=meta["T_live"], H=meta["H"],
               Hk=meta["Hk"], D=meta["D"], with_pool=wp, design=auto,
               reference_gap=gap, designs={})
    for d in designs:
        n0 = dict(rpa.ragged_paged_attention.design_launches)
        got = kern(d)()
        torch.cuda.synchronize()
        moved = {k: v - n0[k] for k, v in
                 rpa.ragged_paged_attention.design_launches.items()}
        err = float((got - want).abs().max())
        bad = {what: float((got + delta - want).abs().max())
               for what, delta in planted.items()}
        ok = (moved == {k: int(k == d) for k in moved}
              and bool(torch.isfinite(got).all()) and err <= tols[d]
              and (not dead.any() or bool((got[dead] == 0).all()))
              and all(e > tols[d] for e in bad.values()))
        if not ok:
            raise RuntimeError(
                f"kernel case {name!r} ({d}): max abs err {err} (limit "
                f"{tols[d]}), launches by design {moved}, planted {bad}, "
                "or non-finite / non-zero dead rows")
        rec["designs"][d] = dict(max_abs_err=err, tol=tols[d],
                                 planted_max_abs_err=bad)
        del got
    rec["max_abs_err"] = rec["designs"][auto]["max_abs_err"]
    if timed:
        for d in designs:
            rec["designs"][d].update(ms=cuda_ms(kern(d)),
                                     ms_graph=graph_ms(kern(d)))
        rec["ms"] = rec["designs"][auto]["ms"]
        rec["ms_graph"] = rec["designs"][auto]["ms_graph"]
        rec["simple_ms"] = rec["designs"]["simple"]["ms"]
        rec["simple_ms_graph"] = rec["designs"]["simple"]["ms_graph"]
        rec["plan_ms"] = cuda_ms(lambda: rpa.ragged_plan(*meta_args))
        rec["plain_ms"] = cuda_ms(plain, iters=10)
        lib = _sdpa_yardstick(x, meta, common["scale"])
        rec["library_ms"] = rec["library_ms_graph"] = None
        if lib is not None:
            call, unpack = lib
            with torch.no_grad():
                live = torch.from_numpy(meta["rows"] >= 0).to(want.device)
                rec["library_max_abs_err"] = float(
                    (unpack(call()) - want)[live].abs().max())
                rec["library_ms"] = cuda_ms(call)
                rec["library_ms_graph"] = graph_ms(call)
        (rec["bound_ms"], rec["bound_by"], rec["bytes"],
         rec["flops"]) = _bound(meta, x["kpool"].element_size())
    del x, args, f32, want, plan, planted
    torch.cuda.empty_cache()
    return rec


def _fmt_ms(v):
    return "n/a" if v is None else f"{v:.4f}"


def kernel_phase() -> list:
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    rng = np.random.default_rng(0)
    out = []
    for name, kw in _ragged_specs(rng):
        rec = ragged_case(rpa, name, kw, rng)
        by = "; ".join(
            f"{d} err {r['max_abs_err']:.3e} (limit {r['tol']:.3e}, planted "
            f"{ {k[:12]: round(v, 4) for k, v in r['planted_max_abs_err'].items()} }) "
            f"{r['ms']:.4f} ms by events, {r['ms_graph']:.4f} by replay"
            for d, r in rec["designs"].items())
        log(f"[kernel] {name}: T={rec['T']} (live {rec['T_live']}) "
            f"H={rec['H']} Hk={rec['Hk']} design {rec['design']}; {by}; "
            f"plan {rec['plan_ms']:.4f} ms; plain {rec['plain_ms']:.4f}; "
            f"SDPA {_fmt_ms(rec['library_ms'])} / "
            f"{_fmt_ms(rec['library_ms_graph'])} (err "
            f"{rec.get('library_max_abs_err')}); reference gap "
            f"{rec['reference_gap']:.3e}; bound {rec['bound_ms']:.5f} "
            f"({rec['bound_by']})")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 4: gpt3_1p3b served at full width and depth
# ---------------------------------------------------------------------------
def serve_phase(label, build, engine_kw, wave_hooks=None, after=None) -> dict:
    """Serve 16 requests sharing a 512-token prefix (64 new tokens each)
    through LLMEngine on the model `build()` returns ((model, cfg), bf16
    at full width and depth). `wave_hooks(model)` names modules whose
    inputs are captured during the first packed wave; `after(model,
    captured)` runs checks on them before the model is freed and returns
    a dict merged into the record."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    model, cfg = build()
    eng = LLMEngine(model, **engine_kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (512,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    (int(t),))])
               .astype(np.int32) for t in rng.integers(8, 33, 16)]
    n_new = 64

    # measurement only: wall time of each packed wave and of each decode
    # chunk (with its step count), and device time of each attention call
    # inside the waves (CUDA events, read after the run)
    waves, chunks, captured = [], [], []
    run_ragged = eng._run_ragged
    decode_chunk = eng._decode_chunk
    hooked = wave_hooks(model) if wave_hooks else []

    def timed_wave(entries):
        # measurement only: the first wave's hooked inputs are copied out
        handles = [] if waves else [m.register_forward_pre_hook(
            lambda _m, args: captured.append(args[0].detach().clone()))
            for m in hooked]
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run_ragged(entries)
        waves.append(time.perf_counter() - t)
        for h in handles:
            h.remove()
        return r

    def timed_chunk(cur, lens, tbl, chunk):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = decode_chunk(cur, lens, tbl, chunk)     # ends in a host copy
        chunks.append((time.perf_counter() - t, chunk, tbl.shape[1]))
        return r

    eng._run_ragged = timed_wave
    eng._decode_chunk = timed_chunk
    torch.cuda.reset_peak_memory_stats()
    with kernel_events(attn=(eng_mod, "ragged_paged_attention"),
                       plan=(eng_mod, "ragged_plan")) as events:
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=n_new)
        done, step_s = {}, []
        rpa.reset_counters()
        cuda_graph.reset_counters()
        t_run = time.perf_counter()
        while eng.has_unfinished:
            t = time.perf_counter()
            for r in eng.step():
                done[r.request_id] = r
            step_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        f = rpa.ragged_paged_attention
        launches, plain_calls = f.kernel_launches, f.plain_calls
        designs, plans = dict(f.design_launches), f.plan_builds
        graph_captures = cuda_graph.captures["engine_decode"]
        graph_replays = cuda_graph.replays["engine_decode"]
        capture_s = cuda_graph.capture_seconds["engine_decode"]
    attn_ms = sum(s.elapsed_time(e) for s, e in events["attn"])
    plan_ms = sum(s.elapsed_time(e) for s, e in events["plan"])

    bad = [i for i in range(len(prompts))
           if i not in done or done[i].finish_reason != "length"
           or len(done[i].output_ids) != n_new
           or not ((done[i].output_ids >= 0)
                   & (done[i].output_ids < cfg.vocab_size)).all()]
    st = eng.stats
    decode_steps = sum(n for _s, n, _w in chunks)
    widths = sorted({w for _s, _n, w in chunks})
    checks = {
        "every request returned 64 in-vocab tokens": not bad,
        f"every decode step replayed a captured graph ({decode_steps})":
            graph_replays == decode_steps,
        f"one graph captured per width bucket {widths}, at most "
        f"{MAX_DECODE_GRAPHS}": graph_captures == len(widths)
            <= MAX_DECODE_GRAPHS,
        "prefix cache hit (with_pool wave ran)":
            st["prefix_cache_hit_tokens"] > 0,
        "kernel launched": launches > 0,
        f"every B3 launch ran the {B3_MAIN_DESIGN} design":
            designs == {d: launches * (d == B3_MAIN_DESIGN)
                        for d in designs},
        "plain version never ran on CUDA tensors": plain_calls == 0,
        f"one plan built per packed wave ({len(waves)})":
            plans == len(waves),
    }
    for what, ok in checks.items():
        log(f"[engine] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"engine phase failed: bad={bad} stats={st}")
    n_tok = sum(len(r.output_ids) for r in done.values())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms, attn_step_ms, attn_err, attn_tol = _decode_device_ms(
        eng, widths[-1])
    ok = attn_err <= attn_tol
    log(f"[engine] check: decode attention on the card == on the CPU "
        f"(err {attn_err:.3e}, limit {attn_tol:.3e}): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("decode attention differs from its CPU version")
    rec = dict(config=label, layers=cfg.num_layers, tokens=n_tok,
               run_s=run_s, tokens_per_s=n_tok / run_s,
               steps=len(step_s), step_ms_mean=1e3 * run_s / len(step_s),
               step_ms_median=1e3 * statistics.median(step_s),
               step_ms_max=1e3 * max(step_s),
               ragged_waves_ms=[1e3 * w for w in waves],
               ragged_attention_ms=attn_ms, ragged_plan_ms=plan_ms,
               ragged_design_launches=designs, ragged_plan_builds=plans,
               decode_chunks_ms=[1e3 * s for s, _n, _w in chunks],
               decode_steps=decode_steps,
               # the chunks' wall time less the graphs' capture
               decode_ms_per_step=1e3 * (sum(s for s, _n, _w in chunks)
                                         - capture_s) / decode_steps,
               decode_graph_captures=graph_captures,
               decode_graph_replays=graph_replays,
               decode_graph_widths=widths, decode_capture_s=capture_s,
               # device time by replay: one graph step, and the
               # attention of one layer at the last width bucket
               decode_step_replay_ms=step_ms,
               decode_attention_replay_ms=attn_step_ms,
               decode_attention_err=attn_err,
               decode_attention_tol=attn_tol,
               decode_attention_share=cfg.num_layers * attn_step_ms
               / step_ms,
               # a floor for one batch decode step: every weight read once
               weight_read_ms=1e3 * weight_bytes / HBM_BYTES_PER_S,
               kernel_launches=launches,
               plain_calls=plain_calls, setup_s=setup_s,
               peak_mem_gb=peak_gb,
               stats={k: st[k] for k in (
                   "prefills", "preemptions", "decode_chunks",
                   "decode_tokens", "prefix_cache_hit_tokens",
                   "prefix_cache_miss_tokens", "ragged_launches")})
    if after is not None:
        rec.update(after(model, captured))
    log(f"[engine] {label} bf16 {cfg.num_layers} layers: {n_tok} tokens "
        f"in {run_s:.3f} s = {rec['tokens_per_s']:.1f} tokens/s; "
        f"{len(step_s)} steps, step wall ms mean "
        f"{rec['step_ms_mean']:.2f} median {rec['step_ms_median']:.2f} "
        f"max {rec['step_ms_max']:.2f}; ragged waves ms "
        f"{[round(w, 2) for w in rec['ragged_waves_ms']]}, attention "
        f"kernel time within them {attn_ms:.2f} ms over {launches} "
        f"launches ({designs}) and {plan_ms:.2f} ms of {plans} plans; "
        f"decode {decode_steps} steps at {rec['decode_ms_per_step']:.2f} ms "
        f"each (weight read floor {rec['weight_read_ms']:.3f} ms; "
        f"{graph_captures} graphs captured at widths {widths} in "
        f"{capture_s:.3f} s, {graph_replays} replays; a step by replay "
        f"{step_ms:.3f} ms, of which attention {cfg.num_layers} x "
        f"{attn_step_ms:.4f} ms = {100 * rec['decode_attention_share']:.1f} "
        f"%); "
        f"peak mem {rec['peak_mem_gb']:.2f} GiB; "
        f"stats {rec['stats']}; card {card_line()}")
    del eng, model, captured
    torch.cuda.empty_cache()
    return rec


def _decode_device_ms(eng, width):
    """Device ms of one decode step by replaying the engine's captured
    graph at `width` (chunks of 16 steps from the step counter's 0, 5
    times, between CUDA events), and of one layer's
    `_pool_decode_attention` by graph_ms at that width (8 rows, each
    row's length in its last page; every layer's pool in turn, so each
    read finds its pool cold in L2 as a step does), and that
    attention's largest difference (the first layer's pool) from the
    same call on the CPU (the
    card's bf16 products into f32 against the CPU's widened operands)
    with its limit: a p rounded the other way moves an output by at
    most one bf16 ulp of p (2^-7 of it) times |v|, so 2^-7 max |v|,
    plus 1e-5 for the f32 sums' order. Measurement only: the engine has
    served its requests, and the replays rewrite the slots its last
    chunk wrote."""
    import torch
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    graph = eng._dec_graphs[width]
    n = eng.decode_chunk
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        eng._dec_step.zero_()
        for _ in range(n):
            graph.graph.replay()
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / (5 * n)
    cfg = eng.model.config
    B, bs = eng.max_batch, eng.block_size
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q = torch.randn((B, cfg.num_heads, eng.fam.head_dim), generator=g,
                    device="cuda").to(eng.fam.dtype)
    nb = eng.cache.allocator.num_blocks
    tbl = (torch.arange(B * width, device="cuda") % (nb - 1) + 1
           ).reshape(B, width)
    lens = torch.full((B,), width * bs - 1, device="cuda")
    kcs, vcs = eng.cache.key_caches, eng.cache.value_caches
    kc, vc = kcs[0], vcs[0]
    scale = 1.0 / eng.fam.head_dim ** 0.5
    attn_ms = graph_ms(lambda: [eng_mod._pool_decode_attention(
        q, k, v, tbl, lens, scale, bs) for k, v in zip(kcs, vcs)],
        reps=2) / len(kcs)
    got = eng_mod._pool_decode_attention(q, kc, vc, tbl, lens, scale, bs)
    want = eng_mod._pool_decode_attention(q.cpu(), kc.cpu(), vc.cpu(),
                                          tbl.cpu(), lens.cpu(), scale, bs)
    err = float((got.cpu() - want).abs().max())
    tol = 2.0 ** -7 * float(vc.float().abs().max()) + 1e-5
    return step_ms, attn_ms, err, tol


def engine_phase() -> dict:
    """Phase 4: gpt3_1p3b served at full width and depth."""
    def build():
        from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
        cfg = gpt3_1p3b()
        return GPTForCausalLM(cfg, dtype="bfloat16", seed=0), cfg

    return serve_phase("gpt3_1p3b", build, dict(
        max_batch=8, block_size=64, decode_chunk=16, prompt_quantum=128))


# ---------------------------------------------------------------------------
# phase 5: engine == dense generate (f32, TF32 off)
# ---------------------------------------------------------------------------
def parity_phase(label="gpt3_1p3b", build=None) -> dict:
    """Greedy tokens of LLMEngine against the port's dense `generate`, in
    f32 with TF32 off, under the logit-margin guard, on the 2-layer
    model `build()` returns (gpt3_1p3b's widths by default)."""
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if build is None:
        cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
        model = GPTForCausalLM(cfg, dtype="float32", seed=1)
    else:
        model, cfg = build()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(190, 211, 4)]
    n_new, margin = 16, 1e-3
    engine_kw = dict(max_batch=4, block_size=64, decode_chunk=16,
                     prompt_quantum=128)
    eng = LLMEngine(model, **engine_kw)
    rpa.reset_counters()
    cuda_graph.reset_counters()
    res = eng.generate(prompts, max_new_tokens=n_new)
    # f32: B3's simple design (the tiled one takes bf16 only)
    designs = dict(rpa.ragged_paged_attention.design_launches)
    replays = cuda_graph.replays["engine_decode"]
    # the same traffic with the engine's decode steps run eagerly on the
    # card: the graphs' tokens must be exactly these
    eager = LLMEngine(model, **engine_kw)
    eager._eager_decode = True
    eager_res = eager.generate(prompts, max_new_tokens=n_new)
    graph_vs_eager = [i for i, (a, b) in enumerate(zip(res, eager_res))
                      if not np.array_equal(a.output_ids, b.output_ids)]
    guarded, mismatched, dense_vs_eager = [], [], []
    with torch.no_grad():
        for i, (p, r) in enumerate(zip(prompts, res)):
            # dense generate's graphs (use_fused_step=True) against its
            # eager loop on the card: exactly the same tokens
            dense = generate(model, p[None], max_new_tokens=n_new)
            if not torch.equal(dense, generate(model, p[None],
                                               max_new_tokens=n_new,
                                               use_fused_step=False)):
                dense_vs_eager.append(i)
            dense = dense[0].cpu().numpy()
            lg = model(torch.as_tensor(dense[None].astype(np.int64),
                                       device="cuda"))[0]
            top2 = torch.topk(lg[len(p) - 1:-1].float(), 2, dim=-1).values
            low = np.flatnonzero(
                (top2[:, 0] - top2[:, 1]).cpu().numpy() < margin)
            n = int(low[0]) if len(low) else n_new
            guarded.append(n)
            if not np.array_equal(r.output_ids[:n], dense[len(p):][:n]):
                mismatched.append(i)
    dense_replays = {k: cuda_graph.replays[k]
                     for k in ("generate_prefill", "generate_decode")}
    log(f"[parity] {label}: engine vs dense generate (f32, 2 layers): tokens "
        f"compared per request {guarded} of {n_new} (margin guard "
        f"{margin}); mismatched requests {mismatched}; B3 launches by "
        f"design {designs}; engine decode graph replays {replays}, "
        f"requests whose graph tokens differ from the eager steps' "
        f"{graph_vs_eager}; dense generate graph replays "
        f"{dict(dense_replays)}, requests whose graph tokens differ from "
        f"its eager loop's {dense_vs_eager}")
    if mismatched or min(guarded) == 0 or designs["simple"] == 0:
        raise RuntimeError("engine tokens differ from dense generate, or "
                           "B3's simple design did not run")
    if graph_vs_eager or replays == 0:
        raise RuntimeError("the engine's decode graphs did not run, or "
                           "their tokens differ from the eager steps'")
    if dense_vs_eager or dense_replays["generate_decode"] != len(prompts) \
            * (n_new - 1):
        raise RuntimeError("dense generate's graphs did not run every "
                           "decode step, or their tokens differ from its "
                           "eager loop's")
    del eng, eager, model
    torch.cuda.empty_cache()
    return dict(config=label, guarded=guarded, n_new=n_new,
                b3_design_launches=designs, engine_graph_replays=replays,
                engine_graph_vs_eager_mismatched=graph_vs_eager,
                generate_graph_replays=dense_replays,
                generate_graph_vs_eager_mismatched=dense_vs_eager)


# ---------------------------------------------------------------------------
# phase 3: B1/B2 (flash attention) vs their plain versions
# ---------------------------------------------------------------------------
# name: (b, sq, sk, H, Hk, D, causal, segments, packed): packed = k and v
# are strided views of one [b, s, 3, H, D] projection, as
# fused_multi_head_attention hands them to B1
FLASH_CASES = [
    ("a gpt2_small train", (16, 1024, 1024, 12, 12, 64, True, False, False)),
    ("b gpt3_1p3b train", (4, 2048, 2048, 16, 16, 128, True, False, False)),
    ("c GQA H16/Hk4", (4, 1024, 1024, 16, 4, 128, True, False, False)),
    ("d segment ids", (4, 1024, 1024, 12, 12, 64, True, True, False)),
    ("e non-causal", (4, 1024, 1024, 12, 12, 64, False, False, False)),
    ("f cross sq<sk", (4, 512, 1024, 12, 12, 64, True, False, False)),
    ("f cross sq>sk", (4, 1024, 512, 12, 12, 64, True, False, False)),
    ("g head_dim 256", (2, 1024, 1024, 8, 8, 256, True, False, False)),
    ("h fused encoder, packed qkv",
     (16, 512, 512, 12, 12, 64, False, False, True)),
]
# kernel vs plain tolerances, element by element: |got - want| <= tol *
# (|want| + rms of want's row + rms of want), a row being the head_dim
# axis of one (batch, token, head), so a late query row, ~30x smaller
# than row 0 in a causal 1024-token case, is held to about its own size.
# The tensor's rms covers rows that are 0 only by cancellation (dq of
# the first causal row), where both sides hold f32 noise. bf16: both sides
# round p (and ds) to bf16 before the products, the kernel relative to
# its running row max and the plain version to the final one; each
# rounding is off by up to 2^-9 relative, which moves a row by ~2^-9 of
# its rms; both round their outputs to bf16 (ulp 2^-8..2^-7 relative):
# 2^-6 is 2-4 ulps. f32: only the summation order differs (~1e-6
# relative). lse is held at the f32 limit to 1 + |lse|.
FLASH_TOL = {"bf16": 2.0 ** -6, "f32": 1e-4}
# faults planted in each case's kernel outputs, which the check must
# reject: the second half of the query rows' o off by 5 %, and the last
# 64-key tile's dv zeroed
PLANTED = ("o late rows x1.05", "dv last k tile zeroed")


def _flash_inputs(spec, dtype, seed):
    import torch
    b, sq, sk, H, Hk, D, causal, seg, packed = spec
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    scale = torch.tensor(D ** -0.5, dtype=dtype, device="cuda")
    if packed:
        # k and v stay views of the projection (read in place, row stride
        # 3*H*D); q is pre-scaled into a tensor of its own, as _FlashCore
        # does
        q, k, v = rnd(b, sq, 3, H, D).unbind(2)
        qs, do = q * scale, rnd(b, sq, H, D)
        if k.is_contiguous() or v.is_contiguous():
            raise RuntimeError("packed case: k/v are not strided views")
    else:
        qs = rnd(b, sq, H, D) * scale
        k, v, do = rnd(b, sk, Hk, D), rnd(b, sk, Hk, D), rnd(b, sq, H, D)
    segs = None
    if seg:
        # three packed documents per row and tail padding (-1 on both
        # sides); in row 0 the last 64 queries carry an id no key has,
        # so their rows are fully masked
        qseg = torch.full((b, sq), -1, dtype=torch.int32, device="cuda")
        kseg = torch.full((b, sk), -1, dtype=torch.int32, device="cuda")
        for r in range(b):
            cuts = [0, 300 + 17 * r, 620 + 9 * r, sq - 96, sq]
            for i in range(3):
                qseg[r, cuts[i]:cuts[i + 1]] = i
                kseg[r, cuts[i]:cuts[i + 1]] = i
        qseg[0, sq - 64:] = 9
        segs = (qseg, kseg)
    return qs, k, v, do, segs


def _valid_pairs(spec, segs):
    """(q head, q, k) pairs the mask leaves valid, counted from the data."""
    import torch
    b, sq, sk, H, Hk, D, causal, _seg, _packed = spec
    ok = torch.ones((1, sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        ok = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
              >= torch.arange(sk, device="cuda")[None, :])[None]
    if segs is not None:
        ok = ok & (segs[0][:, :, None] == segs[1][:, None, :])
        return int(ok.sum()) * H
    return int(ok.sum()) * b * H


def _flash_bound(spec, pairs, itemsize, bwd):
    """(bound_ms, bound_by, bytes, flops): 4*D flops per valid pair
    forward, 10*D backward (s recomputed, dv, dp, dk, dq); bytes are q, k,
    v, o (+ do, dq, dk, dv backward) and lse (+ delta), each once."""
    b, sq, sk, H, Hk, D, _causal, _seg, _packed = spec
    qo = b * sq * H * D * itemsize
    kv = b * sk * Hk * D * itemsize
    stats = b * H * sq * 4
    if bwd:
        nbytes, flops = 4 * qo + 4 * kv + 2 * stats, 10 * D * pairs
    else:
        nbytes, flops = 2 * qo + 2 * kv + stats, 4 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def _norm_err(got, want, rows=True):
    """The largest |got - want| / (|want| + rms of want's row + rms of
    want) over the elements, rows along the last axis (rows=False:
    |want| + 1); where `want` is all 0, any difference counts inf."""
    import torch
    got, want = got.float(), want.float()
    d = (got - want).abs()
    base = (want.pow(2).mean(-1, keepdim=True).sqrt()
            + want.pow(2).mean().sqrt()) if rows else 1.0
    scale = base + want.abs()
    r = torch.where(scale > 0, d / scale,
                    torch.where(d > 0, float("inf"), 0.0))
    return float(r.max())


def _check_flash(name, dt, got, want):
    """({tensor: max abs error}, {tensor: normalised error}, {planted
    fault: normalised error}) of the kernels' (o, lse, dq, dk, dv), or of
    B1's (o, lse) alone, against the plain versions'; raises unless every
    tensor is within FLASH_TOL and every planted fault beyond it."""
    abs_errs, errs = {}, {}
    for what, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if not torch_isfinite(g):
            raise RuntimeError(f"flash case {name!r} {dt}: {what} not finite")
        if what == "lse":
            # rows both sides mask fully (lse -1e30) compare exactly
            dead = w < -1e29
            if not bool((g[dead] == w[dead]).all()):
                raise RuntimeError(f"flash case {name!r}: masked rows' lse")
            g, w = g[~dead], w[~dead]
            err, tol = _norm_err(g, w, rows=False), FLASH_TOL["f32"]
        else:
            err, tol = _norm_err(g, w), FLASH_TOL[dt]
        if err > tol:
            raise RuntimeError(
                f"flash case {name!r} {dt}: {what} normalised err {err} > "
                f"{tol}")
        abs_errs[what] = float((g.float() - w.float()).abs().max())
        errs[what] = err
    o = got[0].clone()
    o[:, o.shape[1] // 2:] *= 1.05
    planted = {PLANTED[0]: _norm_err(o, want[0])}
    if len(got) == 5:           # B2's outputs too
        dv = got[4].clone()
        dv[:, -64:] = 0
        planted[PLANTED[1]] = _norm_err(dv, want[4])
    for what, e in planted.items():
        if e <= FLASH_TOL[dt]:
            raise RuntimeError(f"flash case {name!r} {dt}: the check passes "
                               f"a planted fault ({what}: {e})")
    return abs_errs, errs, planted


def torch_isfinite(t):
    import torch
    return bool(torch.isfinite(t).all()) if t.dtype.is_floating_point \
        else True


def _sdpa_fwd(qs, k, v, causal, grad):
    """SDPA's forward on [b, H, s, D] copies of the operands (a yardstick
    only: torch aligns is_causal top-left, so only sq == sk compares).
    `grad`: the inputs require grad, as in training, so the forward also
    keeps what its backward needs."""
    import torch.nn.functional as tF
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (qs, k, v))
    gqa = lk.shape[1] != lq.shape[1]
    return (lambda: tF.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal, scale=1.0, enable_gqa=gqa)), (lq, lk,
                                                                   lv)


def b1_times(spec, qs, k, v, segs, simple=True) -> dict:
    """Device times (ms) of B1 at one bf16 case: the design the main path
    takes, by single-call CUDA events (`fwd_ms`, host path included) and
    by CUDA-graph replay (`fwd_ms_graph`, device only); the simple
    kernel the same way where the design is not the simple one (and
    `simple`); SDPA's forward the same way where sq == sk and no
    segments (else None)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, sq, sk, H, Hk, D, causal, seg, _packed = spec
    design = fa._fwd_design(qs.dtype, D)
    run = lambda **kw: fa._fwd_cuda(qs, k, v, causal, segs, **kw)
    rec = dict(fwd_design=design, fwd_ms=cuda_ms(run),
               fwd_ms_graph=graph_ms(run), simple_fwd_ms=None,
               simple_fwd_ms_graph=None, library_fwd_ms=None,
               library_fwd_ms_graph=None)
    if simple and design != "simple":
        simple_run = lambda: run(design="simple")
        rec["simple_fwd_ms"] = cuda_ms(simple_run)
        rec["simple_fwd_ms_graph"] = graph_ms(simple_run)
    if sq == sk and not seg:
        lib, _ = _sdpa_fwd(qs, k, v, causal, grad=True)
        rec["library_fwd_ms"] = cuda_ms(lib)
        lib, _ = _sdpa_fwd(qs, k, v, causal, grad=False)
        with torch.no_grad():
            rec["library_fwd_ms_graph"] = graph_ms(lib)
    return rec


def b2_times(spec, qs, k, v, o, lse, do, segs, simple=True) -> dict:
    """Device times (ms) of B2 at one bf16 case, as b1_times times B1:
    the design the main path takes by single-call events (`bwd_ms`) and
    by CUDA-graph replay (`bwd_ms_graph`); the simple kernel both ways
    where the design is not the simple one (and `simple`); where sq ==
    sk and no segments, SDPA's forward + backward by events
    (`library_fwd_bwd_ms`) and its backward alone by replay
    (`library_bwd_ms_graph`: the captured forward + backward less the
    captured forward, both with inputs that require grad), else None."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, sq, sk, H, Hk, D, causal, seg, _packed = spec
    sc = D ** -0.5
    design = fa._bwd_design(qs.dtype, D)
    run = lambda **kw: fa._bwd_cuda(qs, k, v, o, lse, do, causal, segs, sc,
                                    **kw)
    rec = dict(bwd_design=design, bwd_ms=cuda_ms(run),
               bwd_ms_graph=graph_ms(run), simple_bwd_ms=None,
               simple_bwd_ms_graph=None, library_fwd_bwd_ms=None,
               library_bwd_ms_graph=None)
    if simple and design != "simple":
        simple_run = lambda: run(design="simple")
        rec["simple_bwd_ms"] = cuda_ms(simple_run)
        rec["simple_bwd_ms_graph"] = graph_ms(simple_run)
    if sq == sk and not seg:
        lib, lqkv = _sdpa_fwd(qs, k, v, causal, grad=True)
        ldo = do.transpose(1, 2).contiguous()
        fwd_bwd = lambda: torch.autograd.grad(lib(), lqkv, ldo)
        rec["library_fwd_bwd_ms"] = cuda_ms(fwd_bwd)
        rec["library_bwd_ms_graph"] = graph_ms(fwd_bwd) - graph_ms(lib)
    return rec


def flash_phase() -> list:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    out = []
    for i, (name, spec) in enumerate(FLASH_CASES):
        b, sq, sk, H, Hk, D, causal, seg, packed = spec
        if fa.attention_path((b, sq, H, D), (b, sk, Hk, D)) != ("cuda", ""):
            raise RuntimeError(f"flash case {name!r} would not take the "
                               "kernels")
        rec = dict(case=name, b=b, sq=sq, sk=sk, H=H, Hk=Hk, D=D,
                   causal=causal, segments=seg, packed_qkv=packed)
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            qs, k, v, do, segs = _flash_inputs(spec, dtype, seed=i)
            sc = D ** -0.5
            n0 = dict(fa.flash_fwd.design_launches)
            o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
            rec[f"fwd_design_launches_{dt}"] = {
                d: n - n0[d] for d, n in fa.flash_fwd.design_launches.items()}
            n0 = dict(fa.flash_bwd.design_launches)
            dq, dk, dv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal,
                                      segs, path="cuda")
            torch.cuda.synchronize()
            got = {d: n - n0[d]
                   for d, n in fa.flash_bwd.design_launches.items()}
            rec[f"bwd_design_launches_{dt}"] = got
            # bf16 at head_dim 64/128 runs the sm90 design, the rest the
            # simple one
            want = "sm90" if dt == "bf16" and D in fa._SM90_D else "simple"
            if got != {d: int(d == want) for d in got}:
                raise RuntimeError(f"flash case {name!r} {dt}: B2 ran "
                                   f"{got}, expected one {want} launch")
            wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
            # B2 from the same (o, lse) on both sides
            wdq, wdk, wdv = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal,
                                         segs, path="torch")
            abs_errs, errs, planted = _check_flash(
                name, dt, (o, lse, dq, dk, dv), (wo, wlse, wdq, wdk, wdv))
            rec[f"max_abs_err_{dt}"] = abs_errs
            rec[f"norm_err_{dt}"] = errs
            rec[f"planted_norm_err_{dt}"] = planted
            del wo, wlse, wdq, wdk, wdv
            if dt == "bf16":
                pairs = _valid_pairs(spec, segs)
                rec["valid_pairs"] = pairs
                rec.update(b1_times(spec, qs, k, v, segs))
                rec.update(b2_times(spec, qs, k, v, o, lse, do, segs))
                rec["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_fwd(
                    qs, k, v, causal, segs, path="torch"), iters=5)
                rec["plain_bwd_ms"] = cuda_ms(lambda: fa.flash_bwd(
                    qs, k, v, o, lse, do, sc, causal, segs, path="torch"),
                    iters=5)
                for kind in ("fwd", "bwd"):
                    bms, by, nb, fl = _flash_bound(spec, pairs, 2,
                                                   kind == "bwd")
                    rec[f"{kind}_bound_ms"], rec[f"{kind}_bound_by"] = bms, by
                    rec[f"{kind}_bytes"], rec[f"{kind}_flops"] = nb, fl
            del qs, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()
        fmt = lambda d: {k: f"{e:.2e}" for k, e in d.items()}
        log(f"[flash] {name}: b={b} sq={sq} sk={sk} H={H}/{Hk} D={D} "
            f"causal={causal} seg={seg}; normalised err bf16 "
            f"{fmt(rec['norm_err_bf16'])} (tol {FLASH_TOL['bf16']:.2e}; "
            f"planted {fmt(rec['planted_norm_err_bf16'])}) f32 "
            f"{fmt(rec['norm_err_f32'])} (tol {FLASH_TOL['f32']:.0e}; "
            f"planted {fmt(rec['planted_norm_err_f32'])}); max abs err bf16 "
            f"{fmt(rec['max_abs_err_bf16'])}; launches by design: B1 bf16 "
            f"{rec['fwd_design_launches_bf16']} f32 "
            f"{rec['fwd_design_launches_f32']}, B2 bf16 "
            f"{rec['bwd_design_launches_bf16']} f32 "
            f"{rec['bwd_design_launches_f32']}")
        log(f"[flash] {name}: B1 bf16 ({rec['fwd_design']}) "
            f"{rec['fwd_ms']:.4f} ms by events, {rec['fwd_ms_graph']:.4f} "
            f"by graph replay (bound {rec['fwd_bound_ms']:.4f}, "
            f"{rec['fwd_bound_by']}; simple {rec['simple_fwd_ms']} / "
            f"{rec['simple_fwd_ms_graph']}; library {rec['library_fwd_ms']}"
            f" / {rec['library_fwd_ms_graph']}; plain "
            f"{rec['plain_fwd_ms']:.3f}); "
            f"B2 bf16 ({rec['bwd_design']}) {rec['bwd_ms']:.4f} ms by "
            f"events, {rec['bwd_ms_graph']:.4f} by graph replay (bound "
            f"{rec['bwd_bound_ms']:.4f}, {rec['bwd_bound_by']}; simple "
            f"{rec['simple_bwd_ms']} / {rec['simple_bwd_ms_graph']}; "
            f"library fwd+bwd {rec['library_fwd_bwd_ms']} by events, bwd "
            f"{rec['library_bwd_ms_graph']} by replay; plain "
            f"{rec['plain_bwd_ms']:.3f})")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 6: gpt2_small trained by TrainStep at full width and depth
# ---------------------------------------------------------------------------
def _gpt_train_step(cfg, use_amp, lr=1e-4, seed=0, moment_dtype=None):
    """bench.py::bench_gpt's step: an f32 GPTForCausalLM, AdamW(lr,
    weight decay 0.01, moments in `moment_dtype`), bf16 O1 auto_cast
    around the forward when `use_amp`, GPTPretrainingCriterion."""
    from paddle_tpu_torch import TrainStep, amp
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01, moment_dtype=moment_dtype)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids, labels):
        with amp.auto_cast(enable=use_amp, level="O1", dtype="bfloat16"):
            logits = m(ids)
        return crit(logits, labels)

    return model, TrainStep(model, opt, loss_fn)


def _replay_ms(graph, iters=5):
    """Median device time of one replay of `graph` (CUDA events)."""
    import torch
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _counted_steps(step, ids, labels, n_calls) -> dict:
    """`n_calls` TrainStep calls, each synchronised and timed by wall,
    with the counters of B1, B2, the update kernel and the graphs set to
    0 just before and read just after. The first call runs the step
    eagerly and captures it; every later call replays the graph, which
    runs the captured launches again without calling the wrappers: a
    counter counts a launch of the eager step and one of the capture,
    and the card runs the captured launches once a replay. The counters
    read around each capture split the two, so the launches on the card
    are the eager step's plus the captured step's times the replays.
    Launch tuples are (B1, B2, update)."""
    import torch
    from paddle_tpu_torch.jit import cuda_graph
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta

    def read():
        return (fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches,
                mta.multi_tensor_adam.kernel_launches)

    with capture_counts(read) as spans:
        fa.reset_counters()
        mta.multi_tensor_adam.kernel_launches = 0
        mta.multi_tensor_adam.plain_calls = 0
        cuda_graph.reset_counters()
        losses, step_s = [], []
        for _ in range(n_calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(loss)
        counted = read()
        run = dict(
            designs=dict(fa.flash_fwd.design_launches),
            bwd_designs=dict(fa.flash_bwd.design_launches),
            plain=(fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls),
            update_plain=mta.multi_tensor_adam.plain_calls,
            captures=dict(cuda_graph.captures),
            replays=dict(cuda_graph.replays),
            capture_s=cuda_graph.capture_seconds["train_step"])
    in_graph = tuple(sum(b[i] - a[i] for a, b in spans) for i in range(3))
    eager = tuple(c - g for c, g in zip(counted, in_graph))
    n_replays = run["replays"].get("train_step", 0)
    run.update(
        counted=counted, in_graph=in_graph, eager=eager,
        on_device=tuple(e + g * n_replays for e, g in zip(eager, in_graph)),
        distinct=len({x.data_ptr() for x in losses}) == len(losses),
        losses=[float(x) for x in losses], step_s=step_s)
    return run


def train_phase() -> dict:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import gpt2_small, num_params
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    batch, seq, warmup, steps = 16, 1024, 2, 10
    path = fa.attention_path((batch, seq, cfg.num_heads, cfg.head_dim),
                             (batch, seq, cfg.num_heads, cfg.head_dim))
    if path != ("cuda", ""):
        raise RuntimeError(f"gpt2_small attention would not take the "
                           f"kernels: {path}")
    t0 = time.perf_counter()
    model, step = _gpt_train_step(cfg, use_amp=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    run = _counted_steps(step, ids, labels, warmup + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted, in_graph, eager, on_device = (
        run[k] for k in ("counted", "in_graph", "eager", "on_device"))
    designs, bwd_designs = run["designs"], run["bwd_designs"]
    plain, update_plain = run["plain"], run["update_plain"]
    captures, replays = run["captures"], run["replays"]
    capture_s, losses, step_s = run["capture_s"], run["losses"], run["step_s"]
    n_replays = replays.get("train_step", 0)
    timed_s = step_s[warmup:]
    n_steps = warmup + steps
    L = cfg.num_layers
    checks = {
        "every loss finite": all(np.isfinite(losses)),
        "every returned loss a tensor of its own": run["distinct"],
        "one graph captured, every later step a replay": (
            captures, replays) == ({"train_step": 1},
                                   {"train_step": n_steps - 1}),
        "B1 and B2 at 12 launches in the captured step and 12 in the "
        "eager one": in_graph[:2] == eager[:2] == (L, L),
        "every B1 launch ran the sm90 design": designs == {
            "sm90": 2 * L, "simple": 0},
        "every B2 launch ran the sm90 design": bwd_designs == {
            "sm90": 2 * L, "simple": 0},
        "plain versions never ran on CUDA tensors": plain == (0, 0),
        "attention_path names the kernels": path == ("cuda", ""),
        "the update kernel at one launch in the captured step and one "
        "in the eager one": (in_graph[2], eager[2]) == (1, 1),
        "no plain update call": update_plain == 0,
    }
    for what, ok in checks.items():
        log(f"[train] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"training phase failed: {run}")
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    # the update alone, by replay, on the model's own tensors and state
    # (a gradient from a seed; measurement after the run)
    opt = step.optimizer
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = [mta.AdamSlot(p.detach(), torch.randn(
        p.shape, device="cuda", generator=gen) * 1e-3,
        *(opt._get_state(p)[k] for k in ("moment1", "moment2",
                                          "beta1_pow", "beta2_pow")),
        wd=0.01) for p in model.parameters()]
    lr_t = opt._lr_tensor(opt.get_lr(), torch.device("cuda"))
    update_ms = graph_ms(lambda: mta.multi_tensor_adam(
        slots, lr_t, beta1=opt.beta1, beta2=opt.beta2, eps=opt.epsilon,
        decoupled=True), reps=5, iters=10)
    update_bound = _update_bound(slots)
    del slots
    # B1/B2 device time by events in an eager step (a replay calls no
    # wrapper), outside the counted run: the second of two, since the
    # first allocates its activations anew (the graph's pool holds the
    # earlier ones) and the host then stretches its kernels
    step._eager = True
    step(ids, labels)
    with kernel_events(fwd=(fa, "_fwd_cuda"), bwd=(fa, "_bwd_cuda")) \
            as events:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        eager_step_ms = 1e3 * (time.perf_counter() - t)
    step._eager = False
    per_step = {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in events.items()}
    n = num_params(cfg)
    tok_s = batch * seq * steps / sum(timed_s)
    med = statistics.median(timed_s)
    rec = dict(config="gpt2_small", layers=L, batch=batch, seq=seq,
               params=n, warmup_steps=warmup, timed_steps=steps,
               tokens_per_s=tok_s, step_ms_median=1e3 * med,
               step_ms=[1e3 * x for x in timed_s],
               first_step_ms=1e3 * step_s[0], captures=captures,
               capture_s=capture_s, replays=replays,
               step_ms_replay=replay_ms,
               idle_share=1 - replay_ms / (1e3 * med),
               mfu=6.0 * n * tok_s / BF16_FLOPS_PER_S,
               step_floor_ms=6.0 * n * batch * seq / BF16_FLOPS_PER_S * 1e3,
               eager_step_ms=eager_step_ms,
               b1_ms_per_step=per_step["fwd"],
               b2_ms_per_step=per_step["bwd"],
               b1_launches=counted[0], b2_launches=counted[1],
               b1_design_launches=designs, b2_design_launches=bwd_designs,
               launches_in_graph=list(in_graph),
               launches_eager=list(eager),
               b1_launches_on_device=on_device[0],
               b2_launches_on_device=on_device[1],
               plain_calls=list(plain), update_launches=counted[2],
               update_launches_on_device=on_device[2],
               update_plain_calls=update_plain, update_ms_graph=update_ms,
               update_bound_ms=update_bound[0],
               update_bound_by=update_bound[1], losses=losses,
               setup_s=setup_s, peak_mem_gb=peak)
    log(f"[train] gpt2_small bf16 O1 AdamW, {L} layers, batch {batch} x "
        f"seq {seq}: {tok_s:.1f} tokens/s, step median {1e3 * med:.2f} ms "
        f"by wall, {replay_ms:.2f} ms by replay of the step graph (device "
        f"idle {100 * rec['idle_share']:.1f} %; 6ND floor "
        f"{rec['step_floor_ms']:.2f} ms), MFU {rec['mfu']:.4f}; first "
        f"call (eager step + capture) {rec['first_step_ms']:.1f} ms, "
        f"captures {captures} in {capture_s:.3f} s, replays {replays}; "
        f"update {update_ms:.4f} ms by replay (bound {update_bound[0]:.4f}"
        f" ms, {update_bound[1]}); a second eager step after the run "
        f"{eager_step_ms:.2f} ms by wall, B1 {per_step['fwd']:.3f} ms + "
        f"B2 {per_step['bwd']:.3f} ms of device time in it; launches "
        f"(B1, B2, update) counted {counted}: eager {eager}, captured "
        f"step {in_graph}, on the card {on_device} over {n_replays} "
        f"replays; peak mem {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}")
    del model, step
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 7: TrainStep with the kernels == TrainStep with the composite
# ---------------------------------------------------------------------------
def _params_diff(pa, pb, lr):
    """(largest |a - b|, elements beyond 1e-3 * lr, elements)."""
    err = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    far = sum(int(((pa[k] - pb[k]).abs() > 1e-3 * lr).sum()) for k in pa)
    return err, far, sum(v.numel() for v in pa.values())


def train_parity_phase() -> dict:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.nn import functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, n_steps = 1e-4, 3
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50304, (2, 512)).astype(np.int32)
    labels = rng.integers(0, 50304, (2, 512)).astype(np.int32)
    runs = {}
    sdpa_takes_kernel = F._sdpa_takes_kernel
    # (flash kernels, through the step graph): the kernels and the
    # composite through the graph, and the kernels in eager steps
    for flash, graphed in ((True, True), (False, True), (True, False)):
        cfg = dataclasses.replace(
            gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                       use_flash_attention=flash), num_layers=2)
        model, step = _gpt_train_step(cfg, use_amp=False, lr=lr, seed=1)
        step._eager = not graphed
        n0 = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
        if not flash:
            # the composite, forced plain: SDPA would route this call into
            # the kernels on the card
            F._sdpa_takes_kernel = lambda *a: False
        try:
            losses = [float(step(ids, labels)) for _ in range(n_steps)]
        finally:
            F._sdpa_takes_kernel = sdpa_takes_kernel
        n1 = fa.flash_fwd.kernel_launches, fa.flash_bwd.kernel_launches
        # a graph counts the eager first step's launches and the
        # captured step's; eager steps count each of theirs
        want = cfg.num_layers * (2 if graphed else n_steps) if flash else 0
        if (n1[0] - n0[0], n1[1] - n0[1]) != (want, want):
            raise RuntimeError(f"parity run flash={flash} graphed={graphed}:"
                               f" kernel launches {n1} from {n0}, expected "
                               f"+{want}")
        runs[flash, graphed] = (losses, {k: v.detach().clone() for k, v in
                                         model.state_dict().items()})
        del model, step
    bound = 2 * lr * n_steps
    # the share of parameter elements that differ by more than 1e-3 * lr:
    # a sign flip of a near-zero gradient moves an Adam parameter by up to
    # ~2 lr a step, so one element may reach the bound, but in f32 such
    # flips are rare (the key bias, whose gradient is zero up to rounding);
    # a wrong dq, dk or dv moves every parameter it reaches by ~lr.
    # f32 on both sides (kernels in full f32, cuBLAS without TF32): only
    # summation order differs, ~1e-6 relative on the loss
    out = {}
    for what, other in (("composite", (False, True)),
                        ("eager", (True, False))):
        (lk, pk), (lc, pc) = runs[True, True], runs[other]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lc))
        param_err, far, n = _params_diff(pk, pc, lr)
        ok = loss_err <= 1e-5 and param_err <= bound and far / n < 2e-3
        log(f"[train-parity] f32, 2 layers, batch 2 x seq 512, {n_steps} "
            f"steps, kernels through the step graph vs {what}: losses "
            f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lc]} "
            f"(max rel diff {loss_err:.2e}, tol 1e-5); params max abs diff "
            f"{param_err:.2e} (bound 2*lr*steps = {bound:.1e}), {far} of "
            f"{n} elements differ by more than 1e-3*lr (share "
            f"{far / n:.2e}, tol 2e-3): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"TrainStep with the kernels through the "
                               f"graph differs from the {what} run")
        out[what] = dict(losses=lc, loss_max_rel_diff=loss_err,
                         param_max_abs_diff=param_err, params_far=far)
    torch.cuda.empty_cache()
    return dict(losses_kernels_graph=runs[True, True][0],
                param_bound=bound, params_total=n, **out)


# ---------------------------------------------------------------------------
# phase 8: B4 (layer norm) and B5 (RMS norm) vs their plain versions
# ---------------------------------------------------------------------------
# (name, rows, width): the main paths' shapes and two edge cases
NORM_CASES = [
    ("llama2_7b prefill", 8192, 4096),
    ("llama decode", 8, 4096),
    ("bert_base", 8192, 768),
    ("gpt3_1p3b", 8192, 2048),
    # rows not 16-byte aligned: the scalar path, 8 warps a row
    ("odd rows, width not a multiple of 8", 7, 1001),
    ("wide row", 64, 16384),
]
# kernel vs plain, element by element: |got - want| <= tol * (|want| +
# floor * rms of want's row). Both compute the same f32 value (sums in
# other orders, rsqrtf within 2 ulps) and round it once: one ulp of the
# output dtype apart (bf16 <= 2^-7 relative), or, for a value near 0
# after centring, f32 noise of the row's size.
NORM_TOL = {"bf16": (2.0 ** -7, 2.0 ** -8), "f32": (1e-5, 1.0)}
# fused_rms_norm (the kernel form: weight in f32, one cast) against
# LLaMA's RMSNorm (the reference's plain op: cast, then the weight in
# bf16): the known split of the reference, two bf16 roundings apart
SPLIT_TOL = (2.0 ** -6, 2.0 ** -8)
NORM_PLANTED = ("late row x(1+2^-5)", "last column's weight dropped")


def _lim_err(got, want, tol):
    """The largest |got - want| / (tol[0] * (|want| + tol[1] * rms of
    want's row)) over the elements: above 1 fails."""
    import torch
    got, want = got.float(), want.float()
    row = want.pow(2).mean(-1, keepdim=True).sqrt()
    lim = tol[0] * (want.abs() + tol[1] * row)
    d = (got - want).abs()
    return float(torch.where(lim > 0, d / lim,
                             torch.where(d > 0, float("inf"), 0.0)).max())


def _norm_bound(kind, n, h, itemsize, affine):
    """(bound_ms, bound_by, bytes, flops): x read and out written once,
    w (and b) read once; f32 flops per element (layer norm: sum, centre,
    square-add, centre, scale = 6; RMS: square-add, scale = 3; +1 for
    each affine term) over the card's f32 rate outside the tensor cores."""
    terms = (2 if kind == "layer_norm" else 1) if affine else 0
    nbytes = 2 * n * h * itemsize + terms * h * itemsize
    flops = n * h * ((6 if kind == "layer_norm" else 3) + terms)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def norm_phase() -> list:
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import norms
    out = []
    for ci, (name, n, h) in enumerate(NORM_CASES):
        for kind in ("layer_norm", "rms_norm"):
            fwd = norms.layer_norm_fwd if kind == "layer_norm" \
                else norms.rms_norm_fwd
            eps = 1e-5 if kind == "layer_norm" else 1e-6
            for dt, dtype in (("bf16", torch.bfloat16),
                              ("f32", torch.float32)):
                g = torch.Generator(device="cuda")
                g.manual_seed(ci)
                x = (torch.randn((n, h), generator=g, device="cuda") * 2
                     + 1).to(dtype)
                w = torch.rand((h,), generator=g, device="cuda") + 0.5
                w[-1] = 0.6          # away from 1: dropping it is a fault
                w = w.to(dtype)
                b = torch.randn((h,), generator=g, device="cuda").to(dtype)
                for affine in (True, False):
                    wa = w if affine else None
                    ba = b if affine and kind == "layer_norm" else None
                    args = (x, wa, ba) if kind == "layer_norm" else (x, wa)

                    def kern():
                        return fwd(*args, eps, path="cuda")

                    def plain():
                        return fwd(*args, eps, path="torch")

                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    if not torch.isfinite(got).all() or \
                            got.dtype != dtype or got.shape != x.shape:
                        raise RuntimeError(f"norm case {name!r} {kind} {dt}"
                                           ": non-finite or wrong shape")
                    err = _lim_err(got, want, NORM_TOL[dt])
                    if err > 1.0:
                        raise RuntimeError(
                            f"norm case {name!r} {kind} {dt} affine="
                            f"{affine}: normalised err {err} > 1")
                    planted = {}
                    if affine:
                        late = got.clone()
                        r = n - 1 - n // 4
                        late[r] = (late[r].float() * (1 + 2 ** -5)).to(dtype)
                        # a copy: float() of an f32 tensor is the tensor
                        no_w = got.float().clone()
                        shift = b[-1].float() if ba is not None else 0.0
                        no_w[:, -1] = (no_w[:, -1] - shift) / w[-1].float() \
                            + shift
                        planted = dict(zip(NORM_PLANTED, (
                            _lim_err(late, want, NORM_TOL[dt]),
                            _lim_err(no_w.to(dtype), want, NORM_TOL[dt]))))
                        for what, e in planted.items():
                            if e <= 1.0:
                                raise RuntimeError(
                                    f"norm case {name!r} {kind} {dt}: the "
                                    f"check passes a planted fault ({what}:"
                                    f" {e})")
                    if kind == "layer_norm":
                        lib = lambda: tF.layer_norm(x, (h,), wa, ba, eps)
                    else:
                        lib = lambda: tF.rms_norm(x, (h,), wa, eps)
                    bms, by, nb, fl = _norm_bound(kind, n, h,
                                                  x.element_size(), affine)
                    rec = dict(case=name, kind=kind, n=n, h=h, dtype=dt,
                               affine=affine, norm_err=err,
                               max_abs_err=float((got.float() - want.float())
                                                 .abs().max()),
                               planted_norm_err=planted, ms=graph_ms(kern),
                               plain_ms=graph_ms(plain),
                               library_ms=graph_ms(lib),
                               call_ms=cuda_ms(kern), bound_ms=bms,
                               bound_by=by, bytes=nb, flops=fl)
                    out.append(rec)
                    log(f"[norms] {kind} {name} [{n}, {h}] {dt} affine="
                        f"{affine}: normalised err {err:.3f} (planted "
                        f"{ {k: round(v, 2) for k, v in planted.items()} }) "
                        f"max abs err {rec['max_abs_err']:.2e}; kernel "
                        f"{rec['ms']:.4f} ms (bound {bms:.4f}, {by}; one "
                        f"call with its host path {rec['call_ms']:.4f}); "
                        f"plain {rec['plain_ms']:.4f}; library "
                        f"{rec['library_ms']:.4f}")
                del x, w, b
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: llama2_7b served at full width and depth; B5 on its activations
# ---------------------------------------------------------------------------
def _rms_on_activations(model, captured) -> dict:
    """B5 through fused_rms_norm on the inputs of every decoder layer's
    input norm, captured during the first packed wave, against the
    model's own RMSNorm (the reference's plain op) within the split of
    the two forms, and against B5's plain version. B5's counters are set
    to 0 just before the fused_rms_norm calls and read just after."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.kernels import norms
    layers = list(model.llama.layers)
    if len(captured) != len(layers):
        raise RuntimeError(f"captured {len(captured)} layer inputs, "
                           f"expected {len(layers)}")
    fwd = norms.rms_norm_fwd
    with torch.no_grad():
        fwd.kernel_launches = fwd.plain_calls = 0
        outs = [fused_rms_norm(x, l.input_layernorm.weight,
                               l.input_layernorm.epsilon)
                for l, x in zip(layers, captured)]
        torch.cuda.synchronize()
        launches, plain_calls = fwd.kernel_launches, fwd.plain_calls
        split = max(_lim_err(o, l.input_layernorm(x), SPLIT_TOL)
                    for o, l, x in zip(outs, layers, captured))
        vs_plain = max(_lim_err(o, fwd(x, l.input_layernorm.weight,
                                       l.input_layernorm.epsilon,
                                       path="torch"), NORM_TOL["bf16"])
                       for o, l, x in zip(outs, layers, captured))
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    checks = {
        f"B5 launched once per layer ({len(layers)})":
            launches == len(layers),
        "B5's plain version never ran on CUDA tensors": plain_calls == 0,
        "fused_rms_norm == the layer's RMSNorm within the split":
            split <= 1.0 and finite,
        "B5 == its plain version on real activations": vs_plain <= 1.0,
    }
    for what, ok in checks.items():
        log(f"[engine] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"B5 on real activations failed: launches "
                           f"{launches} plain {plain_calls} split {split} "
                           f"vs plain {vs_plain}")
    log(f"[engine] B5 on {len(outs)} layers' real inputs "
        f"{list(captured[0].shape)}: normalised err vs RMSNorm {split:.3f} "
        f"(tol {SPLIT_TOL}), vs plain {vs_plain:.3f}")
    return dict(b5_launches=launches, b5_plain_calls=plain_calls,
                b5_rows=int(captured[0].shape[0]),
                b5_split_norm_err=split, b5_vs_plain_norm_err=vs_plain)


def llama_engine_phase() -> dict:
    def build():
        import torch
        from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
        cfg = llama2_7b()
        model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=0)
        # RMSNorm weights are constructed as 1; a trained model's are not,
        # and at 1 the two forms of the norm would not differ: draw them
        # from N(1, 0.1), seeded
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("norm.weight"):
                    p.normal_(1.0, 0.1, generator=g)
        return model, cfg

    return serve_phase(
        "llama2_7b", build,
        dict(max_batch=8, block_size=64, decode_chunk=16, prompt_quantum=128,
             max_model_len=1024),
        wave_hooks=lambda m: [l.input_layernorm for l in m.llama.layers],
        after=_rms_on_activations)


def llama_parity_phase() -> dict:
    """Phase 10: engine == dense generate on 2 layers at llama2_7b's
    widths with 8 kv heads (GQA through B3 and decode)."""
    def build():
        from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
        cfg = dataclasses.replace(llama2_7b(), num_layers=2, num_kv_heads=8)
        return LlamaForCausalLM(cfg, dtype="float32", seed=1), cfg

    return parity_phase("llama2_7b 2 layers GQA 32/8", build)


# ---------------------------------------------------------------------------
# phase 11: the incubate fused path (FusedTransformerEncoderLayer)
# ---------------------------------------------------------------------------
BERT_BASE = dict(d_model=768, nhead=12, dim_feedforward=3072,
                 activation="gelu")


def _encoder_stack(n_layers, dtype, device="cuda"):
    """bert_base-wide post-LN FusedTransformerEncoderLayers in eval,
    layer i seeded with 4 * i."""
    import torch
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    stack = torch.nn.Sequential(*[FusedTransformerEncoderLayer(
        **BERT_BASE, dropout_rate=0.1, normalize_before=False,
        device=device, dtype=dtype, seed=4 * i) for i in range(n_layers)])
    return stack.eval()


def fused_phase() -> dict:
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norms
    n_layers, batch, seq = 12, 16, 512
    stack = _encoder_stack(n_layers, "bfloat16")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((batch, seq, BERT_BASE["d_model"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    counters = (norms.layer_norm_fwd, fa.flash_fwd)
    with torch.no_grad():
        torch.cuda.synchronize()
        norms.layer_norm_fwd.kernel_launches = 0
        norms.layer_norm_fwd.plain_calls = 0
        fa.reset_counters()
        with kernel_calls(fa, "_fwd_cuda") as b1_calls:
            y = stack(x)
        torch.cuda.synchronize()
        launches = tuple(c.kernel_launches for c in counters)
        designs = dict(fa.flash_fwd.design_launches)
        plain = tuple(c.plain_calls for c in counters)
        # B1 on the main path's operands (pre-scaled q, k and v as views
        # of each layer's qkv projection) against its plain version
        b1_err = b1_lse_err = 0.0
        for (qs, k, v, causal, segs), (o, lse) in b1_calls:
            wo, wlse = fa.flash_fwd(qs, k, v, causal, segs, path="torch")
            b1_err = max(b1_err, _norm_err(o, wo))
            b1_lse_err = max(b1_lse_err, _norm_err(lse, wlse, rows=False))
        strided = bool(b1_calls) and not b1_calls[0][0][1].is_contiguous()
        del b1_calls
        fwd_ms = cuda_ms(lambda: stack(x), iters=5, warmup=1)
        with kernel_events(b4=(norms, "_norm_cuda"), b1=(fa, "_fwd_cuda")) \
                as events:
            stack(x)
        torch.cuda.synchronize()
    split = {k: sum(s.elapsed_time(e) for s, e in v)
             for k, v in events.items()}
    ok_out = bool(torch.isfinite(y).all()) and y.shape == x.shape
    # 2 layers in f32: the card (kernels, TF32 off) against the same
    # stack and weights on the CPU (plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    small = _encoder_stack(2, "float32")
    cpu = _encoder_stack(2, "float32", device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    xs = torch.randn((2, seq, BERT_BASE["d_model"]), generator=g,
                     device="cuda")
    with torch.no_grad():
        got = small(xs)
        want = cpu(xs.cpu())
    parity = _lim_err(got.cpu(), want, (1e-4, 1.0))
    checks = {
        "output finite, of the input's shape": ok_out,
        f"B4 launched twice per layer ({2 * n_layers})":
            launches[0] == 2 * n_layers,
        f"B1 launched once per layer ({n_layers})": launches[1] == n_layers,
        "every B1 launch ran the sm90 design": designs == {
            "sm90": n_layers, "simple": 0},
        "plain versions never ran on CUDA tensors": plain == (0, 0),
        "B1 read k and v in place as strided views": strided,
        f"B1 == its plain version on the layers' operands (o within "
        f"{FLASH_TOL['bf16']:.2e}, lse within {FLASH_TOL['f32']:.0e})":
            b1_err <= FLASH_TOL["bf16"] and b1_lse_err <= FLASH_TOL["f32"],
        "2-layer f32 stack on the card == on the CPU (1e-4 relative)":
            parity <= 1.0,
    }
    for what, ok in checks.items():
        log(f"[fused] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"fused phase failed: launches {launches} B1 by "
                           f"design {designs} plain "
                           f"{plain} B1 err {b1_err} lse {b1_lse_err} "
                           f"parity {parity}")
    rec = dict(layers=n_layers, batch=batch, seq=seq, forward_ms=fwd_ms,
               b4_ms_per_forward=split["b4"], b1_ms_per_forward=split["b1"],
               b4_launches=launches[0], b1_launches=launches[1],
               b1_design_launches=designs,
               plain_calls=list(plain), b1_norm_err=b1_err,
               b1_lse_norm_err=b1_lse_err, parity_norm_err=parity)
    log(f"[fused] {n_layers} x FusedTransformerEncoderLayer (bert_base, "
        f"post-LN, bf16, eval), batch {batch} x seq {seq}: forward "
        f"{fwd_ms:.3f} ms, of which B4 {split['b4']:.3f} ms and B1 "
        f"{split['b1']:.3f} ms of device time (events around the "
        f"wrappers); B4 {launches[0]} and B1 {launches[1]} launches; B1 vs "
        f"plain on the layers' operands: o {b1_err:.2e}, lse "
        f"{b1_lse_err:.2e}; 2-layer f32 card vs CPU normalised err "
        f"{parity:.3f}")
    del stack, small, cpu, x, y
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 12: the multi-tensor Adam update vs its plain version
# ---------------------------------------------------------------------------
# (name, AdamW (decoupled decay) or Adam (coupled L2), moment dtype, grad
# dtype, bf16 parameters with f32 masters, decays of the two groups:
# matrices, then vectors)
UPDATE_CASES = [
    ("adamw f32, two groups' decays", True, "float32", "float32", False,
     (0.01, 0.1)),
    ("adamw bf16 moments", True, "bfloat16", "float32", False, (0.01, 0.0)),
    ("adam coupled L2", False, "float32", "float32", False, (0.01, 0.01)),
    ("adamw bf16 params with f32 masters", True, "float32", "bfloat16", True,
     (0.01, 0.01)),
]
# kernel vs plain, element by element, in units of the last place of the
# stored type at the plain value (or at the tensor's rms, if larger): the
# kernel computes the plain
# version's f32 operations in the same order with no FMA contraction and
# rounds each store to nearest even as the plain casts do, so 2 f32 ulps
# and 1 bf16 ulp; a planted 1 % error in one tensor's lr moves its
# elements by ~1e-2 of an update, hundreds of f32 ulps
UPDATE_ULPS = {"float32": 2, "bfloat16": 1}
UPDATE_MANTISSA = {"float32": 23, "bfloat16": 7}
UPDATE_LR, UPDATE_STEPS = 1e-4, 3


def _ulp_err(got, want):
    """The largest |got - want| in units of the last place of want's
    dtype at |want|, or at the tensor's rms where |want| is smaller (a
    value that is small by cancellation carries its terms' rounding)."""
    import torch
    dt = str(want.dtype).split(".")[-1]
    w = want.double()
    floor = max(float(w.square().mean().sqrt()) if w.numel() else 0.0,
                torch.finfo(want.dtype).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(floor)))
                     - UPDATE_MANTISSA[dt])
    return float(((got.double() - w).abs() / ulp).max()) if w.numel() \
        else 0.0


def _update_bound(slots):
    """(bound_ms, bound_by, bytes, flops): each element reads w, g, m
    and v once and writes w, m, v (and a master's cast) once; ~17 f32
    operations an element over the card's f32 rate outside the tensor
    cores."""
    nbytes = flops = 0
    for s in slots:
        n = s.w.numel()
        nbytes += n * (2 * 4 + s.g.element_size()
                       + 4 * s.m.element_size()
                       + (0 if s.out is None else s.out.element_size()))
        flops += 17 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", int(nbytes), int(flops))


def _update_slots(shapes, init, case, seed):
    """One case's slots at gpt2_small's parameter shapes: w from the
    model's initial weights, a gradient and moments from `seed` (the
    moments of a run some steps in), powers at step 10."""
    import torch
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    _, _, mdt, gdt, masters, decays = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slots = []
    for shape, w0 in zip(shapes, init):
        w = w0.clone()
        g = (torch.randn(shape, device="cuda", generator=gen) * 1e-3).to(
            getattr(torch, gdt))
        m = (torch.randn(shape, device="cuda", generator=gen) * 1e-4).to(
            getattr(torch, mdt))
        v = (torch.rand(shape, device="cuda", generator=gen) * 1e-7).to(
            getattr(torch, mdt))
        pows = [torch.full((), b ** 10, device="cuda") for b in (0.9, 0.999)]
        slots.append(mta.AdamSlot(
            w, g, m, v, *pows, wd=decays[0] if len(shape) > 1 else decays[1],
            out=w.to(torch.bfloat16) if masters else None))
    return slots


def _update_errs(got, want):
    """{array: largest error in ulps} over every slot, and whether the
    powers agree exactly."""
    errs = {}
    for k in ("w", "m", "v", "out"):
        pairs = [(getattr(a, k), getattr(b, k)) for a, b in zip(got, want)
                 if getattr(a, k) is not None]
        if pairs:
            errs[k] = max(_ulp_err(a, b) for a, b in pairs)
    pows = all(bool(a.beta1_pow == b.beta1_pow)
               and bool(a.beta2_pow == b.beta2_pow)
               for a, b in zip(got, want))
    return errs, pows


def update_phase() -> list:
    """Phase 12: the update kernel against its plain version at
    gpt2_small's 148 parameter shapes, a fault planted, timed."""
    import torch
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    model = GPTForCausalLM(gpt2_small(), device="cuda", dtype="float32",
                           seed=0)
    init = [p.detach().clone() for p in model.parameters()]
    shapes = [tuple(p.shape) for p in init]
    del model
    lr = torch.full((), UPDATE_LR, device="cuda")
    out = []
    for ci, case in enumerate(UPDATE_CASES):
        name, decoupled, mdt, gdt, masters, _ = case
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled)
        got = _update_slots(shapes, init, case, seed=ci)
        want = _update_slots(shapes, init, case, seed=ci)
        planted = _update_slots(shapes, init, case, seed=ci)
        n0 = mta.multi_tensor_adam.kernel_launches
        big = max(range(len(shapes)), key=lambda i: got[i].w.numel())
        for _ in range(UPDATE_STEPS):
            mta.multi_tensor_adam(got, lr, **kw)
            mta.multi_tensor_adam(want, lr, path="torch", **kw)
            # the planted fault: the largest tensor's lr off by 1 %
            mta.multi_tensor_adam(planted[:big] + planted[big + 1:], lr,
                                  path="torch", **kw)
            mta.multi_tensor_adam(planted[big:big + 1], lr * 1.01,
                                  path="torch", **kw)
        torch.cuda.synchronize()
        launches = mta.multi_tensor_adam.kernel_launches - n0
        errs, pows = _update_errs(got, want)
        perrs, _ = _update_errs(got, planted)
        limits = {"w": UPDATE_ULPS["float32"], "m": UPDATE_ULPS[mdt],
                  "v": UPDATE_ULPS[mdt], "out": UPDATE_ULPS["bfloat16"]}
        max_abs = max(float((a.w - b.w).abs().max())
                      for a, b in zip(got, want))
        moved = max(float((a.w - w0).abs().max())
                    for a, w0 in zip(got, init))
        del planted
        bms, by, nbytes, flops = _update_bound(got)
        rec = dict(case=name, tensors=len(shapes),
                   elements=sum(s.w.numel() for s in got), ulp_err=errs,
                   planted_ulp_err=perrs, powers_equal=pows,
                   max_abs_err=max_abs, moved=moved, launches=launches,
                   bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
        rec["ms_graph"] = graph_ms(
            lambda: mta.multi_tensor_adam(got, lr, **kw), reps=5, iters=10)
        rec["ms"] = cuda_ms(lambda: mta.multi_tensor_adam(got, lr, **kw),
                            iters=10)
        rec["plain_ms"] = cuda_ms(lambda: mta.multi_tensor_adam(
            want, lr, path="torch", **kw), iters=5)
        rec["library_ms"] = None
        if ci == 0:
            # a yardstick only, never on the port's path: torch's fused
            # AdamW decays first and rounds in another order
            steps = [torch.full((), 10.0, device="cuda") for _ in got]
            ws, gs = [s.w for s in got], [s.g for s in got]
            ms_, vs = [s.m for s in got], [s.v for s in got]
            rec["library_ms"] = graph_ms(lambda: torch._fused_adamw_(
                ws, gs, ms_, vs, [], steps, lr=UPDATE_LR, beta1=0.9,
                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                maximize=False), reps=5, iters=10)
        ok = (launches == UPDATE_STEPS and pows and moved > UPDATE_LR
              and all(e <= limits[k] for k, e in errs.items())
              and perrs["w"] > limits["w"])
        log(f"[update] {name}: {len(shapes)} tensors, {rec['elements']} "
            f"elements, {launches} launches in {UPDATE_STEPS} steps; err "
            f"in ulps {errs} (limits {limits}), powers equal {pows}; "
            f"planted lr x1.01 on the largest tensor: w err "
            f"{perrs['w']:.1f} ulps (must exceed {limits['w']}); kernel "
            f"{rec['ms_graph']:.4f} ms by replay, {rec['ms']:.4f} by "
            f"events; bound {bms:.4f} ({by}); plain {rec['plain_ms']:.3f};"
            f" torch._fused_adamw_ {rec['library_ms']}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"update phase failed: {rec}")
        del got, want
        torch.cuda.empty_cache()
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 13: bench_gpt_1p3b's config trained at full width and depth
# ---------------------------------------------------------------------------
# bench.py::bench_gpt_1p3b (bench.py:167-190): GPT-3 XL widths, batch 4 x
# seq 2048, bf16 O1, AdamW with bf16 moments, flash attention, every
# third block recomputed ("full": only its input kept)
B1P3_BATCH, B1P3_SEQ, B1P3_INTERVAL = 4, 2048, 3


def _train_1p3b(recompute: bool) -> dict:
    """One TrainStep run of bench_gpt_1p3b's config (with or without
    recompute) through its graph, 2 warm-up calls and 6 timed: counters,
    losses, the step by wall and by replay, peak memory from a freed
    card."""
    import gc

    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt3_1p3b, num_params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30    # by earlier phases
    cfg = gpt3_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                    use_flash_attention=True, recompute=recompute,
                    recompute_interval=B1P3_INTERVAL,
                    recompute_policy="full")
    b, s, warmup, steps = B1P3_BATCH, B1P3_SEQ, 2, 6
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    picked = (fa.attention_path(shape, shape),
              fa._fwd_design(torch.bfloat16, cfg.head_dim),
              fa._bwd_design(torch.bfloat16, cfg.head_dim))
    if picked != (("cuda", ""), "sm90", "sm90"):
        raise RuntimeError(f"gpt3_1p3b attention would not take B1/B2's "
                           f"sm90 kernels: {picked}")
    model, step = _gpt_train_step(cfg, use_amp=True, lr=1e-4, seed=0,
                                  moment_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    run = _counted_steps(step, ids, labels, warmup + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_layers
    remat = len(range(0, L, B1P3_INTERVAL)) if recompute else 0
    per_step = (L + remat, L, 2)
    n_calls = warmup + steps
    checks = {
        "every loss finite": all(np.isfinite(run["losses"])),
        "one graph captured, every later step a replay": (
            run["captures"], run["replays"]) == (
            {"train_step": 1}, {"train_step": n_calls - 1}),
        f"(B1, B2, update) at {per_step} launches in the eager step and "
        f"in the captured one": run["eager"] == run["in_graph"] == per_step,
        "every B1 and B2 launch ran the sm90 design": (
            run["designs"], run["bwd_designs"]) == (
            {"sm90": 2 * per_step[0], "simple": 0},
            {"sm90": 2 * per_step[1], "simple": 0}),
        "no plain version ran on CUDA tensors": run["plain"] == (0, 0)
            and run["update_plain"] == 0,
    }
    label = "recompute" if recompute else "no recompute"
    for what, ok in checks.items():
        log(f"[train-1p3b] {label}: check: {what}: "
            f"{'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"1.3B training phase failed ({label}): {run}")
    graph = next(iter(step._graphs.values()))[0].graph
    replay_ms = _replay_ms(graph)
    timed = run["step_s"][warmup:]
    wall_ms = 1e3 * statistics.median(timed)
    n = num_params(cfg)
    tok_s = b * s / (wall_ms / 1e3)
    rec = dict(
        config="gpt3_1p3b (bench_gpt_1p3b)", recompute=recompute,
        recompute_interval=B1P3_INTERVAL if recompute else None,
        recomputed_blocks=remat, layers=L, batch=b, seq=s, params=n,
        timed_steps=steps, step_ms_median=wall_ms,
        step_ms=[1e3 * x for x in timed],
        first_step_ms=1e3 * run["step_s"][0], capture_s=run["capture_s"],
        step_ms_replay=replay_ms, idle_share=1 - replay_ms / wall_ms,
        tokens_per_s=tok_s, mfu=6.0 * n * tok_s / BF16_FLOPS_PER_S,
        step_floor_ms=6.0 * n * b * s / BF16_FLOPS_PER_S * 1e3,
        peak_mem_gb=peak, held_at_start_gb=held,
        launches_counted=list(run["counted"]),
        launches_eager=list(run["eager"]),
        launches_in_graph=list(run["in_graph"]),
        launches_on_device=list(run["on_device"]),
        captures=run["captures"], replays=run["replays"],
        losses=run["losses"])
    log(f"[train-1p3b] {label}: {L} layers, batch {b} x seq {s}, "
        f"{n} params: step median {wall_ms:.2f} ms by wall "
        f"({min(rec['step_ms']):.2f}-{max(rec['step_ms']):.2f} over "
        f"{steps}), {replay_ms:.2f} ms by replay (device idle "
        f"{100 * rec['idle_share']:.1f} %); {tok_s:.1f} tokens/s, MFU "
        f"{rec['mfu']:.4f} (6ND floor {rec['step_floor_ms']:.2f} ms); peak "
        f"mem {peak:.2f} GiB ({held:.2f} of it held by earlier phases at "
        f"the start); first call {rec['first_step_ms']:.0f} ms "
        f"(capture {run['capture_s']:.2f} s); launches (B1, B2, update) "
        f"eager {run['eager']}, captured step {run['in_graph']}, on the "
        f"card {run['on_device']}; losses "
        f"{[round(x, 4) for x in run['losses']]}")
    del model, step, graph
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_1p3b_phase() -> dict:
    """Phase 13: bench_gpt_1p3b's config with recompute, then without
    it: what recompute costs in step time and saves in memory."""
    with_r = _train_1p3b(recompute=True)
    without = _train_1p3b(recompute=False)
    log(f"[train-1p3b] recompute costs "
        f"{with_r['step_ms_median'] - without['step_ms_median']:.2f} ms a "
        f"step by wall ({with_r['step_ms_replay'] - without['step_ms_replay']:.2f}"
        f" by replay) and saves "
        f"{without['peak_mem_gb'] - with_r['peak_mem_gb']:.2f} GiB of peak "
        f"memory")
    return dict(recompute=with_r, no_recompute=without)


# ---------------------------------------------------------------------------
# phase 14: recompute through TrainStep's graph == no recompute, eager
# ---------------------------------------------------------------------------
# (recompute_interval, policy) of the graph runs held to the eager run
RECOMPUTE_CASES = ((1, "full"), (3, "full"), (1, "dots"), (3, "dots"))


def recompute_parity_phase() -> dict:
    """gpt3_1p3b's widths at 4 layers, bf16 O1, dropout 0.1, one seed:
    3 TrainStep steps through the graph with recompute, for each case,
    against 3 eager steps without it. Equal masks and equal kernels
    should make the two equal bit for bit; they are held to phase 7's
    rule (no element beyond 2 * lr * steps, fewer than 2e-3 of them
    beyond 1e-3 * lr: one block's masks drawn anew move nearly every
    parameter by ~lr), losses within 1e-5 relative, and the largest
    difference is recorded."""
    import gc

    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt3_1p3b
    lr, n_steps, layers = 1e-4, 3, 4
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50304, (2, 1024)).astype(np.int32)
    labels = rng.integers(0, 50304, (2, 1024)).astype(np.int32)
    base = dataclasses.replace(
        gpt3_1p3b(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                  use_flash_attention=True), num_layers=layers)

    def run(cfg, eager):
        model, step = _gpt_train_step(cfg, use_amp=True, lr=lr, seed=0,
                                      moment_dtype="bfloat16")
        step._eager = eager
        n0 = fa.flash_fwd.kernel_launches
        losses = [float(step(ids, labels)) for _ in range(n_steps)]
        b1 = fa.flash_fwd.kernel_launches - n0
        params = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        return losses, params, b1

    want_losses, want, _ = run(base, eager=True)
    out = []
    for interval, policy in RECOMPUTE_CASES:
        cfg = dataclasses.replace(base, recompute=True,
                                  recompute_interval=interval,
                                  recompute_policy=policy)
        losses, got, b1 = run(cfg, eager=False)
        # the eager first step's launches and the captured step's
        want_b1 = 2 * (layers + len(range(0, layers, interval)))
        loss_err = max(abs(a - w) / abs(w)
                       for a, w in zip(losses, want_losses))
        err, far, n = _params_diff(got, want, lr)
        ok = (b1 == want_b1 and all(np.isfinite(losses))
              and loss_err <= 1e-5 and err <= 2 * lr * n_steps
              and far / n < 2e-3)
        log(f"[recompute-parity] interval {interval}, {policy}: graph "
            f"steps with recompute vs eager steps without, losses "
            f"{[round(x, 5) for x in losses]} vs "
            f"{[round(x, 5) for x in want_losses]} (max rel diff "
            f"{loss_err:.2e}, tol 1e-5); params max abs diff {err:.3e} "
            f"(bound {2 * lr * n_steps:.1e}), {far} of {n} beyond 1e-3*lr;"
            f" B1 launches {b1} (expected {want_b1}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"recompute parity failed at interval "
                               f"{interval}, {policy}")
        out.append(dict(interval=interval, policy=policy, losses=losses,
                        loss_max_rel_diff=loss_err, param_max_abs_diff=err,
                        params_far=far, b1_launches=b1))
    return dict(eager_losses=want_losses, cases=out)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    secs = build_all()
    log("[build] " + "; ".join(f"{k}: {v:.1f} s" for k, v in secs.items()))
    cases = kernel_phase()
    flash = flash_phase()
    engine = engine_phase()
    parity = parity_phase()
    train = train_phase()
    train_parity = train_parity_phase()
    norm_cases = norm_phase()
    llama = llama_engine_phase()
    llama_parity = llama_parity_phase()
    fused = fused_phase()
    updates = update_phase()
    train_1p3b = train_1p3b_phase()
    recompute_parity = recompute_parity_phase()
    main_case = cases[0]    # the engine's fresh wave: its largest launch
    fmain = flash[0]        # gpt2_small's training shape
    src = "paddle_tpu_torch/kernels/csrc/"
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source=src + B3_SOURCES[main_case["design"]],
        replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:313",
        launches=engine["kernel_launches"],
        max_abs_err=max(r["max_abs_err"] for c in cases
                        for r in c["designs"].values()),
        # ms by single-call events (the wrapper's host path included) and
        # by CUDA-graph replay (device only), the plan built outside both;
        # the simple design and SDPA's yardstick by replay
        ms=main_case["ms"], ms_graph=main_case["ms_graph"],
        design=main_case["design"], simple_ms=main_case["simple_ms_graph"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        library_ms_graph=main_case["library_ms_graph"], cases=cases)]
    t13 = train_1p3b["recompute"]
    for i, (kind, name, line, launches, source) in enumerate((
            ("fwd", "flash_attention_fwd", 267,
             train["b1_design_launches"]["sm90"], "flash_fwd_sm90.cu"),
            ("bwd", "flash_attention_bwd", 457,
             train["b2_design_launches"]["sm90"], "flash_bwd_sm90.cu"))):
        kernels.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
            # counted: the eager first step's and the captured step's;
            # run on the card: the eager step's and the captured step's
            # times the replays, from the counters read around the capture
            launches=launches,
            launches_on_device=train[f"b{1 if kind == 'fwd' else 2}"
                                     "_launches_on_device"],
            # phase 13's path (gpt3_1p3b, recompute every third block):
            # counted over its eager step and capture, and run on the card
            launches_1p3b=t13["launches_counted"][i],
            launches_on_device_1p3b=t13["launches_on_device"][i],
            max_abs_err=max(e for c in flash for what, e in
                            c["max_abs_err_bf16"].items()
                            if (what in ("o", "lse")) == (kind == "fwd")),
            ms=fmain[f"{kind}_ms"], plain_ms=fmain[f"plain_{kind}_ms"],
            bound_ms=fmain[f"{kind}_bound_ms"],
            bound_by=fmain[f"{kind}_bound_by"],
            library_ms=fmain["library_fwd_ms" if kind == "fwd"
                             else "library_fwd_bwd_ms"],
            # by graph replay (device time only), the design, and the
            # simple kernel at the same shape by graph replay; B2's
            # library time by replay is SDPA's backward alone
            ms_graph=fmain[f"{kind}_ms_graph"],
            library_ms_graph=fmain[f"library_{kind}_ms_graph"],
            design=fmain[f"{kind}_design"],
            simple_ms=fmain[f"simple_{kind}_ms_graph"],
            cases=flash))
    # B4 at the fused encoder's shape, B5 at LLaMA-2-7B's packed prefill,
    # both bf16 with their affine; launches from phases 11 and 9
    for kind, main_name, line, launches in (
            ("layer_norm", "bert_base", 68, fused["b4_launches"]),
            ("rms_norm", "llama2_7b prefill", 88, llama["b5_launches"])):
        mine = [c for c in norm_cases if c["kind"] == kind]
        m = next(c for c in mine if c["case"] == main_name
                 and c["dtype"] == "bf16" and c["affine"])
        kernels.append(dict(
            name=kind, route="cuda", source=src + "norms.cu",
            replaces=f"paddle_tpu/kernels/pallas/norms.py:{line}",
            launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            cases=mine))
    # the update at gpt2_small's shapes, AdamW in f32 (phase 6's case);
    # launches from phase 6
    u = updates[0]
    kernels.append(dict(
        name="multi_tensor_adam", route="cuda",
        source=src + "multi_tensor_adam.cu",
        replaces="paddle_tpu/optimizer/optimizer.py:317",
        launches=train["update_launches"],
        launches_on_device=train["update_launches_on_device"],
        launches_1p3b=t13["launches_counted"][2],
        launches_on_device_1p3b=t13["launches_on_device"][2],
        max_abs_err=max(c["max_abs_err"] for c in updates),
        ms=u["ms"], ms_graph=u["ms_graph"], plain_ms=u["plain_ms"],
        bound_ms=u["bound_ms"], bound_by=u["bound_by"],
        library_ms=u["library_ms"], cases=updates))
    log("[engine] " + json.dumps(engine))
    log("[parity] " + json.dumps(parity))
    log("[train] " + json.dumps(train))
    log("[train-parity] " + json.dumps(train_parity))
    log("[llama] " + json.dumps(llama))
    log("[llama-parity] " + json.dumps(llama_parity))
    log("[fused] " + json.dumps(fused))
    log("[train-1p3b] " + json.dumps(train_1p3b))
    log("[recompute-parity] " + json.dumps(recompute_parity))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
