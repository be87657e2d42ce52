#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which must pass:

  1. the card (nvidia-smi name and power limit); build the CUDA kernel
     (nvcc, sm_90a) and the block allocator (g++) from the checkout's
     sources, timed;
  2. every kernel of the serving path against its plain PyTorch version
     on the card, at the engine's shapes, timed with CUDA events beside
     the roofline bound of the same work;
  3. gpt3_1p3b (bf16, all 24 layers, random weights from seed 0) served
     by LLMEngine: 16 requests sharing a 512-token prefix, 64 new tokens
     each; the kernel launch counters are read around this run;
  4. the engine against the port's dense `generate` in f32 (TF32 off)
     on a 2-layer model at gpt3_1p3b's widths.

The last two lines of standard output are a JSON record of the kernels
and the final {"ok": true, "device": ...} line. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

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

# kernel vs plain tolerance (absolute, on f32 outputs of order 1): the
# plain version runs in f32 on the same bf16 values the kernel reads,
# and the kernel also computes in f32, so the two differ only in
# summation order (~1e-6). 1e-3 still catches a single key wrongly
# masked in or out of a ~500-key row (an error of order 1e-3..1e-2).
KERNEL_ATOL = 1e-3


def log(*a):
    print(*a, flush=True)


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
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    jobs = {"ragged_paged_attention.cu (nvcc)": rpa._load_kernel,
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


def kernel_phase() -> list:
    import torch
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    rng = np.random.default_rng(0)
    prefix_tails = [(512, int(m)) for m in rng.integers(8, 33, 8)]
    specs = [
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
    ]
    out = []
    for name, kw in specs:
        x, meta = _case(name, rng, **kw)
        wp = meta["with_pool"]
        common = dict(block_size=meta["bs"], scale=1.0 / np.sqrt(meta["D"]),
                      kdq=x["kdq"], vdq=x["vdq"], with_pool=wp)
        args = [x[k] for k in ("q", "k_new", "v_new", "kpool", "vpool",
                               "rows", "pos", "kv_start", "off")]

        def kern():
            return rpa.ragged_paged_attention(*args, path="cuda", **common)

        def plain():
            return rpa.ragged_paged_attention(*args, path="torch", **common)

        got = kern()
        torch.cuda.synchronize()
        f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
        want = rpa.ragged_paged_attention(*f32, path="torch", **common)
        err = float((got - want).abs().max())
        dead = torch.from_numpy(meta["rows"] < 0).to(got.device)
        if not torch.isfinite(got).all() or err > KERNEL_ATOL or \
                (dead.any() and got[dead].abs().max() != 0):
            raise RuntimeError(
                f"kernel case {name!r}: max abs err {err} > {KERNEL_ATOL} "
                "or non-finite / non-zero dead rows")
        ms = cuda_ms(kern)
        prep_ms = cuda_ms(lambda: rpa._prep_operands(
            x["rows"], x["pos"], x["kv_start"], x["off"], meta["bs"], wp))
        plain_ms = cuda_ms(plain, iters=10)
        bound_ms, bound_by, nbytes, flops = _bound(
            meta, x["kpool"].element_size())
        rec = dict(case=name, T=meta["T"], T_live=meta["T_live"],
                   H=meta["H"], Hk=meta["Hk"], with_pool=wp,
                   max_abs_err=err, ms=ms, prep_ms=prep_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops)
        log(f"[kernel] {name}: T={meta['T']} (live {meta['T_live']}) "
            f"H={meta['H']} Hk={meta['Hk']} max_abs_err={err:.3e} "
            f"kernel_ms={ms:.4f} (prep {prep_ms:.4f}) plain_ms="
            f"{plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
        out.append(rec)
        del x, args, got, want, f32
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: gpt3_1p3b served at full width and depth
# ---------------------------------------------------------------------------
def engine_phase() -> dict:
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, dtype="bfloat16", seed=0)
    eng = LLMEngine(model, max_batch=8, block_size=64, decode_chunk=16,
                    prompt_quantum=128)
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
    waves, chunks, events = [], [], []
    run_ragged = eng._run_ragged
    decode_chunk = eng._decode_chunk
    attn = eng_mod.ragged_paged_attention

    def timed_wave(entries):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run_ragged(entries)
        waves.append(time.perf_counter() - t)
        return r

    def timed_chunk(cur, lens, tbl, flat):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = decode_chunk(cur, lens, tbl, flat)      # ends in a host copy
        chunks.append((time.perf_counter() - t, flat.shape[0]))
        return r

    def timed_attn(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        o = attn(*a, **kw)
        e.record()
        events.append((s, e))
        return o

    eng._run_ragged = timed_wave
    eng._decode_chunk = timed_chunk
    eng_mod.ragged_paged_attention = timed_attn
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=n_new)
        done, step_s = {}, []
        rpa.ragged_paged_attention.kernel_launches = 0
        rpa.ragged_paged_attention.plain_calls = 0
        t_run = time.perf_counter()
        while eng.has_unfinished:
            t = time.perf_counter()
            for r in eng.step():
                done[r.request_id] = r
            step_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = rpa.ragged_paged_attention.kernel_launches
        plain_calls = rpa.ragged_paged_attention.plain_calls
    finally:
        eng_mod.ragged_paged_attention = attn
    attn_ms = sum(s.elapsed_time(e) for s, e in events)

    bad = [i for i in range(len(prompts))
           if i not in done or done[i].finish_reason != "length"
           or len(done[i].output_ids) != n_new
           or not ((done[i].output_ids >= 0)
                   & (done[i].output_ids < cfg.vocab_size)).all()]
    st = eng.stats
    checks = {
        "every request returned 64 in-vocab tokens": not bad,
        "prefix cache hit (with_pool wave ran)":
            st["prefix_cache_hit_tokens"] > 0,
        "kernel launched": launches > 0,
        "plain version never ran on CUDA tensors": plain_calls == 0,
    }
    for what, ok in checks.items():
        log(f"[engine] check: {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise RuntimeError(f"engine phase failed: bad={bad} stats={st}")
    n_tok = sum(len(r.output_ids) for r in done.values())
    decode_steps = sum(n for _s, n in chunks)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rec = dict(tokens=n_tok, run_s=run_s, tokens_per_s=n_tok / run_s,
               steps=len(step_s), step_ms_mean=1e3 * run_s / len(step_s),
               step_ms_median=1e3 * statistics.median(step_s),
               step_ms_max=1e3 * max(step_s),
               ragged_waves_ms=[1e3 * w for w in waves],
               ragged_attention_ms=attn_ms,
               decode_chunks_ms=[1e3 * s for s, _n in chunks],
               decode_steps=decode_steps,
               decode_ms_per_step=1e3 * sum(s for s, _n in chunks)
               / decode_steps,
               # a floor for one batch decode step: every weight read once
               weight_read_ms=1e3 * weight_bytes / HBM_BYTES_PER_S,
               kernel_launches=launches,
               plain_calls=plain_calls, setup_s=setup_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               stats={k: st[k] for k in (
                   "prefills", "preemptions", "decode_chunks",
                   "decode_tokens", "prefix_cache_hit_tokens",
                   "prefix_cache_miss_tokens", "ragged_launches")})
    log(f"[engine] gpt3_1p3b bf16 {cfg.num_layers} layers: {n_tok} tokens "
        f"in {run_s:.3f} s = {rec['tokens_per_s']:.1f} tokens/s; "
        f"{len(step_s)} steps, step wall ms mean "
        f"{rec['step_ms_mean']:.2f} median {rec['step_ms_median']:.2f} "
        f"max {rec['step_ms_max']:.2f}; ragged waves ms "
        f"{[round(w, 2) for w in rec['ragged_waves_ms']]}, attention "
        f"kernel time within them {attn_ms:.2f} ms over {launches} "
        f"launches; decode {decode_steps} steps at "
        f"{rec['decode_ms_per_step']:.2f} ms each (weight read floor "
        f"{rec['weight_read_ms']:.3f} ms); "
        f"peak mem {rec['peak_mem_gb']:.2f} GiB; "
        f"stats {rec['stats']}")
    del eng, model
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4: engine == dense generate (f32, TF32 off)
# ---------------------------------------------------------------------------
def parity_phase() -> dict:
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
    model = GPTForCausalLM(cfg, dtype="float32", seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(190, 211, 4)]
    n_new, margin = 16, 1e-3
    eng = LLMEngine(model, max_batch=4, block_size=64, decode_chunk=16,
                    prompt_quantum=128)
    res = eng.generate(prompts, max_new_tokens=n_new)
    guarded, mismatched = [], []
    with torch.no_grad():
        for i, (p, r) in enumerate(zip(prompts, res)):
            dense = generate(model, p[None], max_new_tokens=n_new)
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
    log(f"[parity] engine vs dense generate (f32, 2 layers): tokens "
        f"compared per request {guarded} of {n_new} (margin guard "
        f"{margin}); mismatched requests {mismatched}")
    if mismatched or min(guarded) == 0:
        raise RuntimeError("engine tokens differ from dense generate")
    return dict(guarded=guarded, n_new=n_new)


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
    engine = engine_phase()
    parity = parity_phase()
    main_case = cases[0]    # the engine's fresh wave: its largest launch
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/kernels/pallas/ragged_paged_attention.py:313",
        launches=engine["kernel_launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=None, cases=cases)]
    log("[engine] " + json.dumps(engine))
    log("[parity] " + json.dumps(parity))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
