#!/usr/bin/env python3
"""Time LLMEngine and TrainStep with observability off, to compare two
checkouts: what the instrumentation costs while it is disabled.

    python3 tools/obs_overhead.py [--root DIR] [--rounds 3] [--train]
        [--out obs_overhead.json]

Run from the root of a checkout, on a machine with one NVIDIA GPU.
`--root DIR` imports paddle_tpu_torch from DIR instead (a checkout of
another commit: `git archive <commit> | tar -x -C DIR`), so a tree
from before the observability package runs too. Compare two commits
in one machine's call as parent, change, change, parent. (Off against
on within one tree is chip_smoke.py phase 33's.)

It serves chip_smoke.py phase 4's traffic (gpt3_1p3b in bf16, 24
layers, random weights from seed 0; 16 requests on a 512-token prefix,
64 new tokens each; max_batch 8, block 64, decode chunk 16) through a
fresh LLMEngine a round, after one warm-up run, and prints each round's
tokens/s and the median wall of its steady steps (a decode chunk alone:
no graph captured, no packed wave; a step reads its tokens back to the
host, so its wall covers its device time). With `--train` it also runs
phase 6's gpt2_small TrainStep (b16 s1024, bf16 O1, AdamW, flash
attention) for 12 calls a round through a fresh graph cache and prints
the median ms of the last 10. The card's name and power limit lead the
output; the JSON record goes to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _serve(model, prompts) -> dict:
    import torch
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.jit import cuda_graph
    eng = LLMEngine(model, max_batch=8, block_size=64, decode_chunk=16,
                    prompt_quantum=128)
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=64)
    steps, steady, n = [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_unfinished:
        caps = sum(cuda_graph.captures.values())
        waves = eng.stats["ragged_launches"]
        t = time.perf_counter()
        n += sum(len(r.output_ids) for r in eng.step())
        ms = 1e3 * (time.perf_counter() - t)
        steps.append(ms)
        if sum(cuda_graph.captures.values()) == caps \
                and eng.stats["ragged_launches"] == waves:
            steady.append(ms)
    secs = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return dict(tokens=n, seconds=secs, tokens_per_s=n / secs,
                steady_ms=statistics.median(steady), step_ms=steps)


def _train(step, batch, calls=12) -> dict:
    import torch
    from paddle_tpu_torch.jit.cuda_graph import GraphCache
    step._graphs = GraphCache()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return dict(step_ms_median=statistics.median(times[2:]),
                step_ms=times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("obs_overhead: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    card = _card()
    print(f"card {card}; package from {root}", flush=True)
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, dtype="bfloat16", seed=0)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (512,))
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (int(t),))]).astype(np.int32)
        for t in rng.integers(8, 33, 16)]
    _serve(model, prompts)                  # builds, first captures
    runs = []
    for r in range(a.rounds):
        rec = _serve(model, prompts)
        runs.append(rec)
        print(f"round {r}: {rec['tokens_per_s']:.1f} tokens/s, steady "
              f"step median {rec['steady_ms']:.3f} ms, steps ms "
              f"{[round(x, 2) for x in rec['step_ms']]}", flush=True)
    train = []
    if a.train:
        del model
        torch.cuda.empty_cache()
        from paddle_tpu_torch import TrainStep, amp
        from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                             gpt2_small)
        from paddle_tpu_torch.optimizer import AdamW
        tcfg = gpt2_small(hidden_dropout_prob=0.0,
                          attention_dropout_prob=0.0,
                          use_flash_attention=True)
        tm = GPTForCausalLM(tcfg, dtype="float32", seed=0)
        crit = GPTPretrainingCriterion()

        def loss_fn(m, ids, labels):
            with amp.auto_cast(level="O1"):
                logits = m(ids)
            return crit(logits, labels)

        step = TrainStep(tm, AdamW(learning_rate=1e-4,
                                   parameters=tm.parameters(),
                                   weight_decay=0.01), loss_fn)
        ids = rng.integers(0, tcfg.vocab_size, (16, 1024)).astype(np.int32)
        for r in range(a.rounds):
            rec = _train(step, (ids, ids))
            train.append(rec)
            print(f"round {r}: train step median "
                  f"{rec['step_ms_median']:.3f} ms", flush=True)
    out = dict(card=card, root=root, torch=torch.__version__, runs=runs,
               train=train,
               tokens_per_s=[x["tokens_per_s"] for x in runs],
               steady_ms=[x["steady_ms"] for x in runs],
               train_step_ms=[x["step_ms_median"] for x in train])
    print(json.dumps({k: out[k] for k in ("tokens_per_s", "steady_ms",
                                          "train_step_ms")}))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
