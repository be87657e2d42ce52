#!/usr/bin/env python3
"""Where a serving decode step spends the card's time.

    python3 tools/decode_profile.py [--model llama2_7b|gpt3_1p3b] [--chunks 2]

Run from the root of a checkout, on a machine with one NVIDIA GPU. It
builds chip_smoke.py's serving engine (bf16, all layers, random weights
from seed 0; max_batch 8, 64-slot pages, 16-token chunks), admits 8
requests of a 512-token prefix and 8-32 more tokens (one packed wave),
and runs `--chunks` decode chunks with the engine's decode step taken
eagerly (`_eager_decode`: the kernels its graph replays, launched one
by one) under torch.profiler, each part of the step inside a profiler
range. It prints the device time of a step by part (the qkv
projection, rotary, the decode attention, the output projection, the
MLP, the final norm, the logits, sampling, and the rest: embedding,
positions, pool writes), by kind of kernel (cuBLAS matrix products, the
rest), the 20 kernels that take the most device time, and the
weight-read floor beside them. The card's
name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

PARTS = ("qkv", "rotate", "attention", "attn_out", "mlp", "final",
         "logits", "pick")


def _is_gemm(name: str) -> bool:
    n = name.lower()
    return any(w in n for w in ("gemm", "cutlass", "sm90_xmma", "nvjet",
                                "cublas", "matmul", "gemv"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2_7b",
                    choices=("llama2_7b", "gpt3_1p3b"))
    ap.add_argument("--chunks", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import HBM_BYTES_PER_S
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference import llm_engine as eng_mod
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_1p3b, llama2_7b)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.model == "llama2_7b":
        cfg = llama2_7b()
        model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=0)
        max_len = 1024
    else:
        cfg = gpt3_1p3b()
        model = GPTForCausalLM(cfg, dtype="bfloat16", seed=0)
        max_len = 2048
    eng = LLMEngine(model, max_batch=8, block_size=64, decode_chunk=16,
                    prompt_quantum=128, max_model_len=max_len)
    eng._eager_decode = True
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (512,))
    for i, t in enumerate(rng.integers(8, 33, 8)):
        eng.add_request(i, np.concatenate(
            [prefix, rng.integers(0, cfg.vocab_size, (int(t),))]),
            max_new_tokens=16 * (args.chunks + 2))
    eng.step()                      # the packed wave and a first chunk
    torch.cuda.synchronize()

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(f"decode.{name}"):
                return fn(*a, **kw)
        return run

    fam = eng.fam
    saved = {n: getattr(fam, n) for n in ("qkv", "rotate", "attn_out",
                                          "mlp", "final", "logits")}
    for n, fn in saved.items():
        setattr(fam, n, ranged(n, fn))
    patches = [(eng_mod, "_pool_decode_attention", "attention"),
               (eng_mod, "_pick_token", "pick")]
    olds = [getattr(m, a) for m, a, _n in patches]
    for (m, a, n), fn in zip(patches, olds):
        setattr(m, a, ranged(n, fn))
    steps = 16 * args.chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.chunks):
            eng.step()
        torch.cuda.synchronize()
    for n, fn in saved.items():
        setattr(fam, n, fn)
    for (m, a, _n), fn in zip(patches, olds):
        setattr(m, a, fn)

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the step's profiler ranges appear on the device timeline as spans
    # named after them; everything else there is a kernel (or a copy)
    spans = {n: [] for n in PARTS}
    for e in dev:
        if e.name.startswith("decode."):
            spans[e.name[len("decode."):]].append(
                (e.time_range.start, e.time_range.end))
    kernels = [e for e in dev if not e.name.startswith("decode.")]
    if not kernels:
        print("decode_profile: the trace holds no device events",
              file=sys.stderr)
        return 1

    def part_of(e):
        t = e.time_range.start
        for part, ivs in spans.items():
            if any(lo <= t <= hi for lo, hi in ivs):
                return part
        return "unranged"

    by_name, calls, by_part = {}, {}, {}
    gemm = 0.0
    for e in kernels:
        us = e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        calls[e.name] = calls.get(e.name, 0) + 1
        by_part[part_of(e)] = by_part.get(part_of(e), 0.0) + us
        gemm += us if _is_gemm(e.name) else 0.0
    total = sum(by_name.values()) / 1e3 / steps
    gemm = gemm / 1e3 / steps
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in torch.nn.Module.parameters(model))
    print(f"{args.model} bf16 {cfg.num_layers} layers, 8 rows: {steps} "
          f"eager decode steps profiled; kernels {total:.3f} ms a step, "
          f"{len(kernels) / steps:.0f} launches a step (weight read floor "
          f"{1e3 * weight_bytes / HBM_BYTES_PER_S:.3f} ms); cuBLAS matrix "
          f"products {gemm:.3f} ms, the rest {total - gemm:.3f} ms")
    for n in PARTS + ("unranged",):
        ms = by_part.get(n, 0.0) / 1e3 / steps
        print(f"  {n:10s} {ms:8.3f} ms a step ({100 * ms / total:5.1f} %)"
              + ("  (embedding, positions, pool writes)"
                 if n == "unranged" else ""))
    print("top kernels (ms a step, calls a step):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / 1e3 / steps:8.3f} {calls[name] / steps:6.1f}  "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
