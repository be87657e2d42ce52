#!/usr/bin/env python3
"""Where a paddle_tpu_torch training step spends the card's time.

    python3 tools/torch_train_profile.py [--steps 2]

Run from the root of a checkout, on a machine with one NVIDIA GPU. It
builds chip_smoke.py's training step (gpt2_small, bf16 O1, AdamW, flash
attention, batch 16 x seq 1024, random weights and batch from seed 0),
runs 3 warm-up steps, then traces `--steps` steps with torch.profiler
and prints: the wall time of the traced steps, the summed device time of
every kernel (and so the device's idle share), that kernel time split
into TrainStep's forward, backward and update (with the span each of the
forward and the update covers on the device timeline), the kernel time
split by kind (the flash-attention kernels, cuBLAS matrix products, the
rest), and the 25 kernels that take the most device time.
The card's name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np


def _part(name: str) -> str:
    """The step's part a CUDA kernel belongs to, from its name."""
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "B1 flash forward"
    if "flash_bwd" in n:
        return "B2 flash backward"
    if any(w in n for w in ("gemm", "cutlass", "sm90_xmma", "nvjet",
                            "cublas", "matmul")):
        return "matrix products (cuBLAS)"
    return "elementwise, reductions, copies"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _gpt2_train_step
    from paddle_tpu_torch.models import gpt2_small
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     use_flash_attention=True)
    model, step = _gpt2_train_step(cfg, use_amp=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (16, 1024)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (16, 1024)).astype(np.int32)
    for _ in range(3):
        step(ids, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(ids, labels)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the step's profiler ranges appear on the device timeline as spans
    # named after them; everything else there is a kernel (or a copy)
    spans = {"forward": [], "update": []}
    for e in dev:
        for part, key in (("forward", "TrainStep.forward"),
                          ("update", "TrainStep.update")):
            if e.name == key:
                spans[part].append((e.time_range.start, e.time_range.end))
    kernels = [e for e in dev if not e.name.startswith("TrainStep.")]
    if not kernels:
        print("torch_train_profile: the trace holds no device events",
              file=sys.stderr)
        return 1

    def part_of(e):
        t = e.time_range.start
        for part, ivs in spans.items():
            if any(a <= t <= b for a, b in ivs):
                return part
        return "backward"     # launched by autograd's own thread

    by_name, calls, by_kind, by_part = {}, {}, {}, {}
    for e in kernels:
        us = e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        calls[e.name] = calls.get(e.name, 0) + 1
        kind = _part(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        part = part_of(e)
        by_part[part] = by_part.get(part, 0.0) + us
    n = args.steps
    busy_ms = sum(by_name.values()) / 1e3
    print(f"{cfg.num_layers} layers, batch 16 x seq 1024, {n} traced "
          f"steps: wall {wall_ms / n:.2f} ms/step (under the profiler), "
          f"kernels {busy_ms / n:.2f} ms/step, device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %")
    for part in ("forward", "backward", "update"):
        span = sum(b - a for a, b in spans.get(part, ())) / 1e3
        extra = f", span {span / n:.2f} ms/step" if span else ""
        print(f"  {part:34s} kernels {by_part.get(part, 0.0) / 1e3 / n:8.2f}"
              f" ms/step{extra}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:34s} {us / 1e3 / n:8.2f} ms/step "
              f"({100 * us / 1e3 / busy_ms:5.1f} % of kernel time)")
    print("top kernels (ms per step, calls per step):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3 / n:8.3f}  {calls[name] / n:6.0f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
