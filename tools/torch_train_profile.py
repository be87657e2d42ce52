#!/usr/bin/env python3
"""Where a paddle_tpu_torch training step spends the card's time.

    python3 tools/torch_train_profile.py [--steps 2] [--config resnet50]
    python3 tools/torch_train_profile.py --config mobilenet_v2

Run from the root of a checkout, on a machine with one NVIDIA GPU. It
builds one of chip_smoke.py's training steps, random weights and batch
from seed 0: `gpt2_small` (phase 6: bf16 O1, AdamW, flash attention,
batch 16 x seq 1024; the default), `gpt_1p3b` (phase 13,
bench.py::bench_gpt_1p3b's config: gpt3_1p3b, batch 4 x seq 2048, AdamW
with bf16 moments, every third block recomputed), `llama13b` (phase 17:
LLaMA-2-13B's widths at 4 layers, batch 2 x seq 4096, no recompute) or
`bert_base` (phase 18, bench.py::bench_bert_base's config: batch 32 x
seq 512, MLM labels at ~15 % of the positions) or `resnet50` (phase
19, bench.py::bench_resnet50's config: NHWC with the space-to-depth
stem, batch 256 x 224^2, bf16 O1, Momentum, FLAGS_fast_bn_stats on)
or `mobilenet_v2` (phase 29: scale 1.0, NCHW, the same recipe and
batch), and traces with torch.profiler, separately:

  * the eager step: TrainStep's first call, which runs the step eagerly
    and then captures it as a CUDA graph (the capture runs nothing on
    the card). Its kernel time is split into TrainStep's forward,
    backward, the recomputed blocks' forwards inside the backward
    (recompute's "recompute" range) and update, with the span each of
    the forward, the recomputations and the update covers on the device
    timeline;
  * `--steps` replays of the graph, after 2 untraced ones. A replay is
    one graph launch to the host, so its kernels carry no TrainStep
    range and are not split by part.

For each it prints the wall time under the profiler, the summed device
time of every kernel (and so the device's idle share), that kernel time
split by kind (the flash-attention kernels, the multi-tensor update,
PyTorch's depthwise-convolution kernels, cuDNN's implicit-GEMM
convolutions, the GEMM kernels of cuBLAS's
products and of the 1x1 convolutions cuDNN runs as GEMMs, and the rest
split into reductions, casts and copies, ReLU and clamps, pools and
elementwise arithmetic) and the 25 kernels that take the most device
time. The eager step's kernel time is also split by the op that
launched each kernel (torch.profiler's op of the launch and the ops
around it): the update, the norms, attention, the convolutions, the
pools, activations, casts and copies, the loss, the matrix products,
adds (the residual adds and autograd's gradient sums), the rest, and
the kernels launched outside any op.
Without the profiler it also times 10 replayed steps by
wall (synchronised after each), and one replay of the step's graph
alone by CUDA events: the step's device time with no host in it, so
1 - replay / wall is the device's idle share in a step.
The card's name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np


def _part(name: str) -> str:
    """The kind of work a CUDA kernel does, from its name."""
    n = name.lower()
    if "flash_fwd" in n:
        return "B1 flash forward"
    if "flash_bwd" in n:
        return "B2 flash backward"
    if "mta_" in n:
        return "multi-tensor update"
    if "depthwise" in n:
        return "depthwise convolutions"
    if "convert" not in n and any(
            w in n for w in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                             "winograd", "cudnn")):
        return "convolutions (cuDNN)"
    if any(w in n for w in ("gemm", "cutlass", "sm90_xmma", "nvjet",
                            "cublas", "matmul")):
        return "GEMMs (cuBLAS, 1x1 convolutions)"
    for kind, words in (("reductions", ("reduce",)),
                        ("casts and copies", ("copy",)),
                        ("ReLU and clamps", ("clamp", "threshold")),
                        ("pools", ("pool",))):
        if any(w in n for w in words):
            return kind
    return "elementwise arithmetic"


# the op categories of a step, in the order they are tried on the names
# of a kernel's launching op and the ops around it
_OPS = (("update", ("trainstep.update",)),
        ("batch norm", ("_batchnormtrain", "batch_norm")),
        ("layer and RMS norms", ("layer_norm", "rms_norm")),
        ("attention", ("flash", "attention")),
        ("convolutions", ("convolution",)),
        ("pools", ("pool",)),
        ("activations", ("relu", "threshold", "clamp", "gelu", "silu",
                         "tanh")),
        ("casts and copies", ("_to_copy", "tocopy", "aten::copy_",
                              "aten::clone")),
        ("loss", ("cross_entropy", "logsumexp", "gather", "log_softmax")),
        ("matrix products", ("addmm", "aten::mm", "aten::bmm", "matmul",
                             "linear")),
        ("adds", ("add",)))


# CUDA driver and profiler events that can carry an op's correlation id
_NOT_OPS = ("Lazy Function Loading", "Runtime Triggered Module Loading",
            "Activity Buffer Request")


def _by_op(torch, prof, n, total_us):
    """Print the kernel time of a trace by the op that launched each
    kernel, found among the names of the launching op and its parents.
    torch.profiler lists a kernel under every CPU event whose id is its
    launch's correlation id, and CUDA runtime and driver events can carry
    an op's id, so each id is counted once, at its op. Kernels launched
    outside any op (`total_us` less the rest) are listed as such."""
    events = [fe for fe in prof.events()
              if fe.device_type == torch.autograd.DeviceType.CPU
              and fe.kernels]
    events.sort(key=lambda fe: fe.name.startswith("cuda")
                or fe.name in _NOT_OPS)
    out, seen = {}, set()
    for fe in events:
        if fe.id in seen:
            continue
        seen.add(fe.id)
        names, e = [], fe
        while e is not None:
            names.append(e.name.lower())
            e = e.cpu_parent
        cat = next((c for c, words in _OPS
                    if any(w in nm for nm in names for w in words)),
                   "other")
        out[cat] = out.get(cat, 0.0) + sum(k.duration for k in fe.kernels)
    outside = total_us - sum(out.values())
    if outside > 0:
        out["launched outside any op"] = outside
    print("  by the op that launched each kernel:")
    for cat, us in sorted(out.items(), key=lambda kv: -kv[1]):
        print(f"    {cat:32s} {us / 1e3 / n:8.2f} ms/step "
              f"({100 * us / total_us:5.1f} %)")


def _report(torch, prof, n, wall_ms, label, split):
    """Print one trace's kernel time: by part (`split`: the eager step's
    TrainStep ranges, and by op), by kind, and the top kernels."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the step's profiler ranges appear on the device timeline as spans
    # named after them; everything else there is a kernel (or a copy)
    ranges = {"TrainStep.forward": "forward", "TrainStep.update": "update",
              "recompute": "recompute"}
    spans = {part: [] for part in ranges.values()}
    for e in dev:
        if e.name in ranges:
            spans[ranges[e.name]].append((e.time_range.start,
                                          e.time_range.end))
    kernels = [e for e in dev if e.name not in ranges]
    if not kernels:
        raise RuntimeError(f"the trace of the {label} holds no device "
                           "events")

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
    busy_ms = sum(by_name.values()) / 1e3
    print(f"{label}, {n} traced: wall {wall_ms / n:.2f} ms/step (under the "
          f"profiler), kernels {busy_ms / n:.2f} ms/step over "
          f"{len(kernels) / n:.0f} launches, device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %")
    if split:
        for part in ("forward", "backward", "recompute", "update"):
            span = sum(b - a for a, b in spans.get(part, ())) / 1e3
            extra = f", span {span / n:.2f} ms/step" if span else ""
            print(f"  {part:34s} kernels "
                  f"{by_part.get(part, 0.0) / 1e3 / n:8.2f} ms/step{extra}")
        _by_op(torch, prof, n, 1e3 * busy_ms)
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:34s} {us / 1e3 / n:8.2f} ms/step "
              f"({100 * us / 1e3 / busy_ms:5.1f} % of kernel time)")
    print("top kernels (ms per step, calls per step):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3 / n:8.3f}  {calls[name] / n:6.0f}  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--config", choices=("gpt2_small", "gpt_1p3b",
                                         "llama13b", "bert_base",
                                         "resnet50", "mobilenet_v2"),
                    default="gpt2_small")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import (B1P3_BATCH, B1P3_INTERVAL, B1P3_SEQ,
                            BERT_BATCH, BERT_SEQ, LLAMA13_BATCH,
                            LLAMA13_LAYERS, LLAMA13_SEQ, RESNET_BATCH,
                            RESNET_HW, _bert_train_step, _gpt_train_step,
                            _llama_train_step, _mobilenet_step, _replay_ms,
                            _resnet_train_step)
    from paddle_tpu_torch.models import (bert_base, gpt2_small, gpt3_1p3b,
                                         llama2_13b)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    common = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                  use_flash_attention=True)
    rng = np.random.default_rng(0)
    if args.config == "resnet50":
        from paddle_tpu_torch import set_flags
        set_flags({"FLAGS_fast_bn_stats": True})
        batch, hw = RESNET_BATCH, RESNET_HW
        model, step = _resnet_train_step()
        what = f"resnet50, batch {batch} x {hw}^2"
        arrays = [rng.standard_normal((batch, hw, hw, 3), dtype=np.float32),
                  rng.integers(0, 1000, (batch,))]
    elif args.config == "mobilenet_v2":
        from paddle_tpu_torch import set_flags
        set_flags({"FLAGS_fast_bn_stats": True})
        batch, hw = RESNET_BATCH, RESNET_HW
        model, step = _mobilenet_step()
        what = f"mobilenet_v2, batch {batch} x {hw}^2"
        arrays = [rng.standard_normal((batch, 3, hw, hw), dtype=np.float32),
                  rng.integers(0, 1000, (batch,))]
    elif args.config == "llama13b":
        cfg = dataclasses.replace(llama2_13b(use_flash_attention=True),
                                  num_layers=LLAMA13_LAYERS)
        batch, seq = LLAMA13_BATCH, LLAMA13_SEQ
        model, step = _llama_train_step(cfg)
        arrays = [rng.integers(0, cfg.vocab_size, (batch, seq))]
    elif args.config == "bert_base":
        cfg = bert_base(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        batch, seq = BERT_BATCH, BERT_SEQ
        model, step = _bert_train_step(cfg)
        ids = rng.integers(0, cfg.vocab_size, (batch, seq))
        arrays = [ids, np.where(rng.random((batch, seq)) < 0.15, ids, -100)]
    else:
        if args.config == "gpt_1p3b":
            cfg = gpt3_1p3b(recompute=True,
                            recompute_interval=B1P3_INTERVAL, **common)
            batch, seq, moments = B1P3_BATCH, B1P3_SEQ, "bfloat16"
        else:
            cfg = gpt2_small(**common)
            batch, seq, moments = 16, 1024, None
        model, step = _gpt_train_step(cfg, use_amp=True,
                                      moment_dtype=moments)
        arrays = [rng.integers(0, cfg.vocab_size, (batch, seq))
                  for _ in range(2)]
    # the batch on the card, so a step copies nothing from the host
    batch_t = [torch.from_numpy(a if a.dtype == np.float32
                                else a.astype(np.int32)).cuda()
               for a in arrays]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(*batch_t)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
    if args.config not in ("resnet50", "mobilenet_v2"):
        what = (f"{args.config}, {cfg.num_layers} layers, batch {batch} x "
                f"seq {seq}")
    _report(torch, prof, 1, first_ms,
            f"{what}: the eager step (the first call, then captured)",
            split=True)
    for _ in range(2):
        step(*batch_t)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(*batch_t)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_med = float(np.median(walls))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(*batch_t)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    _report(torch, prof, args.steps, wall_ms, "replays of the step graph",
            split=False)
    replay_ms = _replay_ms(next(iter(step._graphs.values()))[0].graph)
    print(f"without the profiler: wall {wall_med:.2f} ms/step (median of "
          f"10 replayed steps; {min(walls):.2f}-{max(walls):.2f}), one "
          f"step by CUDA-graph replay {replay_ms:.2f} ms, device idle "
          f"{100 * (1 - replay_ms / wall_med):.1f} %", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
