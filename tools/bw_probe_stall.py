#!/usr/bin/env python3
"""The block-config cache's bandwidth probe under host stalls, on one
NVIDIA GPU.

    python3 tools/bw_probe_stall.py [--probes N] [--spinners K]
        [--out PATH]

Run from the root of a checkout. It takes `--probes` readings (200 by
default) of two probes in turn, in three conditions: a quiet process;
`--spinners` Python threads (2 by default) spinning on the GIL, as
threads left running by a server, a router or a thread pool do; and
two busy-looping processes for each CPU core, so that the host's
scheduler takes the core from the probe now and then. The probes
are:

  - `unguarded`: two warm-up passes, then CUDA events around the timed
    passes, with nothing holding the stream while they are queued (the
    probe as it was before the spacer);
  - `guarded`: `paddle_tpu_torch.kernels.autotune.measure_effective_bw`,
    whose spin kernel holds the stream until the timed span is queued.

For each it prints the readings' min, median and max in bytes/s and how
many fall outside the card's validated window
(`observability.perf.VALIDATED_BW_WINDOW`), which a sweep needs its
probes inside. The record goes to --out
(chiprun_out/bw_probe_stall.json by default), with the card's name and
power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def unguarded(nbytes=1 << 26, iters=4):
    import torch
    x = torch.zeros(nbytes // 4, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    for _ in range(2):
        torch.add(x, 1.0, out=y)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        torch.add(x, 1.0, out=y)
    end.record()
    end.synchronize()
    return 2.0 * nbytes / (start.elapsed_time(end) / 1e3 / iters)


def summary(readings, window):
    lo, hi = window
    good = [r for r in readings if r is not None]
    return dict(n=len(readings), none=len(readings) - len(good),
                min=min(good), median=statistics.median(good),
                max=max(good),
                outside_window=sum(not lo <= r <= hi for r in good))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", type=int, default=200)
    ap.add_argument("--spinners", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/bw_probe_stall.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from paddle_tpu_torch.kernels import autotune
    window = autotune._validated_bw_window()
    probes = {"unguarded": unguarded,
              "guarded": autotune.measure_effective_bw}
    rec = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "window": window,
        "probes": args.probes, "spinners": args.spinners}
    for cond in ("quiet", "spinning", "loaded"):
        stop = threading.Event()
        threads, procs = [], []
        if cond == "loaded":
            procs = [subprocess.Popen([sys.executable, "-c",
                                       "while True: pass"])
                     for _ in range(2 * os.cpu_count())]
        if cond == "spinning":
            def spin():
                n = 0
                while not stop.is_set():
                    n += 1
            threads = [threading.Thread(target=spin, daemon=True)
                       for _ in range(args.spinners)]
            for t in threads:
                t.start()
        readings = {name: [] for name in probes}
        try:
            for _ in range(args.probes):
                for name, fn in probes.items():
                    readings[name].append(fn())
        finally:
            stop.set()
            for t in threads:
                t.join()
            for p in procs:
                p.kill()
                p.wait()
        for name, got in readings.items():
            rec[f"{cond}_{name}"] = summary(got, window)
            print(f"{cond:8s} {name:9s} {rec[f'{cond}_{name}']}")
    print(rec["card"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
