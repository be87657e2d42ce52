#!/usr/bin/env python3
"""Host cost of the eager paths in two checkouts, in turns, on one card.

    python3 tools/torch_host_turns.py ROOT_A ROOT_B [--rounds 2]
        [--out host_turns.json]

Each ROOT is the root of a checkout of this repository (say the parent
commit unpacked under archive/ and "."). For every round it runs, in a
fresh process from each root in turn (A, B, B, A, ...), phase 22's
host timers of chip_smoke.py: the µs of one dispatched op against the
bare torch call (``_dispatch_overhead``), of a no-op ``Layer.__call__``
against its forward (``_layer_call_overhead``), and of one call of B1's
dispatcher (``kernels.flash_attention.flash_fwd``, the sm90 kernel on
bf16 [1, 128, 1, 64] tensors: the wrapper's host path and the launch,
mean of many calls, synchronised at the end). Each process builds B1
from its own root first. The card's name and power limit lead the
output; the JSON record goes to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.kernels import flash_attention as fa
fa._load_sm90()
q = torch.randn(1, 128, 1, 64, device="cuda", dtype=torch.bfloat16)
n = 5000
for _ in range(200):
    fa.flash_fwd(q, q, q)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(n):
    fa.flash_fwd(q, q, q)
torch.cuda.synchronize()
b1 = 1e6 * (time.perf_counter() - t) / n
print(json.dumps(dict(dispatch=cs._dispatch_overhead(P),
                      layer_call=cs._layer_call_overhead(P),
                      b1_call_us=b1)))
"""


def _run(root):
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    a, b = (os.path.abspath(r) for r in args.roots)
    order = []
    for i in range(args.rounds):
        order += [a, b] if i % 2 == 0 else [b, a]
    runs = []
    for root in order:
        rec = dict(root=root, **_run(root))
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == root]
        summary[root] = dict(
            dispatched_us=[r["dispatch"]["dispatched"] for r in mine],
            torch_us=[r["dispatch"]["torch"] for r in mine],
            layer_call_us=[r["layer_call"]["call"] for r in mine],
            b1_call_us=[r["b1_call_us"] for r in mine])
    print(json.dumps(dict(card=card, summary=summary)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs, summary=summary), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
