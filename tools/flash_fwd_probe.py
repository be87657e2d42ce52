#!/usr/bin/env python3
"""B1's sm90 design on its own, on one NVIDIA GPU: a short run for
working on paddle_tpu_torch/kernels/csrc/flash_fwd_sm90.cu.

    python3 tools/flash_fwd_probe.py [--cases a,b,h] [--simple]
        [--variant FA90_D64_STAGES=4,FA90_D128_BN=128 ...] [--out PATH]

Run from the root of a checkout. It builds only flash_fwd_sm90.cu
(flash_attention.cu too with --simple), prints what `nvcc -Xptxas -v`
says of each instantiation (registers, spills, stack), then takes the
bf16 cases of chip_smoke.py's phase 3 whose head_dim the design takes
(all of them, or those whose letters --cases names). For each it holds
B1's (o, lse) to the plain version with the phase's limits and planted
fault, and times B1 by single-call CUDA events and by CUDA-graph replay,
beside the bound, SDPA's forward and, with --simple, the simple kernel
(flash_attention.cu's flash_fwd_kernel). Every --variant rebuilds the
source with those -D tile-size macros, prints its
registers, and checks and times it on the same cases; a variant that
does not build is reported and skipped. The record goes to --out
(build/flash_fwd_probe.json by default). The inputs, checks and timers
are chip_smoke.py's own.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def ptxas_report(extra_flags=()) -> list:
    """[{entry, registers, stack, spill_stores, spill_loads, warnings}] of
    every kernel in flash_fwd_sm90.cu, from `nvcc -Xptxas -v` (an object
    file compiled into the build directory with the library's flags);
    raises with the compiler's last lines if the source does not build."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.utils.build import NVCC_FLAGS, build_dir, nvcc_path
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC")]
    out = build_dir() / "flash_fwd_sm90_ptxas.o"
    cmd = [nvcc_path(), *flags, *extra_flags, "-Xptxas", "-v", "-c", "-o",
           str(out), fa._csrc("flash_fwd_sm90.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            (proc.stdout + proc.stderr).splitlines()[-40:]))
    report, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        # e.g. ptxas's note that it serialised wgmma in some function
        if "warning" in line.lower() and cur is not None:
            cur.setdefault("warnings", []).append(line.strip()[-300:])
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the kernel and its tile config, e.g. flash_fwd_sm90_wgmma
            # <WCfg<64, 64, 3>>
            cfg = re.search(r"(flash_fwd_\w+?)I\w*?(W?Cfg)I((?:Li\d+E)+)",
                            m.group(1))
            cur = dict(entry="%s<%s<%s>>" % (
                cfg.group(1), cfg.group(2),
                ", ".join(re.findall(r"Li(\d+)E", cfg.group(3))))
                if cfg else m.group(1))
            report.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return report


def probe_case(i, name, spec, simple) -> dict:
    """Check and time B1's default design at phase 3's case i (bf16)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    qs, k, v, _do, segs = cs._flash_inputs(spec, torch.bfloat16, seed=i)
    n0 = fa.flash_fwd.design_launches["sm90"]
    o, lse = fa.flash_fwd(qs, k, v, spec[6], segs, path="cuda")
    torch.cuda.synchronize()
    if fa.flash_fwd.design_launches["sm90"] != n0 + 1:
        raise RuntimeError(f"{name}: the sm90 design did not launch")
    want = fa.flash_fwd(qs, k, v, spec[6], segs, path="torch")
    try:
        abs_errs, errs, planted = cs._check_flash(name, "bf16", (o, lse),
                                                  want)
    except RuntimeError as e:
        # where the kernel went wrong: (batch, row, head) of the rows off
        bad = ~torch.isfinite(o.float()).all(-1)
        if not bad.any():
            d = (o.float() - want[0].float()).abs().amax(-1)
            bad = d > 0.05 * (want[0].float().abs().amax(-1) + 1)
        at = bad.nonzero()[:8].tolist()
        cs.log(f"[probe] {name}: FAILED {e}; {int(bad.sum())} rows off, "
               f"first (b, row, head) {at}")
        return dict(case=name, error=str(e), rows_off=int(bad.sum()),
                    first_off=at)
    bound = cs._flash_bound(spec, cs._valid_pairs(spec, segs), 2, False)
    rec = dict(case=name, max_abs_err=abs_errs, norm_err=errs,
               planted_norm_err=planted, bound_ms=bound[0],
               bound_by=bound[1],
               **cs.b1_times(spec, qs, k, v, segs, simple=simple))
    del qs, k, v, o, lse, want
    torch.cuda.empty_cache()
    cs.log(f"[probe] {name}: norm err o {errs['o']:.2e} lse "
           f"{errs['lse']:.2e} (planted {planted[cs.PLANTED[0]]:.2e}); "
           f"sm90 {rec['fwd_ms']:.4f} ms by events, "
           f"{rec['fwd_ms_graph']:.4f} by graph replay; bound "
           f"{bound[0]:.4f} ({bound[1]}); simple {rec['simple_fwd_ms']} / "
           f"{rec['simple_fwd_ms_graph']}; library {rec['library_fwd_ms']} "
           f"/ {rec['library_fwd_ms_graph']}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="",
                    help="letters of phase 3's cases (default: every one "
                         "the sm90 design takes)")
    ap.add_argument("--simple", action="store_true",
                    help="also build and time the simple kernel")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE,... macros for one more build")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "flash_fwd_probe.json"),
                    help="where the JSON record goes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import flash_attention as fa
    cs.log(f"[card] {cs.card_line()}")
    want = set(args.cases.split(",")) - {""}
    cases = [(i, name, spec) for i, (name, spec) in enumerate(cs.FLASH_CASES)
             if spec[5] in fa._SM90_D and (not want or name[0] in want)]
    if args.simple:
        fa._load_kernel()
    out = dict(card=cs.card_line(), builds=[])
    for variant in [""] + args.variant:
        flags = tuple(f"-D{x}" for x in variant.split(",") if x)
        try:
            regs = ptxas_report(flags)
        except RuntimeError as e:
            # a variant that does not build is reported, not fatal
            cs.log(f"[ptxas] {variant or 'default'}: {e}")
            out["builds"].append(dict(variant=variant or "default",
                                      error=str(e), cases=[]))
            continue
        for r in regs:
            cs.log(f"[ptxas] {variant or 'default'}: {r}")
        saved = fa._SM90_LIB
        if flags:
            fa._SM90_LIB = fa._load_sm90(flags)
        try:
            recs = [probe_case(i, name, spec, args.simple and not flags)
                    for i, name, spec in cases]
        finally:
            fa._SM90_LIB = saved
        out["builds"].append(dict(variant=variant or "default", ptxas=regs,
                                  cases=recs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(json.dumps({"probe": [
        dict(variant=b["variant"], **{
            c["case"]: round(c["fwd_ms_graph"], 5) if "error" not in c
            else "FAILED" for c in b["cases"]})
        for b in out["builds"]]}))
    failed = [c["case"] for b in out["builds"] for c in b["cases"]
              if "error" in c] + [b["variant"] for b in out["builds"]
                                  if "error" in b]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
