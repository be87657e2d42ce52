#!/usr/bin/env python3
"""B1's, B2's or B3's sm90 design on its own, on one NVIDIA GPU: a short
run for working on paddle_tpu_torch/kernels/csrc/flash_fwd_sm90.cu or,
with --bwd, flash_bwd_sm90.cu or, with --ragged,
ragged_paged_attention_sm90.cu.

    python3 tools/flash_fwd_probe.py [--bwd | --ragged] [--cases a,b,h]
        [--simple] [--check] [--variant FA90_D64_STAGES=4,FA90_D128_BN=128 ...]
        [--rounds N] [--out PATH]

Run from the root of a checkout. It builds only the design's source
(flash_attention.cu too with --simple; B1's sm90 source too with --bwd,
for the forward that feeds B2), prints what `nvcc -Xptxas -v` says of
each instantiation (registers, spills, stack), then takes the bf16
cases of chip_smoke.py's phase 3 whose head_dim the design takes (all
of them, or those whose letters --cases names). For each it holds B1's
(o, lse), or B2's (dq, dk, dv) from the same (o, lse) on both sides, to
the plain version with the phase's limits and planted faults, and
times the kernel by single-call CUDA events and by CUDA-graph replay,
beside the bound, SDPA's forward (B2: SDPA's backward by replay) and,
with --simple, the simple kernel (flash_attention.cu). --check stops
after the checks, timing nothing. Every --variant rebuilds the source
with those -D tile-size macros (FA90_* for B1, FB90_* for B2), prints
its registers, and checks and times it on the same cases; a variant
that does not build is reported and skipped. --rounds N takes the
builds in turn N times over (A, B, A, B), so that they compare within
one call. The record goes to --out
(build/flash_fwd_probe.json by default). The inputs, checks and timers
are chip_smoke.py's own.

--ragged takes B3 (ragged paged attention) instead: every case of
chip_smoke.py's phase 2 (--cases does not apply), each held by
chip_smoke.ragged_case to the plain version in f32 (the sm90 design
within twice the reference's own bf16 rounding, the simple one within
KERNEL_ATOL, planted faults rejected) and timed by events and by graph
replay with the plan built outside, beside the simple kernel, the plan
alone and the SDPA yardstick. Its variants take RPA90_* ring-depth
macros.
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


def ptxas_report(source, extra_flags=()) -> list:
    """[{entry, registers, stack, spill_stores, spill_loads, warnings}] of
    every kernel in csrc/<source>.cu, from `nvcc -Xptxas -v` (an object
    file compiled into the build directory with the library's flags);
    raises with the compiler's last lines if the source does not build."""
    from paddle_tpu_torch.utils.build import (NVCC_FLAGS, build_dir,
                                              csrc_path, nvcc_path)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC")]
    out = build_dir() / f"{source}_ptxas.o"
    cmd = [nvcc_path(), *flags, *extra_flags, "-Xptxas", "-v", "-c", "-o",
           str(out), csrc_path(source + ".cu")]
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
            cur = dict(entry=_kernel_name(m.group(1)))
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


def _kernel_name(mangled) -> str:
    """The kernel and its tile config of a mangled entry, e.g.
    flash_fwd_sm90<Cfg<64, 64, 3, 2>> or flash_bwd_delta<bf16, 64>."""
    # the name follows its length; nvcc's anonymous namespace, which
    # names the file, comes before it
    cfg = re.search(r"\d((?:flash|rpa)_\w+?)I(?:NS_)?\d*([A-Za-z]*Cfg)I"
                    r"((?:Li\d+E)+)", mangled)
    if cfg:
        return "%s<%s<%s>>" % (cfg.group(1), cfg.group(2), ", ".join(
            re.findall(r"Li(\d+)E", cfg.group(3))))
    typed = re.search(r"\d(flash_\w+?)I(\d+__nv_bfloat16|f)Li(\d+)E",
                      mangled)
    if typed:
        return "%s<%s, %s>" % (typed.group(1), "f32" if typed.group(2) == "f"
                               else "bf16", typed.group(3))
    return mangled


def probe_case(i, name, spec, simple, check_only=False) -> dict:
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
               bound_by=bound[1])
    if check_only:
        cs.log(f"[probe] {name}: norm err {errs}")
        return rec
    rec.update(cs.b1_times(spec, qs, k, v, segs, simple=simple))
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


def kernel_split(fn, iters=10) -> dict:
    """{kernel: device ms a call of `fn`} by torch.profiler over `iters`
    calls (empty where the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us > 0:
            key = re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::",
                                                    ""))
            out[key[-90:]] = out.get(key[-90:], 0.0) + us / iters / 1e3
    return out


def probe_bwd_case(i, name, spec, simple, check_only=False) -> dict:
    """Check and time B2's default design at phase 3's case i (bf16),
    from B1's (o, lse) of the same inputs."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    qs, k, v, do, segs = cs._flash_inputs(spec, torch.bfloat16, seed=i)
    causal, sc = spec[6], spec[5] ** -0.5
    o, lse = fa.flash_fwd(qs, k, v, causal, segs, path="cuda")
    n0 = fa.flash_bwd.design_launches["sm90"]
    got = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs, path="cuda")
    torch.cuda.synchronize()
    if fa.flash_bwd.design_launches["sm90"] != n0 + 1:
        raise RuntimeError(f"{name}: the sm90 design did not launch")
    want = fa.flash_bwd(qs, k, v, o, lse, do, sc, causal, segs,
                        path="torch")
    try:
        abs_errs, errs, planted = cs._check_flash(
            name, "bf16", (o, lse, *got), (o, lse, *want))
    except RuntimeError as e:
        # where the kernel went wrong: (batch, row, head) of the rows off
        # in each of dq, dk, dv
        at = {}
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            d = (g.float() - w.float()).abs().amax(-1)
            bad = ~torch.isfinite(d) | (
                d > 0.05 * (w.float().abs().amax(-1) + 1))
            at[what] = (int(bad.sum()), bad.nonzero()[:8].tolist())
        cs.log(f"[probe] {name}: FAILED {e}; rows off (count, first (b, "
               f"row, head)) {at}")
        return dict(case=name, error=str(e), rows_off=at)
    bound = cs._flash_bound(spec, cs._valid_pairs(spec, segs), 2, True)
    rec = dict(case=name, max_abs_err=abs_errs, norm_err=errs,
               planted_norm_err=planted, bound_ms=bound[0],
               bound_by=bound[1])
    if check_only:
        cs.log(f"[probe] {name}: norm err {errs} planted {planted}")
        return rec
    rec.update(cs.b2_times(spec, qs, k, v, o, lse, do, segs, simple=simple))
    rec["kernels_ms"] = kernel_split(lambda: fa._bwd_cuda(
        qs, k, v, o, lse, do, causal, segs, sc))
    cs.log(f"[probe] {name}: device ms by kernel {rec['kernels_ms']}")
    del qs, k, v, o, lse, do, got, want
    torch.cuda.empty_cache()
    cs.log(f"[probe] {name}: norm err dq {errs['dq']:.2e} dk "
           f"{errs['dk']:.2e} dv {errs['dv']:.2e} (planted "
           f"{planted[cs.PLANTED[1]]:.2e}); sm90 {rec['bwd_ms']:.4f} ms by "
           f"events, {rec['bwd_ms_graph']:.4f} by graph replay; bound "
           f"{bound[0]:.4f} ({bound[1]}); simple {rec['simple_bwd_ms']} / "
           f"{rec['simple_bwd_ms_graph']}; library fwd+bwd "
           f"{rec['library_fwd_bwd_ms']} by events, bwd "
           f"{rec['library_bwd_ms_graph']} by replay")
    return rec


def probe_ragged(rnd, check_only=False) -> list:
    """chip_smoke.ragged_case on every phase 2 case (the case inputs are
    drawn afresh from phase 2's seed, so every build and round sees the
    same ones)."""
    import numpy as np
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    rng = np.random.default_rng(0)
    recs = []
    for name, kw in cs._ragged_specs(rng):
        try:
            rec = cs.ragged_case(rpa, name, kw, rng, timed=not check_only)
        except RuntimeError as e:
            cs.log(f"[probe] {name}: FAILED {e}")
            recs.append(dict(case=name, error=str(e)))
            continue
        r = rec["designs"][rec["design"]]
        cs.log(f"[probe] {name} (round {rnd}): design {rec['design']} err "
               f"{r['max_abs_err']:.3e} (limit {r['tol']:.3e}; planted "
               f"{r['planted_max_abs_err']})" + ("" if check_only else
               f"; {rec['ms']:.4f} ms by events, {rec['ms_graph']:.4f} by "
               f"replay; simple {rec['simple_ms_graph']:.4f}; plan "
               f"{rec['plan_ms']:.4f}; SDPA {cs._fmt_ms(rec['library_ms'])}"
               f" / {cs._fmt_ms(rec['library_ms_graph'])}; bound "
               f"{rec['bound_ms']:.5f} ({rec['bound_by']})"))
        recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bwd", action="store_true",
                    help="B2 (flash_bwd_sm90.cu) in place of B1")
    ap.add_argument("--ragged", action="store_true",
                    help="B3 (ragged_paged_attention_sm90.cu) in place of "
                         "B1")
    ap.add_argument("--check", action="store_true",
                    help="check only, time nothing")
    ap.add_argument("--cases", default="",
                    help="letters of phase 3's cases (default: every one "
                         "the sm90 design takes)")
    ap.add_argument("--simple", action="store_true",
                    help="also build and time the simple kernel")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE,... macros for one more build")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times every build is checked and timed, in turn")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "flash_fwd_probe.json"),
                    help="where the JSON record goes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    # the probe swaps the builds itself: the block-config cache keeps to
    # the default build (kernels/autotune.py's kill switch)
    os.environ["PADDLE_TPU_PALLAS_AUTOTUNE"] = "0"
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    cs.log(f"[card] {cs.card_line()}")
    want = set(args.cases.split(",")) - {""}
    cases = [(i, name, spec) for i, (name, spec) in enumerate(cs.FLASH_CASES)
             if spec[5] in fa._SM90_D and (not want or name[0] in want)]
    if args.simple and not args.ragged:
        fa._load_kernel()
    if args.bwd:
        fa._load_sm90()
    if args.ragged:
        rpa._load_kernel()      # the simple design, timed beside
        mod, source, attr, loader = (rpa, "ragged_paged_attention_sm90",
                                     "_SM90_LIB", rpa._load_sm90)
    else:
        mod = fa
        source, attr, loader, probe = (
            ("flash_bwd_sm90", "_SM90_BWD_LIB", fa._load_sm90_bwd,
             probe_bwd_case) if args.bwd else
            ("flash_fwd_sm90", "_SM90_LIB", fa._load_sm90, probe_case))
    out = dict(card=cs.card_line(), kernel="B3" if args.ragged else
               "B2" if args.bwd else "B1", builds=[])
    regs = {}

    def run_build(variant, rnd):
        flags = tuple(f"-D{x}" for x in variant.split(",") if x)
        if variant not in regs:
            try:
                regs[variant] = ptxas_report(source, flags)
            except RuntimeError as e:
                # a variant that does not build is reported, not fatal
                cs.log(f"[ptxas] {variant or 'default'}: {e}")
                regs[variant] = None
                out["builds"].append(dict(variant=variant or "default",
                                          error=str(e), cases=[]))
            for r in regs[variant] or ():
                cs.log(f"[ptxas] {variant or 'default'}: {r}")
        if regs[variant] is None:
            return
        saved = getattr(mod, attr)
        if flags:
            setattr(mod, attr, loader(flags))
        try:
            if args.ragged:
                recs = probe_ragged(rnd, args.check)
            else:
                recs = [probe(i, name, spec,
                              args.simple and not flags and rnd == 0,
                              args.check) for i, name, spec in cases]
        finally:
            setattr(mod, attr, saved)
        out["builds"].append(dict(variant=variant or "default", round=rnd,
                                  ptxas=regs[variant], cases=recs))

    # every build in turn, --rounds times over (A, B, ..., A, B, ...)
    for rnd in range(args.rounds):
        for variant in [""] + args.variant:
            run_build(variant, rnd)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    key = ("ms_graph" if args.ragged else
           "bwd_ms_graph" if args.bwd else "fwd_ms_graph")
    cs.log(json.dumps({"probe": [
        dict(variant=b["variant"], round=b.get("round"), **{
            c["case"]: "FAILED" if "error" in c else
            round(c[key], 5) if key in c else "ok" for c in b["cases"]})
        for b in out["builds"]]}))
    failed = [c["case"] for b in out["builds"] for c in b["cases"]
              if "error" in c] + [b["variant"] for b in out["builds"]
                                  if "error" in b]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
