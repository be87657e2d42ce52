#!/usr/bin/env python3
"""Time LLMEngine's decode attention alone on the card.

    python3 tools/decode_probe.py [--out decode_probe.json]

Run from the root of a checkout, on a machine with one NVIDIA GPU. At
the serving runs' decode shapes (chip_smoke.py phases 4 and 9: 8 rows,
10 pages of 64 slots a row, bf16 pools, one pool a layer; gpt3_1p3b's
16 heads over 24 layers and llama2_7b's 32 over 32, head_dim 128) it
times by CUDA-graph replay (chip_smoke.graph_ms: device time only) a
step's attention, every layer's pool in turn, so each read finds its
pool cold in L2 as a decode step does, in these forms of the same
attention (bf16 products summed in f32, f32 scores):
`inference/llm_engine.py::_pool_decode_attention` (the gathered pages
read in place by bf16 products into f32, q block-diagonal), given a
contiguous page table and given the table as a strided view (as the
engine's static input holds it); the form before it (the gathered
pages widened to f32, two f32 einsums); and a per-head form (each kv
head's pages copied out whole, then bf16 products into f32). It prints
each form's ms a layer and its largest difference from the engine's,
one pool's gather alone with either table, and the least time of the
one necessary read (each row's K and V slots once, at the published
HBM rate). The card's name and power
limit lead the output; the JSON record goes to --out.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

SHAPES = {"gpt3_1p3b": dict(H=16, kvH=16, D=128, NB=257, layers=24),
          "llama2_7b": dict(H=32, kvH=32, D=128, NB=129, layers=32)}
B, PAGES, BS = 8, 10, 64


def _widened_form(q, kpool, vpool, tbl, lens, scale, bs):
    """The engine's form before the bf16 products: the gathered pages
    widened to f32, two f32 einsums."""
    import torch
    B, H, D = q.shape
    kvH = kpool.shape[1]
    rep = H // kvH
    P = tbl.shape[1]
    kc = kpool.view(-1, bs, kvH, D)[tbl].reshape(B, P * bs, kvH, D)
    vc = vpool.view(-1, bs, kvH, D)[tbl].reshape(B, P * bs, kvH, D)
    q4 = (q.float() * scale).reshape(B, kvH, rep, D)
    s = torch.einsum("bkrd,btkd->bkrt", q4.to(kpool.dtype).float(),
                     kc.float())
    valid = torch.arange(P * bs, device=q.device)[None, :] \
        <= lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrt,btkd->bkrd", p.to(vpool.dtype).float(),
                       vc.float())
    return out.reshape(B, H * D)


def _per_head_form(q, kpool, vpool, tbl, lens, scale, bs):
    """Each kv head's gathered pages copied out as [B * kvH, T, D], then
    bf16 products into f32 by torch.bmm(..., out_dtype=torch.float32)."""
    import torch
    Bq, H, D = q.shape
    kvH = kpool.shape[1]
    rep = H // kvH
    T = tbl.shape[1] * bs

    def gather(pool):
        c = pool.view(-1, bs, kvH, D)[tbl].reshape(Bq, T, kvH, D)
        return c.permute(0, 2, 1, 3).reshape(Bq * kvH, T, D)

    kc, vc = gather(kpool), gather(vpool)
    q3 = (q.float() * scale).to(kpool.dtype).reshape(Bq * kvH, rep, D)
    s = torch.bmm(q3, kc.transpose(1, 2), out_dtype=torch.float32)
    s = s.reshape(Bq, kvH, rep, T)
    valid = torch.arange(T, device=q.device)[None, :] <= lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(vpool.dtype).reshape(Bq * kvH, rep, T)
    out = torch.bmm(p, vc, out_dtype=torch.float32)
    return out.reshape(Bq, H * D)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from chip_smoke import HBM_BYTES_PER_S, graph_ms
    from paddle_tpu_torch.inference.llm_engine import _pool_decode_attention
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    recs = {}
    for name, s in SHAPES.items():
        H, kvH, D, NB, L = s["H"], s["kvH"], s["D"], s["NB"], s["layers"]

        def pool():
            return torch.randn((NB * BS, kvH, D), generator=g,
                               device="cuda").to(torch.bfloat16)

        kps = [pool() for _ in range(L)]
        vps = [pool() for _ in range(L)]
        q = torch.randn((B, H, D), generator=g, device="cuda"
                        ).to(torch.bfloat16)
        tbl = torch.randperm(NB - 1, generator=g, device="cuda")[
            :B * PAGES].reshape(B, PAGES) + 1
        # the same table as a strided view, as the engine's decode input
        # [B, 2 + W] holds it
        strided = torch.zeros((B, 2 + PAGES), dtype=torch.int64,
                              device="cuda")
        strided[:, 2:] = tbl
        strided = strided[:, 2:]
        lens = torch.randint(PAGES * BS - 64, PAGES * BS, (B,),
                             generator=g, device="cuda")
        scale = 1.0 / math.sqrt(D)
        T = PAGES * BS

        def layers_ms(f, t=tbl):
            """ms a layer of f over every layer's pool in turn."""
            return graph_ms(lambda: [f(q, k, v, t, lens, scale, BS)
                                     for k, v in zip(kps, vps)],
                            reps=2) / L

        def gather_ms(t):
            return graph_ms(lambda: [k.view(-1, BS, kvH, D)[t]
                                     for k in kps], reps=2) / L

        kv = 2 * B * T * kvH * D * 2                  # bf16 K and V slots
        rec = dict(H=H, kvH=kvH, D=D, rows=B, slots=T, layers=L,
                   ms=layers_ms(_pool_decode_attention),
                   kv_read_bound_ms=1e3 * kv / HBM_BYTES_PER_S,
                   gather_ms=gather_ms(tbl),
                   strided_gather_ms=gather_ms(strided))
        want = _pool_decode_attention(q, kps[0], vps[0], tbl, lens, scale,
                                      BS)
        for form_name, form, t in (
                ("strided_table", _pool_decode_attention, strided),
                ("widened", _widened_form, tbl),
                ("per_head", _per_head_form, tbl)):
            got = form(q, kps[0], vps[0], t, lens, scale, BS)
            rec[f"{form_name}_ms"] = layers_ms(form, t)
            rec[f"{form_name}_max_abs_diff"] = float(
                (got - want).abs().max())
        recs[name] = rec
        print(f"{name}: ms a layer by replay, {L} layers' pools in turn "
              f"(rows {B}, slots {T}, H {H}, kvH {kvH}): "
              f"_pool_decode_attention {rec['ms']:.4f}; "
              + "; ".join(f"{f} {rec[f + '_ms']:.4f} (max abs diff "
                          f"{rec[f + '_max_abs_diff']:.3e})"
                          for f in ("strided_table", "widened", "per_head"))
              + f"; one K gather {rec['gather_ms']:.4f}, with the strided "
              f"table {rec['strided_gather_ms']:.4f}; KV read bound "
              f"{rec['kv_read_bound_ms']:.4f}", flush=True)
        del kps, vps
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           shapes=recs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
