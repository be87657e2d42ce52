"""How far the port's ResNet gradients stand from paddle_tpu's, whole
and stage by stage, at a batch size of your choice.

    JAX_PLATFORMS=cpu python tests/torch_resnet_parity_report.py \
        [--block BottleneckBlock] [--layout nhwc_s2d] [--batch 2] \
        [--seed 0] [--o1] [--fast-bn-stats]

One train-mode step of the twin ResNets of tests/torch_port_helpers.py
(resnet18's block counts, 64 x 64 images, the reference's weights), in
f32 or bf16 O1, and the port's f64 twin. Prints, over every parameter
gradient, the largest distance (over the other's norm) of the port's
from the reference's and the whole gradients' distances from the f64
ones; then for each stage (resnet_stages: the stem, each block, the
head), run on the reference's input and cotangent, the largest such
distance of its tensors between the port and the reference, the port
and its f64 stage, and the reference and that f64 stage. Runs on the
CPU; no number here is a device measurement. The ResNet tests'
docstrings cite its readings.
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_helpers as H  # noqa: E402


def _far(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", default="BottleneckBlock",
                    choices=("BasicBlock", "BottleneckBlock"))
    ap.add_argument("--layout", default="nhwc_s2d",
                    choices=sorted(H.RESNET_LAYOUTS))
    ap.add_argument("--batch", type=int, default=H.RESNET_BATCH)
    ap.add_argument("--seed", type=int, default=0, help="the batch's seed")
    ap.add_argument("--o1", action="store_true", help="bf16 O1, not f32")
    ap.add_argument("--fast-bn-stats", action="store_true")
    args = ap.parse_args()
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as TF
    H.RESNET_BATCH = args.batch
    restore = H.fast_bn_flag(args.fast_bn_stats)
    try:
        jm, tm = H.twin_resnets(args.block, args.layout)
        _, t64 = H.twin_resnets(args.block, args.layout, dtype="float64")
        x, y = H.resnet_batch(args.layout, args.seed)
        start = [b.clone() for b in tm.buffers()]
        _, ref_stages, ref_grads = H.reference_stages(jm, x, y, args.o1)
        with H._autocast(ptt, args.o1):
            logits = tm(torch.from_numpy(x))
        TF.cross_entropy(logits, torch.from_numpy(y)).backward()
        TF.cross_entropy(t64(torch.from_numpy(x).double()),
                         torch.from_numpy(y)).backward()
        names = [n for n, _ in tm.named_parameters()]
        mine = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
        exact = {n: p.grad.numpy() for n, p in t64.named_parameters()}
        ref = {n: ref_grads[n].astype(np.float64) for n in names}
        flat = {k: np.concatenate([d[n].ravel() for n in names])
                for k, d in (("port", mine), ("ref", ref), ("f64", exact))}
        print(f"{args.block} {args.layout} batch {args.batch} seed "
              f"{args.seed} {'bf16 O1' if args.o1 else 'f32'}: whole, port "
              f"vs reference, largest over tensors "
              f"{max(_far(mine[n], ref[n]) for n in names):.3g}; all "
              f"gradients from f64: port {_far(flat['port'], flat['f64']):.3g}"
              f", reference {_far(flat['ref'], flat['f64']):.3g}")
        # the stages start from the statistics the reference's stages saw
        with torch.no_grad():
            for model in (tm, t64):
                for b, b0 in zip(model.buffers(), start):
                    b.copy_(b0)
        got = H.stage_grads(tm, ref_stages, y, args.o1)
        f64 = H.stage_grads(t64, ref_stages, y)
        for name, (_, grads) in got.items():
            refs = dict(ref_grads, **{f"{name} input": ref_stages[name][3]})
            far = [max(_far(a, b) for a, b in pairs) for pairs in (
                [(grads[n], refs[n]) for n in grads],
                [(grads[n], f64[name][1][n]) for n in grads],
                [(refs[n], f64[name][1][n]) for n in grads])]
            print(f"  {name:9s} port-ref {far[0]:.3g}  port-f64 {far[1]:.3g}"
                  f"  ref-f64 {far[2]:.3g}")
    finally:
        restore()


if __name__ == "__main__":
    main()
