"""Largest errors seen by the paddle_tpu_torch CPU parity tests.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Reruns the float comparisons of tests/test_torch_*.py on their own
inputs and prints one line per comparison: its tolerance and the
largest absolute and relative error between the port and paddle_tpu,
then the greedy-token comparisons (tokens compared under the margin
guard, tokens that differ). Runs on the CPU; no number here is a
device measurement.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.inference import LLMEngine as JaxEngine  # noqa: E402
from paddle_tpu.models.generation import generate as jax_generate  # noqa
from paddle_tpu.ops import nn_ops  # noqa: E402
from paddle_tpu_torch.inference import LLMEngine  # noqa: E402
from paddle_tpu_torch.models import generate  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
import test_torch_ragged_attention as tra  # noqa: E402
from test_torch_llm_engine import ENGINE_KW, N_NEW  # noqa: E402
from torch_port_helpers import guarded_len, twin_gpts  # noqa: E402


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    return d.max(), (d / np.maximum(np.abs(want), 1e-30)).max()


def _line(name, tol, got, want):
    a, r = _err(got, want)
    print(f"{name:48s} tol {tol:22s} max_abs {a:.3e} max_rel {r:.3e}")


def _tokens(name, tm, prompt, want, got):
    n = guarded_len(tm, prompt, want)
    diff = int((np.asarray(got)[:n] != np.asarray(want)[:n]).sum())
    print(f"{name:48s} tokens compared {n}/{len(want)}, differing {diff}")


def main():
    for name in sorted(tra.CASES):
        c = tra._mixed_case(**tra.CASES[name])
        wp = name != "no_pool"
        tol = tra.TOL["int8" in name]
        _line(f"ragged plain vs jnp reference [{name}]",
              f"atol {tol['atol']:g} rtol {tol['rtol']:g}",
              tra._torch(c, wp).numpy(), tra._jax(c, wp))
    c = tra._mixed_case(Hk=2, D=128, int8=True, seed=5)
    _line("ragged plain vs pallas_interpret [int8]", "atol 2e-4 rtol 2e-4",
          tra._torch(c).numpy(), tra._jax(c, path="pallas_interpret"))

    jm, tm = twin_gpts()
    ids = np.random.default_rng(0).integers(0, 1024, (2, 24)).astype(
        np.int32)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids.astype(np.int64))).numpy()
    _line("gpt_tiny logits f32", "atol 1e-4 rtol 1e-4", got,
          np.asarray(jm(pt.to_tensor(ids)).numpy()))

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 128)) * 3 + 1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (128,)).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    want = nn_ops.layer_norm.raw_fn(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), 1e-5)
    got = F.layer_norm(*(torch.as_tensor(a).to(torch.bfloat16)
                         for a in (x, w, b)), epsilon=1e-5)
    _line("layer_norm bf16 (cast before affine)", "atol 8e-3 rtol 8e-3",
          got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    rng = np.random.default_rng(2)
    for n in (7, 19):
        p = rng.integers(0, 1024, (n,)).astype(np.int32)
        want = np.asarray(jax_generate(
            jm, pt.to_tensor(p[None]), max_new_tokens=12).numpy())[0, n:]
        got = generate(tm, p[None], max_new_tokens=12,
                       device="cpu").numpy()[0, n:]
        _tokens(f"greedy generate, prompt {n}", tm, p, want, got)

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 1024, (n,))])
               .astype(np.int32) for n in (3, 5, 9, 2, 7, 4)]
    jres = JaxEngine(jm, **ENGINE_KW).generate(prompts, N_NEW)
    te = LLMEngine(tm, device="cpu", **ENGINE_KW)
    tres = te.generate(prompts, N_NEW)
    for i, (p, jr, tr) in enumerate(zip(prompts, jres, tres)):
        _tokens(f"engine vs paddle_tpu engine, request {i}", tm, p,
                jr.output_ids, tr.output_ids)
    print("port engine stats", te.stats)


if __name__ == "__main__":
    main()
