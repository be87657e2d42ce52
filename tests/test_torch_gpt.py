"""paddle_tpu_torch GPT against paddle_tpu's: weight carry-over, f32
logits, LayerNorm's cast order, and greedy `generate` tokens."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.ops import nn_ops
from paddle_tpu_torch import gpt_params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from torch_port_helpers import (assert_tokens_equal_guarded,
                                jax_state_numpy, twin_gpts)


@pytest.fixture(scope="module")
def twins():
    return twin_gpts()


def test_params_round_trip(twins):
    jm, tm = twins
    named = jax_state_numpy(jm)
    sd = tm.state_dict()
    assert sorted(sd) == sorted(named)
    for k, v in named.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    # bf16 arrays carry across bit for bit
    bf = {k: v.astype(jnp.bfloat16) for k, v in named.items()}
    tb = GPTForCausalLM(gpt_tiny(), device="cpu", dtype="bfloat16")
    tb.load_state_dict(gpt_params_from_numpy(bf))
    for k, v in tb.state_dict().items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            v.view(torch.int16).numpy(), bf[k].view(np.int16))


def test_logits_match_paddle_tpu_f32(twins):
    jm, tm = twins
    ids = np.random.default_rng(0).integers(0, 1024, (2, 24)).astype(
        np.int32)
    want = np.asarray(jm(pt.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.as_tensor(ids.astype(np.int64))).numpy()
    # f32 both sides; matmul/softmax sums run in different orders
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_layer_norm_casts_before_affine_bf16():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 128)) * 3 + 1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (128,)).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    xb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    want = np.asarray(nn_ops.layer_norm.raw_fn(xb, wb, bb, 1e-5)
                      .astype(jnp.float32))
    t = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, w, b)]
    got = F.layer_norm(*t, epsilon=1e-5)
    assert got.dtype == torch.bfloat16
    # the same bf16 roundings in the same order: equal up to one bf16
    # ulp where XLA and torch round the f32 statistics differently
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)
    # the affine in f32 (the other order) is measurably different
    x32 = t[0].float()
    norm = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
        x32.var(-1, unbiased=False, keepdim=True) + 1e-5)
    f32_affine = (norm * t[1].float() + t[2].float()).to(torch.bfloat16)
    assert (f32_affine != got).any()
    cast_first = (norm.to(torch.bfloat16) * t[1]) + t[2]
    assert torch.equal(cast_first, got)


def test_greedy_generate_matches_paddle_tpu(twins):
    jm, tm = twins
    rng = np.random.default_rng(2)
    for n in (7, 19):
        p = rng.integers(0, 1024, (n,)).astype(np.int32)
        want = np.asarray(jax_generate(
            jm, pt.to_tensor(p[None]), max_new_tokens=12).numpy())[0, n:]
        got = generate(tm, p[None], max_new_tokens=12,
                       device="cpu").numpy()[0, n:]
        assert assert_tokens_equal_guarded(tm, p, want, got) > 0
