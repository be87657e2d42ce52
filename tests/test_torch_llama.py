"""paddle_tpu_torch LLaMA against paddle_tpu's: rotary tables and
fused_rotary_position_embedding, weight carry-over, logits with and
without flash attention (GQA and MHA), and greedy `generate` tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import llama as jllama
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import generate
from paddle_tpu_torch.models import llama as tllama
from torch_port_helpers import (LLAMA_CONFIGS, assert_tokens_equal_guarded,
                                jax_state_numpy, twin_llamas)


@pytest.fixture(scope="module")
def twins():
    return twin_llamas()


def test_params_round_trip(twins):
    jm, tm = twins
    named = jax_state_numpy(jm)
    sd = tm.state_dict()
    assert sorted(sd) == sorted(named)
    for k, v in named.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_tables_match_reference(dt):
    want = jllama._rope_cos_sin(4096, 128, 10000.0, jnp.dtype(dt))
    got = tllama._rope_cos_sin(4096, 128, 10000.0, getattr(torch, dt))
    for g, w in zip(got, want):
        assert g.shape == (4096, 128) and g.dtype == getattr(torch, dt)
        # f32: the frequencies agree to an ulp, but one ulp of frequency
        # moves position p's argument by up to p * 2^-23 (4.9e-4 at
        # p = 4095): most runs read 6e-8, some 1.5e-4, so 1e-3 bounds
        # two such ulps; the bf16 tables round that once (1 ulp, 2^-8)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), rtol=0,
            atol=1e-3 if dt == "float32" else 2 ** -7)


def _rope_inputs(dt, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 32)).astype(np.float32)
    pid = rng.integers(0, 40, (2, 12)).astype(np.int64)
    cos, sin = jllama._rope_cos_sin(48, 32, 10000.0, jnp.float32)
    cos, sin = np.array(cos), np.array(sin)
    cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dt == "bfloat16" \
        else jnp.asarray
    tcast = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) \
        if dt == "bfloat16" else torch.from_numpy
    return (q, k, cos, sin, pid), cast, tcast


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["tables", "neox_default",
                                   "interleaved_default", "position_ids"])
def test_fused_rotary_matches_reference(style, dt):
    (q, k, cos, sin, pid), cast, tcast = _rope_inputs(dt)
    kw = {}
    if style == "tables":
        kw = dict(sin=sin[:12], cos=cos[:12])
    elif style == "interleaved_default":
        kw = dict(use_neox_rotary_style=False)
    elif style == "position_ids":
        kw = dict(sin=sin, cos=cos, position_ids=pid)
    jkw = {a: (pt.to_tensor(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    tkw = {a: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    wq, wk = JIF.fused_rotary_position_embedding(
        pt.to_tensor(cast(q)), pt.to_tensor(cast(k)), **jkw)
    gq, gk = TIF.fused_rotary_position_embedding(tcast(q), tcast(k), **tkw)
    for g, w in ((gq, wq), (gk, wk)):
        w = np.asarray(w._data)
        assert str(g.dtype).endswith(str(w.dtype))
        # f32: the same products and sums, an ulp apart; bf16: the
        # reference may keep the rotation's f32 intermediates (XLA fuses
        # the promoted ops), the port rounds its output once: 1 ulp
        np.testing.assert_allclose(
            g.float().numpy(), w.astype(np.float32),
            rtol=1e-6 if dt == "float32" else 2 ** -7,
            atol=1e-6 if dt == "float32" else 2 ** -7)


def _logits_pair(jm, tm, ids):
    want = np.asarray(jm(pt.to_tensor(ids)).numpy()).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids.astype(np.int64))).float().numpy()
    return got, want


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("name", sorted(LLAMA_CONFIGS))
def test_logits_match_reference_f32(name, flash):
    jm, tm = twin_llamas(name, use_flash_attention=flash)
    # 128 tokens: a length the flash kernels take, so at head_dim 64 the
    # port runs B1's plain version (and the reference its composite)
    ids = np.random.default_rng(1).integers(0, 1024, (2, 128)).astype(
        np.int32)
    n0 = fa.flash_fwd.plain_calls
    got, want = _logits_pair(jm, tm, ids)
    if flash and name.startswith("d64"):
        assert fa.flash_fwd.plain_calls == n0 + tm.config.num_layers
    # f32 on both sides; XLA and torch sum in different orders (logits
    # of rms ~0.3, differences up to ~1e-6 seen), and a rope frequency
    # one ulp apart (see the rope table test) moves them up to ~1e-6 more
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-6)


def test_logits_match_reference_bf16():
    jm, tm = twin_llamas("d64_gqa", dtype="bfloat16",
                         use_flash_attention=True)
    ids = np.random.default_rng(2).integers(0, 1024, (2, 128)).astype(
        np.int32)
    got, want = _logits_pair(jm, tm, ids)
    # bf16 weights and activations: the two round their intermediates at
    # different places (XLA fuses elementwise chains in f32), a few bf16
    # ulps on each of 2 layers, against logits of rms ~0.3 (0.0103 seen)
    scale = np.sqrt((want ** 2).mean())
    assert np.abs(got - want).max() <= 0.05 * scale + 2 ** -7 * \
        np.abs(want).max(), (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("name", ["tiny_gqa", "d64_mha"])
def test_greedy_generate_matches_reference(name):
    jm, tm = twin_llamas(name, seed=3)
    rng = np.random.default_rng(4)
    for n in (7, 19):
        p = rng.integers(0, 1024, (n,)).astype(np.int32)
        want = np.asarray(jax_generate(
            jm, pt.to_tensor(p[None]), max_new_tokens=10).numpy())[0, n:]
        got = generate(tm, p[None], max_new_tokens=10,
                       device="cpu").numpy()[0, n:]
        assert assert_tokens_equal_guarded(tm, p, want, got) > 0


def test_generate_keeps_the_gqa_cache_unrepeated(twins):
    from paddle_tpu_torch.models.generation import (
        _family, _llama_forward_with_cache, _static_cache)
    _jm, tm = twins
    fwd, dtype = _family(tm)
    assert fwd is _llama_forward_with_cache and dtype == torch.float32
    cache = _static_cache(tm, 1, 16, dtype)
    assert cache[0]["k"].shape == (1, 16, tm.config.num_kv_heads,
                                   tm.config.head_dim)
