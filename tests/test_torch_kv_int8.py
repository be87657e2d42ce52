"""int8 KV pools in paddle_tpu_torch against paddle_tpu's.

The quantizer (`_quantize_kv`), `calibrate_kv_scales` and the decode
attention's dequant fold (`_pool_decode_attention` with kdq/vdq) are
held to the reference's on the same numpy inputs. The port's int8
LLMEngine is held to the reference's int8 engine on the same traffic
(prefix caching and preemption): int8 pools, every `stats` counter,
`peak_used_blocks` and `available_blocks` exactly equal, tokens equal
under the logit-margin guard; and to the port's own fp engine by the
reference's bar (at least half the tokens agree). B3's plain
version is held to the reference's jnp `_ragged_reference` at the
shapes the new engine paths launch: a verify wave (every row a window
of k+1 tokens over its cached context) over f32 and int8 pools, and
bf16 q over int8 pools with dequant scales.

Tolerances: calibrate_kv_scales, rtol 1e-5 (both take the amax of the
same f32 forward, which XLA and torch sum in other orders, ~1e-6
apart). B3's plain version, as tests/test_torch_ragged_attention.py
holds it: f32, rtol/atol 1e-5, int8 pools atol 5e-5 (scores of raw int8
products); bf16 q: atol 2e-3, a bf16 ulp (2^-8) of a probability in
the value product, where the two sides' f32 softmax may round to bf16
on either side of a tie.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional.serving import \
    _quantize_kv as jquantize
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference import calibrate_kv_scales as jcalibrate
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.kernels.pallas import ragged_paged_attention as jra
from paddle_tpu_torch.incubate.nn.functional.serving import _quantize_kv
from paddle_tpu_torch.inference import LLMEngine, calibrate_kv_scales
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.kernels.ragged_paged_attention import \
    ragged_paged_attention
from torch_port_helpers import (assert_tokens_equal_guarded, twin_gpts,
                                twin_llamas)

ENGINE_KW = dict(max_batch=3, block_size=8, num_blocks=11, decode_chunk=4,
                 prompt_quantum=16, max_model_len=64)
N_NEW = 14


@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


@pytest.fixture(scope="module")
def llamas():
    return twin_llamas(seed=5)


def _traffic(seed=7):
    """Six prompts on a page-aligned 16-token prefix (the second wave
    resumes from the prefix cache), in a pool small enough to preempt."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 1024, (n,))])
            .astype(np.int32) for n in (3, 5, 9, 2, 7, 4)]


@pytest.mark.parametrize("round_type", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(round_type, dtype):
    rng = np.random.default_rng(round_type)
    x = rng.standard_normal((5, 3, 4, 16)).astype(np.float32) * 3
    # values on the rounding ties, where the two round types differ
    x[0, 0, 0, :8] = np.array([0.5, -0.5, 1.5, -1.5, 2.5, 126.5, 130.,
                               -200.]) / 20
    scale = np.array([20., 7., 40., 0.5], np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(dtype)
    got = _quantize_kv(xt, torch.from_numpy(scale), round_type, 127., -127.)
    want = np.asarray(jquantize(xj, jnp.asarray(scale), round_type, 127.,
                                -127.))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_calibrate_kv_scales_matches_reference(family, gpts, llamas):
    jm, tm = gpts if family == "gpt" else llamas
    ids = np.random.default_rng(3).integers(0, 1024, (2, 19)).astype(
        np.int32)
    want = jcalibrate(jm, ids)
    got = calibrate_kv_scales(tm, ids)
    cfg = tm.config
    kvh = getattr(cfg, "num_kv_heads", None) or cfg.num_heads
    for g, w in zip(got, want):
        assert g.shape == w.shape == (cfg.num_layers, kvh)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5)
    # a tensor of ids gives the same scales
    again = calibrate_kv_scales(tm, torch.from_numpy(ids))
    np.testing.assert_array_equal(again[0], got[0])


def test_kv_quant_scales_shape_checked(gpts):
    jm, tm = gpts
    bad = (np.ones((1, 2), np.float32), np.ones((1, 2), np.float32))
    with pytest.raises(ValueError, match="kv_quant_scales"):
        JaxEngine(jm, kv_quant_scales=bad, **ENGINE_KW)
    with pytest.raises(ValueError, match="kv_quant_scales"):
        LLMEngine(tm, device="cpu", kv_quant_scales=bad, **ENGINE_KW)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_int8_engine_matches_reference(family, gpts, llamas):
    jm, tm = gpts if family == "gpt" else llamas
    prompts = _traffic()
    scales = jcalibrate(jm, prompts[1][None])
    je = JaxEngine(jm, kv_quant_scales=scales, **ENGINE_KW)
    jres = je.generate(prompts, max_new_tokens=N_NEW)
    te = LLMEngine(tm, device="cpu", kv_quant_scales=scales, **ENGINE_KW)
    tres = te.generate(prompts, max_new_tokens=N_NEW)
    assert te.cache.key_caches[0].dtype == torch.int8
    assert te.cache.value_caches[0].dtype == torch.int8
    assert dict(je.stats) == te.stats
    assert te.stats["preemptions"] >= 1
    assert te.stats["prefix_cache_hit_tokens"] > 0
    assert te.peak_used_blocks == je.peak_used_blocks
    assert te.cache.available_blocks == je.cache.available_blocks
    for p, jr, tr in zip(prompts, jres, tres):
        assert tr.finish_reason == jr.finish_reason == "length"
        assert assert_tokens_equal_guarded(tm, p, jr.output_ids,
                                           tr.output_ids) > 0


def test_int8_engine_close_to_fp_engine(gpts):
    """The reference's own bar (tests/test_kv_int8.py): calibrated int8
    pools halve the pool bytes, and greedy tokens agree with the fp
    engine's on at least half the positions."""
    _jm, tm = gpts
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (8, 12)]
    kw = dict(max_batch=2, block_size=16, decode_chunk=4,
              prompt_quantum=16, max_model_len=64)
    ref = [r.output_ids for r in LLMEngine(tm, device="cpu", **kw)
           .generate(prompts, 8)]
    scales = calibrate_kv_scales(tm, prompts[1][None])
    eng = LLMEngine(tm, device="cpu", kv_quant_scales=scales, **kw)
    fp = LLMEngine(tm, device="cpu", **kw)
    assert eng.cache.key_caches[0].element_size() == 1
    assert sum(k.numel() * k.element_size() for k in
               eng.cache.key_caches) * 4 == sum(
        k.numel() * k.element_size() for k in fp.cache.key_caches)
    out = [r.output_ids for r in eng.generate(prompts, 8)]
    agree = np.mean([np.mean(a == b) for a, b in zip(out, ref)])
    assert agree >= 0.5, agree


def test_decode_attention_dequant_matches_reference():
    """The decode step's attention over an int8 pool with dequant scales
    (the port's gathered pages against the reference's whole-pool
    masked form), GQA, rows of different lengths, one inactive row on
    the trash page."""
    rng = np.random.default_rng(9)
    B, H, kvH, D, bs, NB = 3, 4, 2, 16, 8, 10
    kpool = rng.integers(-127, 128, (NB * bs, kvH, D)).astype(np.int8)
    vpool = rng.integers(-127, 128, (NB * bs, kvH, D)).astype(np.int8)
    kdq = rng.uniform(0.005, 0.02, (kvH,)).astype(np.float32)
    vdq = rng.uniform(0.005, 0.02, (kvH,)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pages = {0: [3, 1, 7], 1: [2, 5]}        # row 2 inactive
    lens = np.array([19, 9, 0], np.int64)
    W = 3
    tbl = np.zeros((B, W), np.int64)         # page 0 is the trash page
    off = np.full((B, NB), -1, np.int32)
    off[2, 0] = 0
    for b, pg in pages.items():
        tbl[b, :len(pg)] = pg
        off[b, pg] = np.arange(len(pg)) * bs
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jeng._pool_decode_attention(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(off), jnp.asarray(lens.astype(np.int32)), scale, bs,
        kdq=jnp.asarray(kdq), vdq=jnp.asarray(vdq)))
    got = teng._pool_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kpool),
        torch.from_numpy(vpool), torch.from_numpy(tbl),
        torch.from_numpy(lens), scale, bs, kdq=torch.from_numpy(kdq),
        vdq=torch.from_numpy(vdq)).numpy()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# B3's plain version at the verify-wave and int8 shapes
# ---------------------------------------------------------------------------
def _verify_case(int8, q_dtype="float32", B=4, k=3, H=4, Hk=2, D=32, bs=8,
                 NB=24, seed=0):
    """A verify wave: each of B rows computes a [last token, k drafts]
    window of k+1 tokens over its cached context (its pages drawn from
    the pool), in the token bucket pinned at B * (k + 1) plus dead
    padding; or (k=None) the int8 engine's prefix-resume wave: rows of
    3-9 new tokens over a shared 16-token prefix."""
    rng = np.random.default_rng(seed)
    T = 2 * B * (k + 1) if k else 48
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    shared = [free.pop(), free.pop()]
    c = 0
    for r in range(B):
        cached = int(rng.integers(5, 25)) if k else 16
        m = k + 1 if k else int(rng.integers(3, 10))
        rows[c:c + m] = r
        pos[c:c + m] = cached + np.arange(m)
        kv_start[r] = cached
        npg = -(-(cached + m) // bs)
        pg = shared[:2] if not k else []
        pg = pg + [free.pop() for _ in range(npg - len(pg))]
        off[r, pg] = np.arange(npg) * bs
        c += m
    f = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    q, k_new, v_new = f(T, H, D), f(T, Hk, D), f(T, Hk, D)
    if int8:
        kpool = rng.integers(-127, 128, (NB * bs, Hk, D)).astype(np.int8)
        vpool = rng.integers(-127, 128, (NB * bs, Hk, D)).astype(np.int8)
        kdq = rng.uniform(0.005, 0.02, (Hk,)).astype(np.float32)
        vdq = rng.uniform(0.005, 0.02, (Hk,)).astype(np.float32)
    else:
        kpool, vpool = f(NB * bs, Hk, D), f(NB * bs, Hk, D)
        kdq = vdq = None
    if q_dtype == "bfloat16":
        # values exactly representable in bf16 on both sides
        q, k_new, v_new = (torch.from_numpy(a).bfloat16().float().numpy()
                           for a in (q, k_new, v_new))
    return dict(q=q, k_new=k_new, v_new=v_new, kpool=kpool, vpool=vpool,
                rows=rows, pos=pos, kv_start=kv_start, off=off, bs=bs,
                scale=1.0 / np.sqrt(D), kdq=kdq, vdq=vdq, dtype=q_dtype)


_ARR = ("q", "k_new", "v_new", "kpool", "vpool", "rows", "pos",
        "kv_start", "off")
RAGGED_CASES = {
    "verify_f32_pool": (dict(int8=False), dict(rtol=1e-5, atol=1e-5)),
    "verify_int8_pool_dequant": (dict(int8=True),
                                 dict(rtol=1e-5, atol=5e-5)),
    "verify_bf16_q_int8_pool": (dict(int8=True, q_dtype="bfloat16"),
                                dict(rtol=0, atol=2e-3)),
    "prefix_resume_bf16_q_int8_pool": (
        dict(int8=True, q_dtype="bfloat16", k=None),
        dict(rtol=0, atol=2e-3)),
}


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_plain_ragged_at_new_shapes_matches_reference(name):
    spec, tol = RAGGED_CASES[name]
    c = _verify_case(**spec)
    low = c["dtype"] == "bfloat16"

    def t(key):
        a = c[key]
        if a is None:
            return None
        x = torch.from_numpy(a)
        return x.bfloat16() if low and key in ("q", "k_new", "v_new") else x

    def j(key):
        a = c[key]
        if a is None:
            return None
        x = jnp.asarray(a)
        return x.astype(jnp.bfloat16) if low and key in (
            "q", "k_new", "v_new") else x

    got = ragged_paged_attention(
        *(t(k) for k in _ARR), block_size=c["bs"], scale=c["scale"],
        kdq=t("kdq"), vdq=t("vdq"), with_pool=True).numpy()
    want = np.asarray(jra.ragged_paged_attention(
        *(j(k) for k in _ARR), block_size=c["bs"], scale=c["scale"],
        kdq=j("kdq"), vdq=j("vdq"), with_pool=True, path="jnp"))
    np.testing.assert_allclose(got, want, **tol)
    dead = c["rows"] < 0
    assert dead.any()
    np.testing.assert_array_equal(got[dead], 0.0)
