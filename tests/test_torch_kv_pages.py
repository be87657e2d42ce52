"""KV-page export/import (the disaggregation wire format) and the
"block" pool layout of paddle_tpu_torch's PagedKVCache and LLMEngine,
against paddle_tpu's on twin models (the same f32 weights).

Held exactly: the chained hashes, the chunk metadata (the reference's
dtype spelling and int8-scale digest), and the integer pool state after
an import (the prefix index both ways, the LRU order, every refcount,
the free count); greedy tokens of the migrated prefix exactly. Page
bytes in f32 within 1e-5 (the two packages' matmuls sum in other
orders); int8 codes exactly. A chunk the REFERENCE exported imports into
the port's engine and decodes to the reference's tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference import PagedKVCache as JaxCache
from paddle_tpu.inference import calibrate_kv_scales as jax_calibrate
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.inference import LLMEngine, PagedKVCache
from torch_fleet_cases import (ENGINE_KW, pool_state, prompts, reconciled,
                               serve)
from torch_port_helpers import cpu_place, twin_gpts, twin_llamas

PAGE_ATOL = 1e-5


@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


@pytest.fixture(scope="module")
def llamas():
    return twin_llamas()


def _engines(pair, **kw):
    jm, tm = pair
    kw = dict(ENGINE_KW, **kw)
    return (lambda: JaxEngine(jm, **kw),
            lambda: LLMEngine(tm, device="cpu", **kw))


def _roundtrip(pair, **kw):
    """Both packages: serve two prompts on a source engine, export the
    first prompt's chain, import it into a fresh engine, re-export,
    then serve the prompt there with its hash chain."""
    ps = prompts((41, 37), seed=3)
    p = ps[0]
    out = {}
    for side, make in zip(("ref", "port"), _engines(pair, **kw)):
        src, dst = make(), make()
        serve(src, ps, 4)
        hashes = src.cache.block_hashes(p)
        payload = src.export_kv_pages(hashes)
        n = dst.import_kv_pages(payload)
        state = pool_state(dst.cache)
        back = dst.export_kv_pages(hashes)
        # idempotent: a re-delivered chunk counts as resident
        again = dst.import_kv_pages(payload)
        got = serve(dst, [p], 6, prefix_hashes=hashes)[0]
        out[side] = dict(hashes=hashes, payload=payload, n=n, state=state,
                         back=back, again=again, got=got, src=src, dst=dst)
    return out


def _check_roundtrip(out, exact_bytes):
    r, t = out["ref"], out["port"]
    assert t["hashes"] == r["hashes"] and len(t["hashes"]) >= 2
    tp, rp = t["payload"], r["payload"]
    assert tp["v"] == rp["v"] == 1 and tp["start"] == rp["start"] == 0
    assert tp["meta"] == rp["meta"]
    assert [e["hash"] for e in tp["pages"]] == list(t["hashes"])
    for a, b in zip(tp["pages"], rp["pages"]):
        for kv in ("k", "v"):
            want = np.asarray(b[kv])
            assert a[kv].shape == want.shape
            if exact_bytes:
                np.testing.assert_array_equal(a[kv], want)
            else:
                np.testing.assert_allclose(a[kv], want, rtol=0,
                                           atol=PAGE_ATOL)
    # the bytes survive the port's own trip bit-exactly
    for a, b in zip(tp["pages"], t["back"]["pages"]):
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["v"], b["v"])
    assert t["n"] == r["n"] == len(t["hashes"])
    assert t["again"] == r["again"] == len(t["hashes"])
    assert t["state"] == r["state"]
    assert t["got"] == r["got"]
    assert t["dst"].stats["prefix_cache_hit_tokens"] == \
        r["dst"].stats["prefix_cache_hit_tokens"] >= \
        len(t["hashes"]) * ENGINE_KW["block_size"]
    assert reconciled(t["src"]) and reconciled(t["dst"])


def test_roundtrip_fp_gpt(gpts):
    _check_roundtrip(_roundtrip(gpts), exact_bytes=False)


def test_roundtrip_fp_llama_rope_layout(llamas):
    """LLaMA pools hold rope'd keys: the wire ships them verbatim."""
    _check_roundtrip(_roundtrip(llamas), exact_bytes=False)


def test_roundtrip_int8_pool_with_scale_digest(gpts):
    """int8 pools under the reference's calibrated scales on both sides:
    the chunks' metadata (digest included) is equal, the codes too."""
    jm, _tm = gpts
    kq, vq = jax_calibrate(jm, prompts((24,), seed=9)[0][None])
    scales = (np.asarray(kq, np.float32), np.asarray(vq, np.float32))
    out = _roundtrip(gpts, kv_quant_scales=scales)
    assert out["port"]["payload"]["meta"]["dtype"] == "int8"
    assert out["port"]["payload"]["meta"]["kv_scale_digest"]
    _check_roundtrip(out, exact_bytes=True)


def test_mismatched_chunk_raises(gpts):
    """Other int8 scales, another pool dtype, or another wire version:
    ValueError, nothing imported."""
    jm, tm = gpts
    p = prompts((41,), seed=3)[0]
    kq, vq = jax_calibrate(jm, p[None])
    s1 = (np.asarray(kq, np.float32), np.asarray(vq, np.float32))
    src = LLMEngine(tm, device="cpu", kv_quant_scales=s1, **ENGINE_KW)
    serve(src, [p], 2)
    hashes = src.cache.block_hashes(p)
    payload = src.export_kv_pages(hashes)
    for dst in (LLMEngine(tm, device="cpu", kv_quant_scales=(
            s1[0] * 2.0, s1[1] * 2.0), **ENGINE_KW),
                LLMEngine(tm, device="cpu", **ENGINE_KW)):
        with pytest.raises(ValueError, match="incompatible"):
            dst.import_kv_pages(payload)
        assert dst.cache.cached_pages == 0 and reconciled(dst)
    dst = LLMEngine(tm, device="cpu", kv_quant_scales=s1, **ENGINE_KW)
    with pytest.raises(ValueError, match="incompatible"):
        dst.import_kv_pages(dict(payload, v=2))


def test_partial_import_into_tiny_pool(gpts):
    """A pool one page short of the chain imports a valid prefix, never
    evicting its own chain, and leaks nothing; the integer state equals
    the reference's."""
    p = prompts((65,), seed=4)[0]       # 4 full blocks
    states = {}
    for side, (make_src, make_dst) in zip(
            ("ref", "port"), zip(_engines(gpts), _engines(gpts,
                                                          num_blocks=4))):
        src, dst = make_src(), make_dst()
        serve(src, [p], 2)
        hashes = src.cache.block_hashes(p)
        assert len(hashes) == 4
        n = dst.import_kv_pages(src.export_kv_pages(hashes))
        assert 0 < n < len(hashes)
        ncached, pages = dst.cache.match_prefix(p, hashes)
        assert len(pages) == n and reconciled(dst)
        states[side] = (n, pool_state(dst.cache))
    assert states["port"] == states["ref"]


def test_reference_chunk_imports_into_the_port(gpts):
    """A chunk the reference's engine exported (f32 numpy pages) is
    imported by the port's engine, which then decodes the reference's
    tokens from it."""
    make_ref, make_port = _engines(gpts)
    p = prompts((57,), seed=11)[0]
    src = make_ref()
    serve(src, [p], 2)
    hashes = src.cache.block_hashes(p)
    payload = src.export_kv_pages(hashes)
    want = serve(make_ref(), [p], 8)[0]
    dst = make_port()
    assert dst.import_kv_pages(payload) == len(hashes) == 3
    got = serve(dst, [p], 8, prefix_hashes=hashes)[0]
    assert dst.stats["prefix_cache_hit_tokens"] == 3 * 16
    assert dst.stats["prefix_cache_miss_tokens"] == len(p) - 3 * 16
    assert got == want


def test_block_layout_pools_and_block_multihead_attention():
    """layout="block" (now the default): the pools' shape and the block
    tables equal the reference's through a lease sequence, and the
    port's block_multihead_attention over the pool (a prefill wave, then
    a decode wave, the caches stored back with `update`) equals the
    reference's in f32 within 1e-5."""
    L, NB, kvH, bs, D, H = 1, 9, 2, 4, 16, 4
    j = JaxCache(L, NB, kvH, bs, D, dtype=jnp.float32,
                 enable_prefix_caching=True)
    t = PagedKVCache(L, NB, kvH, bs, D, dtype=torch.float32,
                     enable_prefix_caching=True, device="cpu")
    assert t.layout == j.layout == "block"
    assert tuple(t.key_cache(0).shape) == tuple(j.key_cache(0).shape) \
        == (NB, kvH, bs, D)
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 50, (n,)).astype(np.int32) for n in (5, 3)]
    for c in (j, t):
        for i, tk in enumerate(toks):
            c.add_sequence(i, len(tk), tokens=tk)
    tbl = np.asarray(t.block_table([0, 1], max_pages=3))
    np.testing.assert_array_equal(tbl, np.asarray(j.block_table(
        [0, 1], max_pages=3)))
    rope = rng.standard_normal((2, 2, 3 * bs, 1, D // 2)).astype(np.float32)
    for lens, dec in (([5, 3], [0, 0]), ([1, 1], [5, 3])):
        if dec != [0, 0]:
            for c in (j, t):
                for i in (0, 1):
                    c.extend(i, 1)
            tbl = np.asarray(t.block_table([0, 1], max_pages=3))
            np.testing.assert_array_equal(tbl, np.asarray(j.block_table(
                [0, 1], max_pages=3)))
        T = sum(lens)
        qkv = (rng.standard_normal((T, (H + 2 * kvH) * D)) * 0.5).astype(
            np.float32)
        cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        common = dict(
            seq_lens_encoder=np.array(lens if dec == [0, 0] else [0, 0],
                                      np.int32),
            seq_lens_decoder=np.array(dec, np.int32),
            seq_lens_this_time=np.array(lens, np.int32),
            padding_offsets=None, cum_offsets=None, cu_seqlens_q=cu,
            cu_seqlens_k=cu, block_tables=tbl, rope_emb=rope, block_size=bs)
        with cpu_place():
            got = TF.block_multihead_attention(
                ptt.to_tensor(qkv), ptt.Tensor._wrap(t.key_cache(0)),
                ptt.Tensor._wrap(t.value_cache(0)),
                **{k: ptt.to_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in common.items()})
        want = JF.block_multihead_attention(
            pt.to_tensor(qkv), pt.Tensor._wrap(j.key_cache(0)),
            pt.Tensor._wrap(j.value_cache(0)),
            **{k: pt.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in common.items()})
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]._data),
                                   rtol=1e-5, atol=1e-5)
        t.update(0, got[2]._data, got[3]._data)
        j.update(0, want[2]._data, want[3]._data)
        np.testing.assert_allclose(t.key_cache(0).numpy(),
                                   np.asarray(j.key_cache(0)), rtol=0,
                                   atol=1e-6)
    # a copy-on-write in the block layout copies whole blocks
    for c in (j, t):
        c.commit_prefix(0, np.concatenate([toks[0], [1]]).astype(np.int32))
        c.add_sequence("s", 5, tokens=np.concatenate(
            [toks[0][:4], [7]]).astype(np.int32))
        c.ensure_writable("s", 0)
    assert t.pages("s") == j.pages("s")
    np.testing.assert_allclose(t.key_cache(0).numpy(),
                               np.asarray(j.key_cache(0)), rtol=0, atol=1e-6)
