"""incubate's serving functionals and FusedMultiTransformer against the
reference's on the CPU: masked_multihead_attention (f32 and int8 caches,
rotary, as tests/test_kv_int8.py pins them), block_multihead_attention
(a prefill wave and a decode wave over paged caches, int8 pages),
variable_length_memory_efficient_attention, and fused_multi_transformer
at 2 layers, d_model 64, 4 heads of 16, FFN 128 (prefill, then decode
steps through the caches, on both packages; the reference's own
invariant that decode equals the full forward).

f32 throughout: outputs within 1e-5 (attention outputs of order 1) or
1e-4 (the transformer stack, whose residual stream reaches order 10);
int8 caches exactly. The port writes caches in place and returns them:
each test holds the returned caches to the reference's returned ones."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu_torch.incubate.nn import functional as TF
from torch_port_helpers import cpu_place, jax_state_numpy


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


def _both(fn_name, *args, **kw):
    """(port result, reference result) of the same numpy arguments, each
    through its package's Tensors."""
    def conv(P, a):
        if isinstance(a, np.ndarray):
            return P.to_tensor(a)
        if isinstance(a, list):
            return [conv(P, x) for x in a]
        return a
    got = getattr(TF, fn_name)(*(conv(ptt, a) for a in args),
                                **{k: conv(ptt, v) for k, v in kw.items()})
    want = getattr(JF, fn_name)(*(conv(pt, a) for a in args),
                                **{k: conv(pt, v) for k, v in kw.items()})
    return got, want


def _scales(x, axis):
    return (127.0 / np.maximum(np.max(np.abs(x), axis=axis), 1e-6) /
            1.2).astype(np.float32)


@pytest.mark.parametrize("variant", ["f32", "int8", "rotary_neox",
                                     "src_mask"])
def test_masked_multihead_attention_matches_reference(variant):
    rng = np.random.default_rng(0)
    B, H, L, D = 3, 4, 32, 16
    t = np.array([5, 9, 0], np.int32)
    cache = (rng.standard_normal((2, B, H, L, D)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, 3 * H * D)) * 0.5).astype(np.float32)
    kw = dict(bias=(rng.standard_normal(3 * H * D) * 0.1).astype(
        np.float32), sequence_lengths=t[:, None])
    if variant == "int8":
        kq, vq = _scales(cache[0], (0, 2, 3)), _scales(cache[1], (0, 2, 3))
        cache = np.stack([
            np.clip(np.round(cache[0] * kq[None, :, None, None]), -127, 127),
            np.clip(np.round(cache[1] * vq[None, :, None, None]), -127,
                    127)]).astype(np.int8)
        kw.update(cache_k_quant_scales=kq, cache_v_quant_scales=vq,
                  quant_round_type=0)
    if variant == "rotary_neox":
        kw.update(rotary_tensor=rng.standard_normal((B, 1, 1, L, D)).astype(
            np.float32), rotary_emb_dims=1, use_neox_rotary_style=True)
    if variant == "src_mask":
        del kw["sequence_lengths"]
        kw["src_mask"] = np.where(rng.random((B, 1, 1, 12)) < 0.3, -1e4,
                                  0.0).astype(np.float32)
    (out, c), (wout, wc) = _both("masked_multihead_attention", x, cache,
                                 **kw)
    assert out.shape == [B, H * D] and c.dtype == ptt.to_tensor(cache).dtype
    np.testing.assert_allclose(out.numpy(), _np(wout), rtol=1e-5, atol=1e-5)
    if variant == "int8":
        np.testing.assert_array_equal(c.numpy(), _np(wc))
    else:
        np.testing.assert_allclose(c.numpy(), _np(wc), rtol=0, atol=1e-7)


def test_masked_multihead_attention_refuses_a_full_cache():
    c = np.zeros((2, 1, 2, 4, 8), np.float32)
    with pytest.raises(ValueError, match="cache is full"):
        TF.masked_multihead_attention(
            ptt.to_tensor(np.zeros((1, 48), np.float32)), ptt.to_tensor(c),
            sequence_lengths=ptt.to_tensor(np.array([[4]], np.int32)))
    with pytest.raises(ValueError, match="int8 KV cache"):
        TF.masked_multihead_attention(
            ptt.to_tensor(np.zeros((1, 48), np.float32)), ptt.to_tensor(c),
            sequence_lengths=ptt.to_tensor(np.array([[1]], np.int32)),
            cache_k_quant_scales=ptt.to_tensor(np.ones(2, np.float32)),
            cache_v_quant_scales=ptt.to_tensor(np.ones(2, np.float32)))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_block_multihead_attention_prefill_then_decode(int8):
    """A prefill wave (rows of 5 and 3 tokens, GQA 4/2 heads, rotary)
    then a decode wave of one token a row, the caches carried from each
    package's own returns."""
    rng = np.random.default_rng(1)
    B, kvH, H, D, bs, npb = 2, 2, 4, 16, 4, 3
    nb = B * npb + 1
    dt = np.int8 if int8 else np.float32
    kc, vc = np.zeros((nb, kvH, bs, D), dt), np.zeros((nb, kvH, bs, D), dt)
    tbl = np.arange(B * npb, dtype=np.int32).reshape(B, npb) + 1
    rope = rng.standard_normal((2, B, npb * bs, 1, D // 2)).astype(
        np.float32)
    scales = {}
    if int8:
        scales = dict(cache_k_quant_scales=np.full(kvH, 40.0, np.float32),
                      cache_v_quant_scales=np.full(kvH, 50.0, np.float32))
    caches = {"got": (kc, vc), "want": (kc, vc)}
    for lens, dec in (([5, 3], [0, 0]), ([1, 1], [5, 3])):
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
            cu_seqlens_k=cu, block_tables=tbl, rope_emb=rope, block_size=bs,
            **scales)
        got = TF.block_multihead_attention(
            ptt.to_tensor(qkv), *map(ptt.to_tensor, caches["got"]),
            **{k: ptt.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in common.items()})
        want = JF.block_multihead_attention(
            pt.to_tensor(qkv), *map(pt.to_tensor, caches["want"]),
            **{k: pt.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in common.items()})
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-5,
                                   atol=1e-5)
        for g, w in zip(got[2:], want[2:]):
            if int8:
                np.testing.assert_array_equal(g.numpy(), _np(w))
            else:
                np.testing.assert_allclose(g.numpy(), _np(w), rtol=0,
                                           atol=1e-6)
        caches = {"got": tuple(g.numpy() for g in got[2:]),
                  "want": tuple(_np(w) for w in want[2:])}


@pytest.mark.parametrize("causal", [False, True])
def test_variable_length_attention_matches_reference(causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 7, 8)).astype(np.float32)
    got, want = _both("variable_length_memory_efficient_attention", q, k, v,
                      np.array([4, 6], np.int32), np.array([7, 5], np.int32),
                      mask=rng.standard_normal((2, 1, 6, 7)).astype(
                          np.float32), causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fused_multi_transformer and FusedMultiTransformer
# ---------------------------------------------------------------------------
NL, DM, NH, HD, FFN = 2, 64, 4, 16, 128


def _weights(seed=0, trans_qkvw=True):
    rng = np.random.default_rng(seed)
    g = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    qkv = (3, NH, HD, DM) if trans_qkvw else (DM, 3, NH, HD)
    return dict(
        ln_scales=[1 + g(DM) for _ in range(NL)],
        ln_biases=[g(DM) for _ in range(NL)],
        qkv_weights=[g(*qkv) for _ in range(NL)],
        qkv_biases=[g(3, NH, HD) for _ in range(NL)],
        linear_weights=[g(NH * HD, DM) for _ in range(NL)],
        linear_biases=[g(DM) for _ in range(NL)],
        ffn_ln_scales=[1 + g(DM) for _ in range(NL)],
        ffn_ln_biases=[g(DM) for _ in range(NL)],
        ffn1_weights=[g(DM, FFN) for _ in range(NL)],
        ffn1_biases=[g(FFN) for _ in range(NL)],
        ffn2_weights=[g(FFN, DM) for _ in range(NL)],
        ffn2_biases=[g(DM) for _ in range(NL)])


def _as(P, w):
    return {k: [P.to_tensor(a) for a in v] for k, v in w.items()}


TOL = dict(rtol=1e-4, atol=1e-4)


def _prefill_decode(P, F, w, seq, S, steps, **kw):
    """Prefill seq[:, :S], then `steps` decode steps; the full forward
    of S + steps tokens without caches. Returns (prefill out, decode
    outs, full out, caches) as numpy."""
    B = seq.shape[0]
    full = F.fused_multi_transformer(P.to_tensor(seq[:, :S + steps]), **w,
                                     **kw)
    caches = [P.to_tensor(np.zeros((2, B, NH, S + steps + 3, HD),
                                   np.float32)) for _ in range(NL)]
    out, caches = F.fused_multi_transformer(
        P.to_tensor(seq[:, :S]), cache_kvs=caches, **w, **kw)
    dec = []
    for i in range(steps):
        o, caches = F.fused_multi_transformer(
            P.to_tensor(seq[:, S + i:S + i + 1]), cache_kvs=caches,
            time_step=P.to_tensor(np.asarray(S + i, np.int32)), **w, **kw)
        dec.append(_np(o)[:, 0])
    return _np(out), dec, _np(full), [_np(c) for c in caches]


@pytest.mark.parametrize("variant", ["pre_ln_gelu", "post_ln_relu",
                                     "rotary", "dm_first_qkv"])
def test_fused_multi_transformer_prefill_decode_both_packages(variant):
    """The slice as a whole: a 2-layer stack's prefill and 3 decode steps
    on both packages, each package's decode equal to its own full
    forward (the reference's invariant, tests/test_serving.py:329), and
    the port's prefill, decode steps and caches equal to the
    reference's."""
    trans = variant != "dm_first_qkv"
    w = _weights(3, trans)
    rng = np.random.default_rng(4)
    B, S, steps = 2, 5, 3
    seq = rng.standard_normal((B, S + steps, DM)).astype(np.float32)
    kw = dict(trans_qkvw=trans)
    if variant == "post_ln_relu":
        kw.update(pre_layer_norm=False, activation="relu")
    if variant == "rotary":
        kw.update(rotary_embs=rng.standard_normal(
            (2, B, 1, S + steps + 3, HD)).astype(np.float32),
            rotary_emb_dims=1)
    results = []
    for P, F in ((ptt, TF), (pt, JF)):
        kwp = {k: P.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        out, dec, full, caches = _prefill_decode(P, F, _as(P, w), seq, S,
                                                 steps, **kwp)
        np.testing.assert_allclose(out, full[:, :S], **TOL)
        for i, d in enumerate(dec):
            np.testing.assert_allclose(d, full[:, S + i], **TOL)
        results.append((out, dec, caches))
    (out, dec, caches), (wout, wdec, wcaches) = results
    np.testing.assert_allclose(out, wout, **TOL)
    np.testing.assert_allclose(np.stack(dec), np.stack(wdec), **TOL)
    for c, wc in zip(caches, wcaches):
        np.testing.assert_allclose(c, wc, **TOL)


def test_fused_multi_transformer_mask_and_seq_lens():
    w = _weights(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, DM)).astype(np.float32)
    mask = np.where(np.tril(np.ones((6, 6))) > 0, 0.0, -1e9).astype(
        np.float32)[None, None].repeat(2, 0)
    for kw in (dict(attn_mask=mask), dict(seq_lens=np.array([6, 6],
                                                           np.int32))):
        got = TF.fused_multi_transformer(
            ptt.to_tensor(x), **_as(ptt, w),
            **{k: ptt.to_tensor(v) for k, v in kw.items()})
        want = JF.fused_multi_transformer(
            pt.to_tensor(x), **_as(pt, w),
            **{k: pt.to_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    with pytest.raises(NotImplementedError, match="serving path"):
        TF.fused_multi_transformer(ptt.to_tensor(x), **_as(ptt, w),
                                   dropout_rate=0.1, training=True)


def test_fused_multi_transformer_torch_level_writes_caches_in_place():
    """A torch-level call returns torch tensors, and the caches it
    returns are the tensors it was given, written in place."""
    w = {k: [torch.from_numpy(a) for a in v] for k, v in _weights().items()}
    x = torch.randn(1, 4, DM)
    caches = [torch.zeros(2, 1, NH, 8, HD) for _ in range(NL)]
    out, got = TF.fused_multi_transformer(x, cache_kvs=caches, **w)
    assert type(out) is torch.Tensor
    assert all(g is c for g, c in zip(got, caches))
    assert bool(caches[0][:, :, :, :4].abs().sum() > 0)
    assert bool((caches[0][:, :, :, 4:] == 0).all())


def test_fused_multi_transformer_layer_matches_reference():
    """The Layer from ParamAttrs (a Normal initializer for the weights,
    one attr a layer for the qkv weights), its parameters named and laid
    out as the reference's, then the reference's weights carried in."""
    from paddle_tpu_torch import fused_params_from_numpy
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn.initializer import Normal
    gen = torch.Generator().manual_seed(0)
    tl = ptt.incubate.nn.FusedMultiTransformer(
        DM, NH, FFN, qkv_weight_attrs=[ParamAttr(
            name=f"qkv{i}", initializer=Normal(0.0, 0.02)) for i in range(NL)],
        ffn1_weight_attrs=ParamAttr(initializer=Normal(0.0, 0.02)),
        init_generator=gen, device="cpu")
    pt.seed(0)
    jl = pt.incubate.nn.FusedMultiTransformer(
        DM, NH, FFN, qkv_weight_attrs=[None] * NL)
    named = jax_state_numpy(jl)
    assert list(tl.state_dict()) == list(named)
    assert [p.name for p in tl.qkv_weights] == ["qkv0", "qkv1"]
    std = float(tl.ffn1_weight_0._data.detach().std())
    assert 0.015 < std < 0.025
    tl.load_state_dict(fused_params_from_numpy(named))
    tl.eval()
    jl.eval()
    x = np.random.default_rng(7).standard_normal((2, 5, DM)).astype(
        np.float32)
    got = tl(ptt.to_tensor(x))
    assert isinstance(got, ptt.Tensor)
    np.testing.assert_allclose(got.numpy(), _np(jl(pt.to_tensor(x))), **TOL)
