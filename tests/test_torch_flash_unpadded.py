"""nn.functional.flash_attn_unpadded (paddle_tpu_torch/nn/functional.py)
against the reference's on the CPU: packed sequences through one batch
row masked by segment ids from cu_seqlens, padding past cu_seqlens[-1]
given -1 (q) and -2 (kv) so that it attends to nothing and outputs 0.

At a packed total that is a multiple of 128 (and head_dim 64) the port
runs B1/B2's plain versions on the CPU (the kernels' path on the card);
otherwise the attention composite, as the reference does. Forward
outputs and the gradients of q, k and v through backward() of a fixed
cotangent are held to the reference's within 1e-5 (rtol = atol; both
sides compute f32 softmax attention, XLA and torch summing in other
orders); padding rows and their gradients are exactly 0. The
reference's own cases (tests/test_flash_attention.py: per-sequence
dense attention; tests/test_advice_r4.py: a short causal packing) are
carried over."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


def _qkv(total_q, total_k, h=2, d=64, seed=17):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, h, d)).astype(np.float32)
            for t in (total_q, total_k, total_k)]


def _run(P, arrays, cu_q, cu_k, **kw):
    ts = [P.to_tensor(a, stop_gradient=False) for a in arrays]
    out, soft = P.nn.functional.flash_attn_unpadded(
        *ts, P.to_tensor(cu_q), P.to_tensor(cu_k), **kw)
    assert soft is None
    cot = np.random.default_rng(5).standard_normal(
        tuple(out.shape)).astype(np.float32)
    (out * P.to_tensor(cot)).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _cu(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


CASES = [
    # (id, q lengths, kv lengths, total q, total kv, causal)
    ("causal_padded_256", [100, 80, 50], None, 256, 256, True),
    ("noncausal_padded_256", [100, 80, 50], None, 256, 256, False),
    ("noncausal_exact_384", [128, 200, 56], None, 384, 384, False),
    ("causal_composite_200", [90, 60, 33], None, 200, 200, True),
    ("cross_lengths_noncausal", [60, 40, 20], [100, 30, 90], 128, 256,
     False),
    ("one_sequence_causal", [128], None, 128, 128, True),
]


@pytest.mark.parametrize("cid,lq,lk,tq,tk,causal", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_attn_unpadded_matches_reference(cid, lq, lk, tq, tk, causal):
    arrays = _qkv(tq, tk)
    cu_q, cu_k = _cu(lq), _cu(lk or lq)
    got = _run(ptt, arrays, cu_q, cu_k, causal=causal)
    want = _run(pt, arrays, cu_q, cu_k, causal=causal)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w, n in zip(got[1], want[1], "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{n}", **TOL)
    # padding: outputs and gradients exactly 0
    out, (dq, dk, dv) = got
    assert not out[cu_q[-1]:].any() and not dq[cu_q[-1]:].any()
    assert not dk[cu_k[-1]:].any() and not dv[cu_k[-1]:].any()


def test_flash_attn_unpadded_takes_the_plain_b1_b2_at_128_multiples():
    """A total that is a multiple of 128 runs B1's and B2's plain
    versions (the kernels' path), one call each; another total runs the
    composite."""
    fa.reset_counters()
    _run(ptt, _qkv(256, 256), _cu([100, 80, 50]), _cu([100, 80, 50]),
         causal=True)
    assert (fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls) == (1, 1)
    fa.reset_counters()
    _run(ptt, _qkv(200, 200), _cu([90, 60]), _cu([90, 60]))
    assert (fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls) == (0, 0)


def test_flash_attn_unpadded_equals_per_sequence_attention():
    """The reference's own case: each sequence's rows equal dense causal
    attention over that sequence alone (tests/test_flash_attention.py's
    rtol = atol = 5e-4)."""
    lens, d = [100, 80, 50], 64
    q, k, v = _qkv(256, 256)
    cu = _cu(lens)
    out, _ = ptt.nn.functional.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in (q, k, v)), cu, cu, causal=True)
    for i in range(len(lens)):
        s0, s1 = cu[i], cu[i + 1]
        ref = fa._xla_attention(
            *(torch.from_numpy(a[None, s0:s1]) for a in (q, k, v)), None,
            True, 1.0 / np.sqrt(d))[0]
        np.testing.assert_allclose(out[s0:s1].numpy(), ref.numpy(),
                                   rtol=5e-4, atol=5e-4)


def test_flash_attn_unpadded_short_packing():
    """tests/test_advice_r4.py's case: 8 packed rows, causal, head_dim 4
    (the composite path), against the reference."""
    q = np.random.default_rng(0).standard_normal((8, 2, 4)).astype(
        np.float32)
    cu = np.array([0, 5, 8], np.int32)
    got = _run(ptt, [q, q, q], cu, cu, max_seqlen_q=8, max_seqlen_k=8,
               causal=True)
    want = _run(pt, [q, q, q], cu, cu, max_seqlen_q=8, max_seqlen_k=8,
                causal=True)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **TOL)


def test_flash_attn_unpadded_scale():
    arrays = _qkv(256, 256)
    cu = _cu([120, 100])
    got = _run(ptt, arrays, cu, cu, scale=0.3)
    want = _run(pt, arrays, cu, cu, scale=0.3)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert not np.allclose(got[0], _run(ptt, arrays, cu, cu)[0], atol=1e-3)


@pytest.mark.parametrize("cu_k", [[0, 50, 90, 110], [0, 50, 90]],
                         ids=["other_offsets", "other_count"])
def test_flash_attn_unpadded_causal_needs_equal_packings(cu_k):
    q, k, v = _qkv(128, 128)
    cu_q = np.array([0, 50, 90, 111], np.int32)
    for P in (pt, ptt):
        with pytest.raises(NotImplementedError, match="identical"):
            P.nn.functional.flash_attn_unpadded(
                P.to_tensor(q), P.to_tensor(k), P.to_tensor(v),
                P.to_tensor(cu_q), P.to_tensor(np.array(cu_k, np.int32)),
                causal=True)


def test_flash_attn_unpadded_segment_ids():
    """The ids the packing gives: the sequence index, -1 for q padding
    and -2 for kv padding, so that padding matches nothing."""
    from paddle_tpu_torch.nn.functional import _segments_of
    seg = _segments_of(np.array([0, 3, 5], np.int32), 8, "cpu")
    assert seg.tolist() == [0, 0, 0, 1, 1, -1, -1, -1]
    seen = {}
    real = ptt.incubate.nn.functional.fused_flash_attention

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    import paddle_tpu_torch.incubate.nn.functional as inf
    inf.fused_flash_attention = spy
    try:
        q, k, v = (torch.from_numpy(a) for a in _qkv(128, 128))
        ptt.nn.functional.flash_attn_unpadded(
            q, k, v, np.array([0, 100], np.int32),
            np.array([0, 60, 120], np.int32))
    finally:
        inf.fused_flash_attention = real
    q_seg, kv_seg = seen["segment_ids"]
    assert q_seg.shape == kv_seg.shape == (1, 128)
    assert (q_seg[0, 100:] == -1).all() and (q_seg[0, :100] == 0).all()
    assert (kv_seg[0, 120:] == -2).all() and (kv_seg[0, 60:120] == 1).all()


def test_flash_attn_unpadded_torch_and_tensor_calls_agree():
    arrays = _qkv(256, 256)
    cu = _cu([100, 80, 50])
    out_t, _ = ptt.nn.functional.flash_attn_unpadded(
        *(ptt.to_tensor(a) for a in arrays), ptt.to_tensor(cu),
        ptt.to_tensor(cu), causal=True)
    out, _ = ptt.nn.functional.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(cu),
        torch.from_numpy(cu), causal=True)
    assert type(out) is torch.Tensor and torch.equal(out, out_t._data)
