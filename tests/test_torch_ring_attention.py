"""Ring attention (paddle_tpu_torch.distributed.meta_parallel.
ring_attention, ROADMAP item 26b) against the reference's:
tests/test_ring_attention.py's cases, on an 8-rank sequence axis.

The port's single controller walks the ring as a loop over the 8 chunks
with the reference's online-softmax update; the reference runs it under
``shard_map`` over 8 host devices. Outputs equal a float64 dense
attention within 2e-4, the reference case's tolerance, and the
reference's causal ring within rtol = atol = 1e-5 (f32; the two sum the
blocks in other orders).
The two ``slow`` cases stay ``slow``, as the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed.meta_parallel import \
    ring_flash_attention as jring
from paddle_tpu.distributed.meta_parallel.ring_attention import \
    ring_attention_impl as jring_impl
from paddle_tpu_torch.distributed.meta_parallel import ring_flash_attention
from paddle_tpu_torch.distributed.meta_parallel.ring_attention import (
    ring_attention_impl)
from paddle_tpu_torch.distributed.topology import RankMesh, placement
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _mesh(n=8, axis="sep"):
    return RankMesh(np.arange(n), (axis,))


def _jmesh(n=8, axis="sep"):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _dense_ref(q, k, v, causal):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        qpos = np.arange(s.shape[-2])[:, None]
        kpos = np.arange(s.shape[-1])[None, :]
        s = np.where(qpos >= kpos, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bhqd", p, v.astype(np.float64))
    return np.swapaxes(o, 1, 2)


def _qkv(b=2, s=64, h=2, d=16):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


_REF = {}


def _reference(causal):
    """The reference's ring on `_qkv()` (one shard_map compile each)."""
    if causal not in _REF:
        _REF[causal] = jring(*_qkv(), _jmesh(), causal=causal)
    return _REF[causal]


@pytest.mark.parametrize("causal", [False, True])
def test_matches_dense(causal):
    """Both masks against the float64 dense attention (the reference
    case's check); the causal one against the reference's ring too (one
    shard_map compile a mask: the other is not repeated)."""
    q, k, v = _qkv()
    out = ring_flash_attention(q, k, v, _mesh(), causal=causal)
    np.testing.assert_allclose(np.asarray(out), _dense_ref(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)
    if causal:
        np.testing.assert_allclose(np.asarray(out),
                                   np.asarray(_reference(causal)), **TOL)


@pytest.mark.slow  # as the reference's: >25 s there
def test_gradients_match_dense(causal=True):
    rng = np.random.default_rng(1)
    b, s, h, d = 1, 32, 2, 8
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrs)
    (ring_attention_impl(q, k, v, _mesh(), causal=True) ** 2).sum() \
        .backward()
    mesh = _jmesh()

    def ring_loss(q, k, v):
        return (jring_impl(q, k, v, mesh, causal=True)
                .astype(jnp.float32) ** 2).sum()

    want = jax.grad(ring_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrs))
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_output_stays_sequence_sharded():
    out = ring_flash_attention(*_qkv(), _mesh(), causal=True)
    assert placement(out).spec == tuple(
        _reference(True)._data.sharding.spec)
    assert "sep" in str(out._dist_attr)


def test_tensor_api_and_uneven_raises():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
    out = ring_flash_attention(ptt.to_tensor(a), ptt.to_tensor(a),
                               ptt.to_tensor(a), _mesh(), causal=True)
    assert out.shape == [1, 64, 2, 8]
    bad = ptt.to_tensor(rng.standard_normal((1, 60, 2, 8))
                        .astype(np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        ring_flash_attention(bad, bad, bad, _mesh())
    jbad = pt.to_tensor(bad.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        jring(jbad, jbad, jbad, _jmesh())


@pytest.mark.slow  # as the reference's: >25 s there
def test_eager_tape_backward():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    grads = []
    for P, mesh in ((ptt, _mesh()), (pt, _jmesh())):
        ring = ring_flash_attention if P is ptt else jring
        x = P.to_tensor(a, stop_gradient=False)
        out = ring(x, x, x, mesh, causal=True)
        assert not out.stop_gradient
        (out ** 2).sum().backward()
        assert x.grad is not None
        grads.append(x.grad.numpy())
    assert np.count_nonzero(grads[0]) > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-5)
