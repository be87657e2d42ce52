"""paddle_tpu_torch ragged paged attention against paddle_tpu's.

The port's plain PyTorch version is held to paddle_tpu's jnp reference
and to its Pallas kernel in interpret mode on the same numpy inputs
(the `_mixed_case` packings of tests/test_ragged_attention.py); the
CUDA kernel's operand prep is held to the reference's masks. The CUDA
kernel itself is held to the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_ragged_attention import _mixed_case
from paddle_tpu.kernels.pallas import ragged_paged_attention as jra
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    _prep_operands, _shape_reject_reason, ragged_attention_path,
    ragged_paged_attention)

# f32 on both sides; XLA and torch sum in different orders, and the
# int8 case carries scores ~100x larger (raw int8 dot products)
TOL = {False: dict(rtol=1e-5, atol=1e-5), True: dict(rtol=1e-5, atol=5e-5)}

_ARR = ("q", "k_new", "v_new", "kpool", "vpool", "rows", "pos",
        "kv_start", "off")


def _jax(c, with_pool=True, path="jnp"):
    return np.asarray(jra.ragged_paged_attention(
        *(jnp.asarray(c[k]) for k in _ARR), block_size=c["bs"],
        scale=c["scale"],
        kdq=None if c["kdq"] is None else jnp.asarray(c["kdq"]),
        vdq=None if c["vdq"] is None else jnp.asarray(c["vdq"]),
        with_pool=with_pool, path=path))


def _torch(c, with_pool=True, device="cpu", path=None):
    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)
    return ragged_paged_attention(
        *(t(c[k]) for k in _ARR), block_size=c["bs"], scale=c["scale"],
        kdq=t(c["kdq"]), vdq=t(c["vdq"]), with_pool=with_pool, path=path)


CASES = {
    "f32_pool": dict(),
    "int8_pool_dequant": dict(int8=True),
    "no_pool": dict(),
    "gqa": dict(H=4, Hk=2, D=128, seed=3),
    "mqa": dict(H=4, Hk=1, D=128, seed=3),
    "dead_rows": dict(T=96, seed=9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_paddle_tpu_reference(name):
    c = _mixed_case(**CASES[name])
    with_pool = name != "no_pool"
    got = _torch(c, with_pool).numpy()
    want = _jax(c, with_pool)
    np.testing.assert_allclose(got, want, **TOL["int8" in name])
    dead = c["rows"] < 0
    assert dead.any()
    np.testing.assert_array_equal(got[dead], 0.0)


def test_plain_matches_pallas_interpret():
    c = _mixed_case(Hk=2, D=128, int8=True, seed=5)
    got = _torch(c).numpy()
    want = _jax(c, path="pallas_interpret")
    # the Pallas walk folds int8 dequant per tile: same tolerance class
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _masks_from_prep(prep, rows, pos, NB, bs, with_pool):
    """Rebuild (pool_ok, pack_ok) from the kernel's compact operands by
    walking them as the CUDA kernel does."""
    rows = rows.numpy()
    pos = pos.numpy()
    T = len(rows)
    pool_ok = np.zeros((T, NB * bs), bool)
    pack_ok = np.zeros((T, T), bool)
    lo, hi = prep["span_lo"].numpy(), prep["span_hi"].numpy()
    for t in range(T):
        r = rows[t]
        if r < 0:
            continue
        if with_pool:
            for j in range(int(prep["npages"][r])):
                pg = int(prep["page_ids"][r, j])
                cnt = int(prep["page_cnt"][r, j])
                pool_ok[t, pg * bs:pg * bs + cnt] = True
        for u in range(lo[r], hi[r] + 1):
            if rows[u] == r and pos[u] <= pos[t]:
                pack_ok[t, u] = True
    return pool_ok, pack_ok


@pytest.mark.parametrize("shuffle", [False, True])
def test_prep_rebuilds_reference_masks(shuffle):
    c = _mixed_case(seed=1)
    if shuffle:
        # scatter each row's pages over random physical blocks and
        # interleave the rows' packed tokens: the prep must not assume
        # the engine's contiguous packing or ordered pages
        rng = np.random.default_rng(4)
        perm = rng.permutation(c["off"].shape[1])
        c["off"] = np.ascontiguousarray(c["off"][:, perm])
        order = rng.permutation(len(c["rows"]))
        c["rows"], c["pos"] = c["rows"][order], c["pos"][order]
    args = [torch.as_tensor(c[k]) for k in ("rows", "pos", "kv_start",
                                            "off")]
    prep = _prep_operands(*args, c["bs"], True)
    got_pool, got_pack = _masks_from_prep(prep, args[0], args[1],
                                          c["off"].shape[1], c["bs"], True)
    want_pool, want_pack = jra._masks_reference(
        *(jnp.asarray(c[k]) for k in ("rows", "pos", "kv_start", "off")),
        c["bs"], True)
    np.testing.assert_array_equal(got_pool, np.asarray(want_pool))
    np.testing.assert_array_equal(got_pack, np.asarray(want_pack))
    # the valid pages of each row come first, in start-position order
    for r in range(c["off"].shape[0]):
        n = int(prep["npages"][r])
        starts = c["off"][r, prep["page_ids"][r, :n].numpy()]
        assert (np.diff(starts) > 0).all()


def test_cpu_tensors_never_touch_kernel_counter():
    c = _mixed_case()
    k0 = ragged_paged_attention.kernel_launches
    p0 = ragged_paged_attention.plain_calls
    _torch(c)
    _torch(c, with_pool=False)
    assert ragged_paged_attention.kernel_launches == k0
    assert ragged_paged_attention.plain_calls == p0 + 2
    # forcing the kernel on CPU tensors raises instead of degrading
    with pytest.raises(ValueError, match="CUDA"):
        _torch(c, path="cuda")
    assert ragged_paged_attention.kernel_launches == k0


def test_path_gating_and_shape_rejects():
    assert ragged_attention_path(64, 64, 4, 2, 128, 8, True,
                                 "cpu")[0] == "torch"
    assert ragged_attention_path(64, 64, 4, 2, 128, 8, True,
                                 "cuda") == ("cuda", "")
    rej = _shape_reject_reason
    assert "head_dim" in rej(64, 64, 4, 2, 96, 8, True)
    assert "divide" in rej(64, 64, 4, 3, 128, 8, True)
    assert "pool length" in rej(64, 60, 4, 2, 128, 8, True)
    assert rej(64, 0, 4, 2, 128, 8, False) is None
    path, why = ragged_attention_path(64, 64, 4, 3, 128, 8, True, "cuda")
    assert path is None and "divide" in why
