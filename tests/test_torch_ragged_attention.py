"""paddle_tpu_torch ragged paged attention against paddle_tpu's.

The port's plain PyTorch version is held to paddle_tpu's jnp reference
and to its Pallas kernel in interpret mode on the same numpy inputs
(the `_mixed_case` packings of tests/test_ragged_attention.py). The
kernels' plan (ragged_plan) is held to the reference's masks, and a
tile-by-tile walk of it in plain torch, the way the sm90 kernel walks
it, to both references; the engine builds one plan a packed wave. The
CUDA kernels themselves are held to the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_ragged_attention import _mixed_case
from paddle_tpu.kernels.pallas import ragged_paged_attention as jra
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.ragged_paged_attention import (
    _prep_operands, _shape_reject_reason, ragged_attention_path,
    ragged_paged_attention, ragged_plan)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

# f32 on both sides; XLA and torch sum in different orders, and the
# int8 case carries scores ~100x larger (raw int8 dot products). f16
# q/k/v (and pools) are held to the same limits: both sides round q·scale
# and p to f16 in the reference's cast order and sum in f32, so only the
# order of the f32 sums differs (the f16 cases differ by < 1e-6)
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
    # f16 q/k/v over f16 pools, and over int8 pools with dequant scales
    "f16_pool": dict(f16=True, seed=2),
    "f16_int8_pool_dequant": dict(f16=True, int8=True, seed=2),
    "f16_gqa_no_pool": dict(f16=True, H=4, Hk=2, D=128, seed=4),
}


def _as_f16(c):
    """The case with q, k_new, v_new and fp pools in f16."""
    return {k: (v.astype(np.float16) if isinstance(v, np.ndarray)
                and v.dtype == np.float32 and v.ndim == 3 else v)
            for k, v in c.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_paddle_tpu_reference(name):
    spec = dict(CASES[name])
    f16 = spec.pop("f16", False)
    c = _mixed_case(**spec)
    if f16:
        c = _as_f16(c)
    with_pool = not name.endswith("no_pool")
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


# ---------------------------------------------------------------------------
# the plan (ragged_plan) and the sm90 design's walk of it
# ---------------------------------------------------------------------------
def _rows_case(spec, T, NB=96, bs=8, H=4, Hk=2, D=64, seed=0):
    """A packed launch from (cached, new) tokens per row (0 new = an empty
    slot), pages drawn at random, dead padding after the live tokens."""
    rng = np.random.default_rng(seed)
    B = len(spec)
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    c = 0
    for b, (cached, m) in enumerate(spec):
        kv_start[b] = cached
        npg = -(-(cached + m) // bs)
        pages = [free.pop() for _ in range(npg)]
        off[b, pages] = np.arange(npg) * bs
        rows[c:c + m] = b
        pos[c:c + m] = cached + np.arange(m)
        c += m

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.3
    return dict(q=rnd(T, H, D), k_new=rnd(T, Hk, D), v_new=rnd(T, Hk, D),
                kpool=rnd(NB * bs, Hk, D), vpool=rnd(NB * bs, Hk, D),
                rows=rows, pos=pos, kv_start=kv_start, off=off, bs=bs,
                scale=1.0 / np.sqrt(D), kdq=None, vdq=None)


def _shuffle(c, seed=4):
    """Each row's pages over random physical blocks and the rows' packed
    tokens interleaved: no packing or page order may be assumed."""
    c = dict(c)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(c["off"].shape[1])
    c["off"] = np.ascontiguousarray(c["off"][:, perm])
    order = rng.permutation(len(c["rows"]))
    for k in ("rows", "pos", "q", "k_new", "v_new"):
        c[k] = np.ascontiguousarray(c[k][order])
    return c


# row kinds: a fresh prefill of several q tiles, a prefix resume over a
# partial last page, an empty slot, a decode token, a row whose pages
# hold no valid slot yet (cached 0 in a pool wave), a long context
PLAN_CASES = {
    "fresh": (dict(spec=[(0, 150), (0, 70), (0, 0), (0, 33)], T=256),
              False),
    "resume": (dict(spec=[(64, 20), (64, 9), (64, 31)], T=64), True),
    "mixed": (dict(spec=[(0, 150), (37, 70), (0, 0), (29, 1), (0, 5),
                         (130, 9)], T=320), True),
    "gqa": (dict(spec=[(21, 90), (0, 40), (75, 3)], T=160, H=8, Hk=2),
            True),
    "mqa_d128": (dict(spec=[(13, 70), (50, 6)], T=96, H=4, Hk=1, D=128,
                      bs=16), True),
}


def _plan_of(c, with_pool):
    args = [torch.as_tensor(c[k]) for k in ("rows", "pos", "kv_start",
                                            "off")]
    return ragged_plan(*args, c["bs"], with_pool)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_tiles_cover_live_tokens_once(name, shuffle):
    """Every live token lies in exactly one tile of its own row, tiles
    sorted by position and at most _Q_TILE long, covering each row's run
    in order; dead tokens lie only in dead tiles (row -1), once; each
    tile asks for exactly the row's keys at or below its last position;
    slots are ordered by the keys they walk, largest first; a tile
    carries its row's count of leading valid pool slots."""
    kw, with_pool = PLAN_CASES[name]
    c = _rows_case(**kw)
    if shuffle:
        c = _shuffle(c)
    plan = _plan_of(c, with_pool)
    q_tile = rpa._Q_TILE
    rows, pos = c["rows"], c["pos"]
    perm, spos = plan["perm"].numpy(), plan["spos"].numpy()
    tiles = plan["tiles"].numpy()
    T, B = len(rows), c["off"].shape[0]
    assert sorted(perm) == list(range(T))
    np.testing.assert_array_equal(spos, pos[perm])
    assert tiles.shape == (T // q_tile + B + 2, 8)
    seen = np.zeros(T, int)
    pool_keys = (plan["page_cnt"].numpy().sum(1) if with_pool
                 else np.zeros(B, int))
    work = []
    for r, lo, n, kend, rs, cnt, full, z in tiles:
        assert 0 <= n <= q_tile and z == 0
        toks = perm[lo:lo + n]
        seen[toks] += 1
        if r < 0 or n == 0:
            assert (rows[toks] < 0).all() and kend == rs == cnt == full == 0
            work.append(0)
            continue
        assert full == (_leading_valid_slots(c, r) if with_pool else 0)
        mine = np.flatnonzero(rows == r)
        assert (rows[toks] == r).all()
        assert (np.diff(pos[toks]) > 0).all()
        assert cnt == len(mine) and (rows[perm[rs:rs + cnt]] == r).all()
        assert (lo - rs) % q_tile == 0
        assert kend == int((pos[mine] <= pos[toks].max()).sum())
        work.append(pool_keys[r] + kend)
    np.testing.assert_array_equal(seen, np.ones(T, int))
    assert work == sorted(work, reverse=True)


def _leading_valid_slots(c, r):
    """How many of row r's pool slots, its pages taken in start order
    block_size slots each, are valid before the first invalid one."""
    bs, off = c["bs"], c["off"][r]
    n = 0
    for p in np.argsort(np.where(off >= 0, off.astype(np.int64), 2 ** 40),
                        kind="stable"):
        for s in range(bs):
            if off[p] < 0 or off[p] + s >= c["kv_start"][r]:
                return n
            n += 1
    return n


def _masks_from_plan(plan, c, with_pool):
    """(pool_ok, pack_ok) rebuilt from the tiled operands by walking them
    as the sm90 kernel does: each tile's pool key tiles of 64 virtual
    slots (slot i of key tile kt is slot (64 kt + i) % bs of the row's
    (64 kt + i) // bs-th page; a key tile within the row's leading valid
    slots is taken whole, unmasked), then its packed key tiles from the
    row's sorted tokens, masked by position."""
    T, bs = len(c["rows"]), c["bs"]
    NB = c["off"].shape[1]
    perm, spos = plan["perm"].numpy(), plan["spos"].numpy()
    pool_ok = np.zeros((T, NB * bs), bool)
    pack_ok = np.zeros((T, T), bool)
    for r, lo, n, kend, rs, cnt, full, _ in plan["tiles"].numpy():
        if r < 0 or n == 0:
            continue
        toks, qp = perm[lo:lo + n], spos[lo:lo + n]
        if with_pool:
            np_ = int(plan["npages"][r])
            for kt in range(-(-np_ * bs // 64)):
                vs = kt * 64 + np.arange(64)
                jp, s = vs // bs, vs % bs
                jc = np.minimum(jp, NB - 1)
                ok = (jp < np_) & (s < plan["page_cnt"][r, jc].numpy()) \
                    | ((kt + 1) * 64 <= full)
                slots = plan["page_ids"][r, jc].numpy() * bs + s
                pool_ok[np.ix_(toks, slots[ok])] = True
        for kt in range(-(-kend // 64)):
            idx = kt * 64 + np.arange(64)
            u = rs + np.minimum(idx, cnt - 1)
            ok = (idx < cnt)[None, :] & (spos[u][None, :] <= qp[:, None])
            for i, t in enumerate(toks):
                pack_ok[t, perm[u[ok[i]]]] = True
    return pool_ok, pack_ok


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("name", sorted(PLAN_CASES) + ["_mixed_case"])
def test_plan_rebuilds_reference_masks(name, shuffle):
    if name == "_mixed_case":
        c, with_pool = _mixed_case(seed=1), True
    else:
        kw, with_pool = PLAN_CASES[name]
        c = _rows_case(**kw)
    if shuffle:
        c = _shuffle(c)
    plan = _plan_of(c, with_pool)
    got_pool, got_pack = _masks_from_plan(plan, c, with_pool)
    meta = [torch.as_tensor(c[k]) for k in ("rows", "pos", "kv_start",
                                            "off")]
    want_pool, want_pack = rpa._masks_reference(*meta, c["bs"], with_pool)
    jpool, jpack = jra._masks_reference(
        *(jnp.asarray(c[k]) for k in ("rows", "pos", "kv_start", "off")),
        c["bs"], with_pool)
    np.testing.assert_array_equal(got_pack, want_pack.numpy())
    np.testing.assert_array_equal(got_pack, np.asarray(jpack))
    if with_pool:
        np.testing.assert_array_equal(got_pool, want_pool.numpy())
        np.testing.assert_array_equal(got_pool, np.asarray(jpool))


def walk_plan(plan, c, with_pool, round_p=True):
    """The sm90 kernel's arithmetic in plain torch, tile by tile over the
    plan: per q tile and head, key tiles of 64 (the row's pool pages,
    then its sorted packed tokens) masked by their words against the
    rows' positions; S = Q·Kᵀ in f32 with q exact, scaled after the
    product; an online softmax in f32 from a running max of -1e30; P
    rounded to bf16 before P·V when `round_p` (l summed from the f32 p);
    o = acc / l, 0 where l = 0; dead tiles write 0."""
    q, k_new, v_new, kpool, vpool = (torch.as_tensor(c[k]).float() for k in
                                     ("q", "k_new", "v_new", "kpool",
                                      "vpool"))
    T, H, D = q.shape
    rep = H // k_new.shape[1]
    bs, NB = c["bs"], c["off"].shape[1]
    perm, spos = plan["perm"].long(), plan["spos"].long()
    out = torch.full((T, H, D), float("nan"))
    lo_int, hi_int = -2 ** 31, 2 ** 31 - 1
    for r, lo, n, kend, rs, cnt, _, _ in plan["tiles"].tolist():
        if n == 0:
            continue
        toks = perm[lo:lo + n]
        if r < 0:
            out[toks] = 0.0
            continue
        qp = spos[lo:lo + n]
        keys = []
        np_ = int(plan["npages"][r]) if with_pool else 0
        for kt in range(-(-np_ * bs // 64)):
            vs = kt * 64 + torch.arange(64)
            jp, s = vs // bs, vs % bs
            jc = jp.clamp(max=NB - 1)
            ok = (jp < np_) & (s < plan["page_cnt"][r, jc])
            row = (plan["page_ids"][r, jc].long()
                   .clamp(max=kpool.shape[0] // bs - 1) * bs + s)
            keys.append((kpool[row], vpool[row],
                         torch.where(ok, lo_int, hi_int)))
        for kt in range(-(-kend // 64)):
            idx = kt * 64 + torch.arange(64)
            u = rs + idx.clamp(max=cnt - 1)
            keys.append((k_new[perm[u]], v_new[perm[u]],
                         torch.where(idx < cnt, spos[u], hi_int)))
        Q = q[toks]                                          # [n, H, D]
        m = torch.full((n, H), -1e30)
        l = torch.zeros((n, H))
        acc = torch.zeros((n, H, D))
        for K, V, words in keys:
            K = K.repeat_interleave(rep, dim=1)
            V = V.repeat_interleave(rep, dim=1)
            sc = torch.einsum("nhd,khd->nhk", Q, K) * c["scale"]
            ok = (words[None, :] <= qp[:, None])[:, None, :]
            sc = torch.where(ok, sc, float("-inf"))
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(sc - mx[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.bfloat16().float() if round_p else p
            acc = acc * alpha[..., None] + torch.einsum("nhk,khd->nhd", pv, V)
            m = mx
        out[toks] = torch.where(l[..., None] > 0,
                                acc / l.clamp(min=1e-30)[..., None], 0.0)
    return out


@pytest.mark.parametrize("name", sorted(PLAN_CASES) + ["_mixed_case"])
def test_plan_walk_matches_references(name):
    """The walk without rounding equals the port's plain version and
    paddle_tpu's jnp reference in f32 (TOL); with p rounded to bf16, as
    the kernel rounds it, each output moves by at most 2^-9 of the
    largest |v| (the rounding's relative error times the convex weights
    of the values), which is the limit; dead rows are exactly 0."""
    if name == "_mixed_case":
        c, with_pool = _mixed_case(seed=2), True
    else:
        kw, with_pool = PLAN_CASES[name]
        c = _shuffle(_rows_case(**kw))
    plan = _plan_of(c, with_pool)
    want = _torch(c, with_pool).numpy()
    exact = walk_plan(plan, c, with_pool, round_p=False).numpy()
    np.testing.assert_allclose(exact, want, **TOL[False])
    np.testing.assert_allclose(exact, _jax(c, with_pool), **TOL[False])
    rounded = walk_plan(plan, c, with_pool).numpy()
    vmax = max(np.abs(c["v_new"]).max(),
               np.abs(c["vpool"]).max() if with_pool else 0.0)
    assert np.abs(rounded - want).max() <= 2.0 ** -9 * vmax + 1e-6
    dead = c["rows"] < 0
    assert dead.any()
    np.testing.assert_array_equal(rounded[dead], 0.0)


def test_plan_walk_matches_pallas_interpret():
    """The walk against paddle_tpu's Pallas kernel in interpret mode, on
    a GQA case with a partial last page (row 2: 10 cached tokens in
    pages of 8)."""
    c = _mixed_case(H=8, Hk=2, D=64, seed=6)
    plan = _plan_of(c, True)
    got = walk_plan(plan, c, True, round_p=False).numpy()
    np.testing.assert_allclose(got, _jax(c, path="pallas_interpret"),
                               rtol=2e-4, atol=2e-4)


def test_plan_shape_check_and_plain_path_ignores_plan():
    c = _rows_case(**PLAN_CASES["mixed"][0])
    plan = _plan_of(c, True)
    T, B = len(c["rows"]), c["off"].shape[0]
    NB = c["off"].shape[1]
    rpa._check_plan(plan, T, B, NB, c["bs"], True, torch.device("cpu"))
    for bad in ((T + 8, B, NB, c["bs"], True), (T, B, NB, c["bs"], False),
                (T, B, NB, 16, True), (T, B, NB + 1, c["bs"], True)):
        with pytest.raises(ValueError, match="plan was built for"):
            rpa._check_plan(plan, *bad, torch.device("cpu"))
    # the plain version takes the plan and ignores it
    other = _plan_of(_rows_case(spec=[(3, 4)], T=8), True)
    got = ragged_paged_attention(
        *(torch.as_tensor(c[k]) for k in _ARR), block_size=c["bs"],
        scale=c["scale"], _plan=other)
    np.testing.assert_array_equal(got.numpy(), _torch(c).numpy())


def test_design_picker():
    """sm90 for bf16 or f16 q over pools of its dtype at head_dim 64 / 128
    with 16-byte aligned token rows and no dequant scales; the simple
    design for every other kind (f16 over int8 pools among them);
    forcing sm90 where it does not apply, or an unknown design, raises."""
    bf, f16, f32, i8 = torch.bfloat16, torch.float16, torch.float32, \
        torch.int8
    pick = rpa._rpa_design
    assert pick(bf, bf, 128, True) == "sm90"
    assert pick(bf, None, 64, True) == "sm90"
    assert pick(f16, f16, 128, True) == "sm90"
    assert pick(f16, None, 64, True) == "sm90"
    for args, kw in (((f32, f32, 128, True), {}), ((bf, i8, 128, True), {}),
                     ((bf, bf, 256, True), {}), ((bf, bf, 128, False), {}),
                     ((bf, bf, 128, True), dict(dequant=True)),
                     ((f16, i8, 128, True), {}), ((f16, bf, 128, True), {}),
                     ((f16, f16, 256, True), {})):
        assert pick(*args, **kw) == "simple"
        with pytest.raises(ValueError, match="sm90 design takes"):
            pick(*args, design="sm90", **kw)
        assert pick(*args, design="simple", **kw) == "simple"
    with pytest.raises(ValueError, match="unknown B3 design"):
        pick(bf, bf, 128, True, design="fast")


def test_engine_builds_one_plan_per_wave():
    """LLMEngine builds the plan once per packed wave, before its layer
    loop, and every layer's call takes it: on a 2-layer CPU model, plan
    builds == waves and plain calls == waves x layers."""
    cfg = gpt_tiny()
    model = GPTForCausalLM(cfg, device="cpu", seed=0)
    eng = LLMEngine(model, max_batch=2, block_size=16, max_model_len=64,
                    prompt_quantum=16, decode_chunk=2, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (16,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    (n,))]).astype(np.int32)
               for n in (5, 3, 7)]
    rpa.reset_counters()
    eng.generate(prompts, max_new_tokens=3)
    f = ragged_paged_attention
    waves = eng.stats["ragged_launches"]
    assert waves >= 2 and eng.stats["prefix_cache_hit_tokens"] > 0
    assert f.plan_builds == waves
    assert f.plain_calls == waves * cfg.num_layers
    assert f.kernel_launches == 0
