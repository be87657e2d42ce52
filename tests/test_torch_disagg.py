"""paddle_tpu_torch's DisaggRouter against paddle_tpu's: twin fleets
(in-process prefill and decode replicas on twin tiny GPTs with the same
f32 weights) serve the same requests.

Held exactly: the handoff counts by path (migrated / readmitted /
fallback), the migrated page count, the role pools, the routing count,
and the greedy tokens (also equal to one role-less port engine's), on
the migrated rung, the re-admission rung, a `disagg.migrate` fault that
forces the fallback, a lost decode pool, and migrated pages evicted
before re-admission. Every pool reconciles (no leaked page)."""
import numpy as np
import pytest

import paddle_tpu.resilience.faults as jax_faults
import paddle_tpu_torch.resilience.faults as port_faults
from paddle_tpu.inference import DisaggRouter as JaxDisagg
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu_torch.inference import (DisaggActuator, DisaggRouter,
                                        LLMEngine, ReplicaGone)
from paddle_tpu_torch.inference.disagg import process_role
from torch_fleet_cases import ENGINE_KW, prompts, reconciled, serve
from torch_port_helpers import twin_gpts

N_NEW = 12
FAULTS = {"ref": jax_faults, "port": port_faults}


@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


@pytest.fixture(autouse=True)
def _clean():
    for f in FAULTS.values():
        f.clear_all()
    yield
    for f in FAULTS.values():
        f.clear_all()


def _make(side, gpts, **kw):
    jm, tm = gpts
    kw = dict(ENGINE_KW, **kw)
    if side == "ref":
        return lambda _i: JaxEngine(jm, **kw)
    return lambda _i: LLMEngine(tm, device="cpu", **kw)


def _drive(router, ps, n_new=N_NEW):
    for i, p in enumerate(ps):
        router.submit(i, p, max_new_tokens=n_new)
    got = {}
    while router.has_unfinished:
        for r in router.step():
            assert r.ok, (r.request_id, r.finish_reason, r.error)
            got[r.request_id] = tuple(int(t) for t in r.output_ids)
    return got


def _twins(gpts, ps, setup=None, **router_kw):
    """{side: (tokens, stats, role pools, router)} of both packages."""
    out = {}
    for side, cls in (("ref", JaxDisagg), ("port", DisaggRouter)):
        router = cls(_make(side, gpts), **router_kw)
        if setup is not None:
            setup(side, router)
        got = _drive(router, ps)
        pools = [(h.name, h.role, h.live) for h in router.replicas]
        assert all(reconciled(h.engine) for h in router.replicas
                   if h.engine is not None)
        out[side] = (got, dict(router.stats), pools, router)
    return out


def _page_bytes(engine):
    c = engine.cache
    return 2 * c.num_layers * c.block_size * c.kv_heads * c.head_dim * \
        c.key_caches[0].element_size()


def _check(out, gpts, ps):
    (tg, ts, tp, tr), (rg, rs, rp, _r) = out["port"], out["ref"]
    assert tg == rg
    assert ts == rs
    assert tp == rp
    want = serve(_make("port", gpts)(0), ps, N_NEW)
    assert tg == want
    return ts, tr


def test_migrated_rung_twins(gpts):
    ps = prompts((37, 20, 45, 33, 52), seed=0)
    out = _twins(gpts, ps, n_prefill=1, n_decode=1)
    s, router = _check(out, gpts, ps)
    assert s["handoffs"] == s["handoff_migrated"] == len(ps)
    assert s["routed"] == 2 * len(ps)
    pages = sum(len(router.replicas.handles[0].engine.cache.block_hashes(p))
                for p in ps)
    assert s["migrated_bytes"] == pages * _page_bytes(
        router.replicas.handles[0].engine)


def test_readmission_rung_twins(gpts):
    ps = prompts((37, 20, 45, 33), seed=0)
    s, _r = _check(_twins(gpts, ps, migrate=False, n_prefill=1,
                          n_decode=1), gpts, ps)
    assert s["handoff_readmitted"] == s["handoffs"] == len(ps)
    assert s["migrated_bytes"] == 0


def test_migrate_fault_forces_fallback_twins(gpts):
    """`disagg.migrate` raising on each chunk: every handoff falls back
    to re-admission, and the tokens do not change."""
    ps = prompts((37, 45, 33), seed=2)

    def arm(side, _router):
        FAULTS[side].inject("disagg.migrate", exc=RuntimeError("chaos"))
    s, _r = _check(_twins(gpts, ps, setup=arm, n_prefill=1, n_decode=1),
                   gpts, ps)
    assert s["handoff_fallback"] == s["handoffs"] == len(ps)
    assert s["migrated_bytes"] == 0


def test_decode_pool_lost_degrades_twins(gpts):
    ps = prompts((37, 33), seed=1)

    def retire_decode(_side, router):
        (h,) = router.pool("decode")
        assert router.retire_replica(h.name) == h.name
    s, _r = _check(_twins(gpts, ps, setup=retire_decode, n_prefill=1,
                          n_decode=1), gpts, ps)
    assert s["handoffs"] == len(ps) and s["retired"] == 1


def test_evicted_before_readmission_falls_back_twins(gpts):
    """Migrated pages churned out of the receiving pool before the
    re-admission: the engine re-prefills the tail, with the reference's
    integer outcome and tokens."""
    p = prompts((65,), seed=4)[0]
    churn = prompts((65, 65, 65), seed=7)
    got = {}
    for side in ("ref", "port"):
        src = _make(side, gpts)(0)
        dst = _make(side, gpts, num_blocks=12)(1)
        serve(src, [p], 2)
        hashes = src.cache.block_hashes(p)
        assert dst.import_kv_pages(src.export_kv_pages(hashes)) == 4
        serve(dst, churn, 2)
        ncached, _pages = dst.cache.match_prefix(p, hashes)
        assert ncached < len(hashes) * 16
        toks = serve(dst, [p], 6, prefix_hashes=hashes)[0]
        got[side] = (ncached, toks, dst.stats["prefix_cache_hit_tokens"],
                     reconciled(dst))
    assert got["port"] == got["ref"] and got["port"][3]


def test_role_aware_scaling(gpts):
    router = DisaggRouter(_make("port", gpts), n_prefill=1, n_decode=1,
                          cooldown_s=0.0)
    act = DisaggActuator(router)
    act.grow_for({"series": "paddle_tpu_request_ttft_seconds"})
    act.grow_for({"series": "paddle_tpu_request_tpot_seconds"})
    assert len(router.pool("prefill")) == len(router.pool("decode")) == 2
    assert act.retire() is not None and act.retire() is not None
    assert act.retire() is None         # both pools at 1: refuse
    (h,) = router.pool("prefill")
    router._fail_replica(h, ReplicaGone("chaos"))
    router.step()                       # cooldown 0: reintegrate
    assert h.live and h.role == "prefill"
    assert process_role("decode") == "engine_decode"
