"""paddle_tpu_torch's Router against paddle_tpu's: twin fleets (three
in-process engine replicas each, on twin tiny GPTs with the same f32
weights) serve the same request stream under the same injected faults,
with an injected clock in both router modules (`FakeClock`: every read
advances it 1 ms, a fault moves it on), so no decision depends on wall
time.

Held exactly, step by step: every routing assignment (or shed), every
replica's breaker state (state, backoff, trips, probation), the finish
reasons and shed reasons, the router's counters, and the greedy tokens
(also equal to one never-killed port engine's); survivors leak no pool
block."""
import numpy as np
import pytest

import paddle_tpu.inference.router as jax_router
import paddle_tpu.resilience.faults as jax_faults
import paddle_tpu_torch.inference.router as port_router
import paddle_tpu_torch.resilience.faults as port_faults
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu_torch.inference import LLMEngine
from torch_fleet_cases import (ENGINE_KW, FakeClock, reconciled, serve,
                               session_prompts)
from torch_port_helpers import twin_gpts

SIDES = {"ref": (jax_router, jax_faults), "port": (port_router, port_faults)}


@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


@pytest.fixture(autouse=True)
def _clean():
    for _r, f in SIDES.values():
        f.clear_all()
    yield
    for _r, f in SIDES.values():
        f.clear_all()


def _factory(side, gpts):
    jm, tm = gpts
    if side == "ref":
        return lambda _i: JaxEngine(jm, **ENGINE_KW)
    return lambda _i: LLMEngine(tm, device="cpu", **ENGINE_KW)


def _breakers(router):
    return [(h.name, h.state, round(h.cooldown_s, 9), h.trips,
             h.probation_left) for h in router.replicas]


def _run(side, gpts, monkeypatch, waves, router_kw, arm=None):
    """Serve `waves` (lists of (rid, session, prompt)), one wave after
    the previous drained; returns the per-step record."""
    mod, faults = SIDES[side]
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    router = mod.Router(_factory(side, gpts), n_replicas=3, **router_kw)
    if arm is not None:
        arm(faults, clock)
    rec = dict(assign=[], breakers=[], results={})
    for wave in waves:
        for rid, session, p in wave:
            router.submit(rid, p, max_new_tokens=6, session_id=session)
            h = router._owner.get(rid)
            rec["assign"].append((rid, h.name if h is not None else None))
        while router.has_unfinished:
            for r in router.step():
                rec["results"][r.request_id] = (
                    r.finish_reason, (r.error or "").split(":")[0],
                    tuple(int(t) for t in r.output_ids))
            rec["breakers"].append(_breakers(router))
    rec["stats"] = dict(router.stats)
    rec["leaks"] = [h.name for h in router.replicas
                    if h.engine is not None and not reconciled(h.engine)]
    monkeypatch.undo()
    return rec


def _waves():
    turns = session_prompts(3, 3, 33, seed=5)
    return [[(f"s{s}t{t}", s, p) for s, tt, p in turns if tt == t]
            for t in range(3)]


def _kill_and_slow(faults, clock):
    """replica-1's process vanishes at its 2nd step; replica-2's 4th
    step takes 2 s of the clock (past unhealthy_step_s). That step
    builds no executable in the reference's engine: the router exempts
    a step that compiled from the check, and the port's CPU engine
    captures no graph, so only such a step is held the same way on both
    sides."""
    seen = {"replica-1": 0, "replica-2": 0}

    def nth(name, n, then=None):
        def when(ctx):
            if ctx.get("replica") != name:
                return False
            seen[name] += 1
            return seen[name] == n and (then is None or then())
        return when
    kill = SIDES["port"][0].ReplicaGone if faults is port_faults \
        else SIDES["ref"][0].ReplicaGone
    faults.inject("router.replica.step", exc=kill("chaos kill"),
                  when=nth("replica-1", 2))
    # a second spec on the same point would replace the first, so the
    # slow step rides the same predicate chain through a wrapper
    spec = faults._ACTIVE["router.replica.step"]
    kill_when = spec.when
    slow_when = nth("replica-2", 4, then=lambda: clock.jump(2.0))

    def either(ctx):
        if kill_when(ctx):
            spec.exc, spec.delay = kill("chaos kill"), None
            return True
        if slow_when(ctx):
            spec.exc, spec.delay = None, 1e-6
            return True
        return False
    spec.when = either


def test_failover_and_quarantine_twins(gpts, monkeypatch):
    kw = dict(cooldown_s=0.02, probation_steps=2, unhealthy_step_s=0.5)
    waves = _waves()
    ref = _run("ref", gpts, monkeypatch, waves, kw, arm=_kill_and_slow)
    port = _run("port", gpts, monkeypatch, waves, kw, arm=_kill_and_slow)
    assert port["assign"] == ref["assign"]
    assert port["breakers"] == ref["breakers"]
    assert port["results"] == ref["results"]
    assert port["stats"] == ref["stats"]
    # the scenario did what it is meant to: one kill, one slow step,
    # re-serves, a reintegration through probation, affinity hits
    s = port["stats"]
    assert s["failovers"] == 2 and s["reroutes"] >= 1
    assert s["affinity_hit_tokens"] > 0
    states = {st for step in port["breakers"] for _n, st, *_ in step}
    assert {"healthy", "dead", "probation"} <= states
    assert not port["leaks"] and not ref["leaks"]
    # every request finished with the tokens one never-killed engine gives
    single = LLMEngine(gpts[1], device="cpu", **ENGINE_KW)
    flat = [x for w in waves for x in w]
    want = serve(single, [p for _r, _s, p in flat], 6)
    for i, (rid, _s, _p) in enumerate(flat):
        reason, _e, toks = port["results"][rid]
        assert reason == "length" and toks == want[i]


def test_shedding_twins(gpts, monkeypatch):
    """A burst over max_inflight sheds "capacity"; with an SLO on
    estimated TTFT (backlog x the service-time EMA, on the injected
    clock) later admissions shed "slo". The shed decisions and every
    routing equal the reference's."""
    rng = np.random.default_rng(9)
    burst = [(f"b{i}", None, rng.integers(0, 1024, (int(n),)).astype(
        np.int32)) for i, n in enumerate(rng.integers(5, 30, 14))]
    kw = dict(max_inflight=2, slo_ttft_s=0.02)
    # the first wave meets no service-time estimate yet: 6 of its 8 fit
    # under max_inflight x 3 replicas; the second meets the EMA
    waves = [burst[:8], burst[8:]]
    ref = _run("ref", gpts, monkeypatch, waves, kw)
    port = _run("port", gpts, monkeypatch, waves, kw)
    assert port["assign"] == ref["assign"]
    assert port["results"] == ref["results"]
    assert port["stats"] == ref["stats"]
    reasons = [e for _f, e, _t in port["results"].values()]
    assert reasons.count("capacity") >= 1 and reasons.count("slo") >= 1
    assert not port["leaks"]
