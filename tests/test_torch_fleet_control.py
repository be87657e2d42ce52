"""The fleet's control plane in paddle_tpu_torch against paddle_tpu's:
`TrafficModel` events (exactly equal for three seeds), the
`FleetSLOMonitor` over process-labeled histograms, and the `Autoscaler`
on scripted monitors (the reference's tests/test_slo_control_plane.py
scripts): the decisions, the journal (timestamps aside) and the
actuations equal the reference's, with exactly one flight bundle per
committed decision. Then an `Autoscaler` with a `RouterActuator` over a
real port Router grows it on a breach and retires a replica when calm,
and the reference's elastic-router cases (grow, retire mid-flight,
pre-provisioned engines, replica-seconds, process-like shutdown,
concurrent stepping only for `concurrent_step_safe` engines) run on the
port."""
import json
import os

import numpy as np
import pytest

import paddle_tpu.inference as jinf
import paddle_tpu.observability as jobs
import paddle_tpu_torch.inference as tinf
import paddle_tpu_torch.observability as tobs
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import metrics as jom
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import slo_fleet as jslo_fleet
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import metrics as tom
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import slo_fleet as tslo_fleet
from torch_fleet_cases import ENGINE_KW

SIDES = {
    "ref": dict(inf=jinf, obs=jobs, om=jom, slo=jslo, fleet=jslo_fleet,
                flight=jflight),
    "port": dict(inf=tinf, obs=tobs, om=tom, slo=tslo, fleet=tslo_fleet,
                 flight=tflight),
}


@pytest.fixture(autouse=True)
def _clean():
    for s in SIDES.values():
        s["obs"].disable()
        s["obs"].reset()
        s["flight"].disarm()
    yield
    for s in SIDES.values():
        s["flight"].disarm()
        s["obs"].disable()
        s["obs"].reset()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_traffic_events_equal_the_reference(seed):
    kw = dict(seed=seed, base_rate=3.0, burst_rate=30.0, off_s=2.0,
              on_s=1.5, max_body=768, max_out=64)
    want = list(jinf.TrafficModel(**kw).events(60))
    got = list(tinf.TrafficModel(**kw).events(60))
    assert len(got) == len(want) == 60
    for a, b in zip(got, want):
        assert (a.t, a.rid, a.session, a.cohort, a.turn, a.max_new) == \
            (b.t, b.rid, b.session, b.cohort, b.turn, b.max_new)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == np.int32
    assert len({e.session for e in got}) < len(got)     # sessions recur


def _monitor_run(side, tmp_path):
    s = SIDES[side]
    s["obs"].enable()
    s["flight"].arm(str(tmp_path / side))
    reg = s["om"].MetricsRegistry()
    h = reg.histogram("paddle_tpu_request_ttft_seconds", "test ttft",
                      ("process",))
    rule = s["slo"].SLO("ttft_p95", "paddle_tpu_request_ttft_seconds",
                        threshold_s=0.5, objective=0.9)
    mon = s["fleet"].FleetSLOMonitor(registry=reg, rules=[rule],
                                     min_count=2)
    out = []
    # windows: a breach (slow process), the same breach again (one
    # episode), a clean window, a thin window, a new breach
    for fast, slow in ((40, 40), (10, 30), (50, 0), (1, 0), (5, 20)):
        for _ in range(fast):
            h.labels(process="fast").observe(0.01)
        for _ in range(slow):
            h.labels(process="slow").observe(2.0)
        (res,) = mon.evaluate()
        out.append((res.ok, res.attained, res.count, res.missing,
                    dict(res.per_process), res.worst_process))
    bundles = len(s["flight"].bundles(str(tmp_path / side)))
    return out, bundles


def test_fleet_slo_monitor_equals_the_reference(tmp_path):
    got, got_b = _monitor_run("port", tmp_path)
    want, want_b = _monitor_run("ref", tmp_path)
    assert got == want
    assert [ok for ok, *_ in got] == [False, False, True, True, False]
    assert got_b == want_b == 2         # one bundle per breach episode


class _ScriptedMonitor:
    """A FleetSLOMonitor stand-in whose evaluate() pops scripted
    verdicts: 'breach', 'calm' (comfortably above objective), 'ok'
    (above objective but inside the retire margin), 'idle' (vacuous)."""

    def __init__(self, side, script):
        s = SIDES[side]
        self.side = s
        self.registry = s["om"].registry()
        self.script = list(script)
        self.rule = s["slo"].SLO("ttft_p95",
                                 "paddle_tpu_request_ttft_seconds",
                                 threshold_s=0.5, objective=0.9)

    def evaluate(self):
        kind = self.script.pop(0) if self.script else "idle"
        att = {"breach": 0.4, "calm": 1.0, "ok": 0.905, "idle": None}[kind]
        return [self.side["fleet"].FleetSLOResult(
            self.rule, att, 0 if att is None else 100,
            per_process={"p0": att} if att is not None else {},
            worst_process="p0" if att is not None else None)]


class _ScriptedActuator:
    def __init__(self, n=1, refuse_grows=0):
        self.n = n
        self.log = []
        self.refuse_grows = refuse_grows

    def grow(self):
        if self.refuse_grows > 0:       # spawn still pending
            self.refuse_grows -= 1
            self.log.append("grow-refused")
            return None
        self.n += 1
        self.log.append("grow")
        return "replica-%d" % self.n

    def retire(self):
        self.n -= 1
        self.log.append("retire")
        return "replica-%d" % (self.n + 1)

    def replicas(self):
        return self.n


SCRIPTS = {
    "grow_after_streak": (["breach"] * 4, dict(n=1), dict(
        max_replicas=3, grow_after=3, cooldown_scans=0)),
    "grow_then_retire": (["breach", "breach"] + ["calm"] * 3, dict(n=1),
                         dict(grow_after=2, retire_after=3, cooldown_scans=0,
                              max_replicas=3)),
    "aborted_grow_retries": (["breach"] * 5, dict(refuse_grows=2),
                             dict(grow_after=2, cooldown_scans=2)),
    "ceiling_floor_cooldown": (["calm", "calm", "breach", "breach", "breach",
                                "idle", "idle", "idle"], dict(n=2),
                               dict(min_replicas=1, max_replicas=2,
                                    grow_after=1, retire_after=2,
                                    cooldown_scans=2)),
    "dead_band": (["ok"] * 5, dict(n=2), dict(retire_after=1,
                                               retire_margin=0.02,
                                               cooldown_scans=0)),
}


def _scripted(side, name, tmp_path):
    script, act_kw, asc_kw = SCRIPTS[name]
    s = SIDES[side]
    s["obs"].enable()
    fdir = str(tmp_path / side / "flight")
    s["flight"].arm(fdir)
    journal = str(tmp_path / side / "scale.jsonl")
    act = _ScriptedActuator(**act_kw)
    asc = s["inf"].Autoscaler(act, _ScriptedMonitor(side, script),
                              journal_path=journal, **asc_kw)
    decs = [asc.scan() for _ in range(len(script) + 1)]

    def plain(d):
        return None if d is None else {k: v for k, v in d.items()
                                       if k != "t"}
    recs = []
    if os.path.exists(journal):
        with open(journal) as f:
            recs = [plain(json.loads(ln)) for ln in f]
    snap = s["om"].registry().snapshot()
    series = {n: snap[n]["series"] for n in (
        "paddle_tpu_autoscaler_replicas",
        "paddle_tpu_autoscaler_decisions_total",
        "paddle_tpu_autoscaler_last_decision") if n in snap}
    return dict(decisions=[plain(d) for d in decs], journal=recs,
                log=act.log, series=series,
                bundles=len(s["flight"].bundles(fdir)),
                committed=len(asc.decisions))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_autoscaler_decisions_equal_the_reference(name, tmp_path):
    got = _scripted("port", name, tmp_path)
    tobs.disable()
    tobs.reset()
    want = _scripted("ref", name, tmp_path)
    assert got == want
    assert got["bundles"] == got["committed"]   # one bundle a decision


def test_autoscaler_grows_and_retires_a_port_router(tmp_path):
    """RouterActuator over a port Router of in-process CPU engines: a
    breach grows the fleet from 1 to 2 replicas (the new one serves),
    calm windows retire one, each decision with its bundle."""
    from torch_fleet_cases import serve, tiny_gpt
    tobs.enable()
    tflight.arm(str(tmp_path / "flight"))
    m = tiny_gpt()
    router = tinf.Router(
        lambda _i: tinf.LLMEngine(m, device="cpu", **ENGINE_KW),
        n_replicas=1)
    mon = _ScriptedMonitor("port", ["breach", "calm", "calm", "calm"])
    asc = tinf.Autoscaler(tinf.RouterActuator(router), mon, grow_after=1,
                          retire_after=2, cooldown_scans=0, max_replicas=2)
    dec = asc.scan()
    assert dec["action"] == "grow" and len(router.replicas) == 2
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 1024, (n,)).astype(np.int32) for n in (9, 17, 5)]
    done = router.generate(ps, max_new_tokens=4)
    assert all(h.engine.stats["prefills"] > 0 for h in router.replicas)
    want = serve(tinf.LLMEngine(m, device="cpu", **ENGINE_KW), ps, 4)
    assert [tuple(int(t) for t in r.output_ids) for r in done] == \
        [want[i] for i in range(len(ps))]
    assert asc.scan() is None
    dec = asc.scan()
    assert dec["action"] == "retire" and len(router.replicas) == 1
    assert len(tflight.bundles(str(tmp_path / "flight"))) == 2
    assert router.stats["grown"] == router.stats["retired"] == 1


# ---------------------------------------------------------------------------
# the router's elastic surface (the reference's
# tests/test_slo_control_plane.py::TestElasticRouter, on the port)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_gpt():
    from torch_fleet_cases import tiny_gpt
    return tiny_gpt()


def _port_factory(m):
    return lambda _i: tinf.LLMEngine(m, device="cpu", **ENGINE_KW)


def _elastic_prompts(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, (k,)).astype(np.int32)
            for k in (5, 9, 13, 21)[:n]]


def _serve_all(router, prompts, n_new):
    for i, p in enumerate(prompts):
        router.submit(f"g{i}", p, max_new_tokens=n_new)
    done = {}
    while router.has_unfinished:
        for r in router.step():
            done[r.request_id] = r
    return done


def test_grow_serves_and_retire_drains_onto_survivors(port_gpt):
    tobs.enable()
    router = tinf.Router(_port_factory(port_gpt), n_replicas=1)
    prompts = _elastic_prompts(4)
    want = {str(i): r.output_ids for i, r in enumerate(
        _port_factory(port_gpt)(0).generate(prompts, max_new_tokens=6))}
    grown = router.add_replica()
    assert grown == "replica-1" and len(router.replicas) == 2
    assert router.stats["grown"] == 1
    for i, p in enumerate(prompts):
        router.submit(str(i), p, max_new_tokens=6)
    # retired mid-flight: its requests re-serve on the survivor
    assert router.retire_replica(grown) == grown
    assert router.stats["retired"] == 1
    done = {}
    while router.has_unfinished:
        for r in router.step():
            done[r.request_id] = r
    assert len(done) == 4
    for rid, r in done.items():
        assert r.ok, (rid, r.error)
        np.testing.assert_array_equal(r.output_ids, want[rid])
    states = tom.registry().snapshot()[
        "paddle_tpu_router_replica_state"]["series"]
    assert states[(grown, "healthy")] == 0.0
    assert states[(grown, "dead")] == 0.0


def test_never_retires_last_live_replica(port_gpt):
    router = tinf.Router(_port_factory(port_gpt), n_replicas=1)
    assert router.retire_replica() is None
    assert len(router.replicas) == 1


def test_engine_factory_override_attaches_preprovisioned(port_gpt):
    calls = []

    def counting_factory(i):
        calls.append(i)
        return _port_factory(port_gpt)(i)
    router = tinf.Router(counting_factory, n_replicas=1)
    assert calls == [0]
    pre = _port_factory(port_gpt)(99)
    router.add_replica(engine_factory=lambda _i, e=pre: e)
    assert calls == [0]
    assert router.replicas.handles[1].engine is pre
    done = _serve_all(router, _elastic_prompts(2), 4)
    assert all(r.ok for r in done.values())


def test_replica_seconds_accumulates_retirees(port_gpt):
    import time
    router = tinf.Router(_port_factory(port_gpt), n_replicas=2)
    time.sleep(0.05)
    before = router.replica_seconds()
    assert before >= 0.1
    router.retire_replica()
    after = router.replica_seconds()
    assert after >= before
    time.sleep(0.05)
    assert router.replica_seconds() - after == pytest.approx(0.05,
                                                             abs=0.04)


def test_retire_shuts_down_process_like_engine():
    stops = []

    class _FakeEngine:
        def __init__(self):
            self.has_unfinished = False

        def add_request(self, *a, **k):
            pass

        def step(self):
            return []

        def abort_request(self, rid):
            return False

        def shutdown(self):
            stops.append(True)
    router = tinf.Router(lambda i: _FakeEngine(), n_replicas=2)
    router.retire_replica()
    assert stops == [True]


def test_concurrent_stepping_for_safe_engines_only():
    """Engines that declare concurrent_step_safe (replica processes) are
    stepped on pool threads; in-process engines stay on the router's
    thread (a CUDA graph capture forbids another thread's launches)."""
    import threading
    threads = set()

    class _Eng:
        def __init__(self, safe):
            if safe:
                self.concurrent_step_safe = True
            self.pending = []

        @property
        def has_unfinished(self):
            return bool(self.pending)

        def add_request(self, rid, prompt, max_new, **kw):
            self.pending.append((rid, prompt))

        def step(self):
            threads.add(threading.current_thread().name)
            out = [tinf.GenerationResult(
                request_id=rid, prompt_ids=p,
                output_ids=np.zeros((2,), np.int32),
                finish_reason="length", error=None)
                for rid, p in self.pending]
            self.pending.clear()
            return out

        def abort_request(self, rid):
            return False

    for safe in (True, False):
        threads.clear()
        router = tinf.Router(lambda i, s=safe: _Eng(s), n_replicas=3,
                             affinity=False)
        for i, p in enumerate(_elastic_prompts(4) * 2):
            router.submit(i, p, max_new_tokens=2)
        done = {}
        while router.has_unfinished:
            for r in router.step():
                done[r.request_id] = r
        assert len(done) == 8 and all(r.ok for r in done.values())
        on_pool = [t for t in threads if t.startswith("router-step")]
        assert bool(on_pool) == safe, threads
