"""paddle_tpu_torch.observability against paddle_tpu.observability: the
registry and its exports, the quantile helpers, merge and its schema
skew, tracing, slo, flight, the fleet's local bundle part and perf. Each
case drives one script through both packages with the same inputs (made
from a numpy seed) and compares counters, gauge values, histogram bucket
counts, label sets and span trees exactly, and the Prometheus and JSON
exports of registries fed the same values once timestamps and ids are
normalised. Durations are never compared."""
import json
import os

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import perf as jperf
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import tracing as ttr
from paddle_tpu_torch.resilience import faults as tfaults

PACKS = {"ref": (jobs, jtr, jslo, jflight, jfleet, jperf, jfaults),
         "port": (tobs, ttr, tslo, tflight, tfleet, tperf, tfaults)}


@pytest.fixture(autouse=True)
def _clean():
    for obs, tr, slo, fl, _f, perf, faults in PACKS.values():
        obs.disable()
        obs.reset()
        slo.clear()
        fl.disarm()
        perf.set_device_peaks()
        faults.clear_all()
    yield
    for obs, tr, slo, fl, _f, perf, faults in PACKS.values():
        obs.disable()
        obs.reset()
        slo.clear()
        fl.disarm()
        perf.set_device_peaks()
        faults.clear_all()
        tr.set_capacity(65536)


def _feed(obs, reg, seed):
    """One script of registrations and updates on `reg`, values from
    `seed`."""
    rng = np.random.default_rng(seed)
    c = reg.counter("paddle_tpu_t_events_total", "events", ("event",))
    g = reg.gauge("paddle_tpu_t_depth", "depth", ("queue",))
    h = reg.histogram("paddle_tpu_t_latency_seconds", "latency")
    hb = reg.histogram("paddle_tpu_t_size_bytes", "sizes", ("kind",),
                       buckets=(1, 10, 100, 1000))
    u = reg.counter("paddle_tpu_t_plain_total", "plain")
    for ev in rng.choice(["a", "b", "c"], 20):
        c.labels(event=str(ev)).inc(float(rng.integers(1, 5)))
    for q in ("waiting", "running"):
        g.labels(queue=q).set(float(rng.integers(0, 9)))
    g.labels(queue="running").dec(1.0)
    g.labels(queue="waiting").inc(2.5)
    for v in rng.exponential(0.05, 50):
        h.observe(float(v))
    for v in rng.integers(0, 2000, 30):
        hb.labels(kind=str(v % 3)).observe(float(v))
    u.inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_equal(seed):
    out = {}
    for name, (obs, *_rest) in PACKS.items():
        obs.metrics.enable()
        reg = _feed(obs, obs.metrics.MetricsRegistry(), seed)
        out[name] = (reg.snapshot(), reg.to_prometheus(), reg.to_json())
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    assert json.loads(out["port"][2]) == json.loads(out["ref"][2])
    assert "paddle_tpu_t_latency_seconds_bucket{le=\"+Inf\"} 50" \
        in out["port"][1]


def test_disabled_records_nothing_and_registration_conflicts_raise():
    for obs, *_rest in PACKS.values():
        reg = _feed(obs, obs.metrics.MetricsRegistry(), 0)
        snap = reg.snapshot()
        for rec in snap.values():
            for v in rec["series"].values():
                assert (v["count"] if isinstance(v, dict) else v) == 0
        with pytest.raises(ValueError, match="conflicting"):
            reg.gauge("paddle_tpu_t_events_total", "x", ("event",))
        with pytest.raises(ValueError, match="expected labels"):
            reg.get("paddle_tpu_t_depth").labels(nope="x")


@pytest.mark.parametrize("seed", [3, 4])
def test_quantile_helpers_equal(seed):
    rng = np.random.default_rng(seed)
    bounds = tuple(sorted(rng.uniform(0, 10, 8).round(3)))
    counts = [int(x) for x in rng.integers(0, 20, 9)]
    lo, hi = 0.01, float(bounds[-1]) + 3.0
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert tobs.metrics.quantile_from_buckets(bounds, counts, q, lo, hi) \
            == jobs.metrics.quantile_from_buckets(bounds, counts, q, lo, hi)
    for v in list(bounds) + [0.0, 5.5, 100.0]:
        assert tobs.metrics.fraction_le(bounds, counts, v, hi=hi) \
            == jobs.metrics.fraction_le(bounds, counts, v, hi=hi)
    docs = {}
    for name, (obs, *_rest) in PACKS.items():
        obs.metrics.enable()
        reg = _feed(obs, obs.metrics.MetricsRegistry(), seed)
        prev = json.loads(reg.to_json())
        reg.get("paddle_tpu_t_size_bytes").labels(kind="1").observe(7.0)
        docs[name] = obs.metrics.quantiles_by_label(
            json.loads(reg.to_json()), "paddle_tpu_t_size_bytes", "kind",
            prev=prev)
    assert docs["port"] == docs["ref"]


def test_merge_skew_and_quarantine_equal():
    res = {}
    for name, (obs, *_rest) in PACKS.items():
        obs.metrics.enable()
        a = _feed(obs, obs.metrics.MetricsRegistry(), 5)
        b = _feed(obs, obs.metrics.MetricsRegistry(), 6)
        a.merge(b.snapshot())
        skew = obs.metrics.MetricsRegistry()
        skew.histogram("paddle_tpu_t_latency_seconds", "latency",
                       buckets=(0.5, 1.0)).observe(0.7)
        skew.gauge("paddle_tpu_t_plain_total", "was a counter").set(3.0)
        with pytest.raises(obs.MergeSkewError):
            a.merge(skew.snapshot())
        q = a.merge(skew.snapshot(), on_skew="quarantine")
        with pytest.raises(obs.MergeSkewError, match="malformed"):
            a.merge({"x": {"kind": "counter"}})
        res[name] = (a.snapshot(), sorted(q))
    assert res["port"] == res["ref"]
    assert res["port"][1] == ["paddle_tpu_t_latency_skew_seconds",
                              "paddle_tpu_t_plain_total_skew"]
    for n, k in (("a_total", "counter"), ("b_seconds", "histogram"),
                 ("c", "gauge"), ("d_bytes", "histogram")):
        assert tobs.metrics.quarantine_name(n, k) \
            == jobs.metrics.quarantine_name(n, k)


def test_global_registry_merge_summary_and_compile_metrics():
    res = {}
    for name, (obs, *_rest) in PACKS.items():
        obs.enable()
        local = _feed(obs, obs.metrics.MetricsRegistry(), 7)
        obs.merge(local.snapshot())
        c, h = obs.metrics.compile_metrics()
        c.labels(family="train_step", outcome="compile").inc()
        res[name] = (obs.summary()["counters"],
                     {k: (v["count"], v["min"], v["max"])
                      for k, v in obs.summary()["histograms"].items()},
                     (c.kind, c.labelnames, h.kind, h.labelnames,
                      h.buckets))
    assert res["port"] == res["ref"]


def _tree(evs):
    """Each event as (name, parent's name, depth, args) in ring order:
    the span tree without its ids and times."""
    by_id = {e["span_id"]: e for e in evs if "span_id" in e}

    def depth(e):
        d = 0
        while e.get("parent_id") in by_id:
            e = by_id[e["parent_id"]]
            d += 1
        return d
    return [(e["name"], by_id[e["parent_id"]]["name"]
             if e.get("parent_id") in by_id else None, depth(e),
             json.dumps(e.get("args"), sort_keys=True),
             e.get("ingested", False)) for e in evs]


def _trace_script(tr, seed):
    rng = np.random.default_rng(seed)
    tr.enable()
    n = int(rng.integers(2, 5))
    with tr.span("engine.step", batch=n):
        for i in range(n):
            with tr.span("engine.prefill", request_id=f"r{i}"):
                with tr.span("engine.ragged", rows=i):
                    pass
    with tr.span("root") as root:
        pass
    with tr.trace_context(root.trace_id, root.span_id):
        with tr.span("adopted"):
            tr.add_event("manual", 1.0, 2.0, args={"k": 1},
                         trace=(root.trace_id, tr.new_span_id(),
                                root.span_id))
        cur = tr.current_trace()
    tr.ingest([{"name": "io.worker.batch", "ph": "X", "pid": 1, "tid": 2,
                "ts": 3.0, "dur": 4.0, "args": {"wid": 0}}])
    tr.disable()
    with tr.span("dropped"):
        pass
    return cur == {"trace_id": root.trace_id, "span_id": root.span_id}


@pytest.mark.parametrize("seed", [0, 1])
def test_tracing_span_trees_equal(seed, tmp_path):
    out = {}
    for name, (obs, tr, *_rest) in PACKS.items():
        before = tr.appended_total()        # process-wide, monotonic
        adopted_ok = _trace_script(tr, seed)
        evs = tr.events()
        chrome = tr.export_chrome_trace(str(tmp_path / name / "t.json"))
        jsonl = tr.export_jsonl(str(tmp_path / name / "t.jsonl"))
        with open(chrome) as f:
            ch = json.load(f)
        with open(jsonl) as f:
            lines = [json.loads(x) for x in f]
        out[name] = (adopted_ok, _tree(evs), _tree(ch["traceEvents"]),
                     _tree(lines), ch["displayTimeUnit"],
                     [sorted(e) for e in evs],
                     tr.appended_total() - before)
    assert out["port"] == out["ref"]
    assert out["port"][0]
    assert ("engine.ragged", "engine.prefill", 2, json.dumps({"rows": 0}),
            False) in out["port"][1]


def test_tracing_ring_capacity_and_totals():
    out = {}
    for name, (obs, tr, *_rest) in PACKS.items():
        tr.enable()
        tr.set_capacity(5)
        base = tr.appended_total()          # process-wide, monotonic
        for i in range(12):
            tr.add_event(f"e{i}", float(i), 1.0)
        ring, total = tr.events_with_total()
        before = tr.appended_total()
        tr.clear()
        out[name] = ([e["name"] for e in ring], total - base, before - base,
                     tr.appended_total() - base, tr.capacity(),
                     len(tr.events()))
        tr.disable()
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["e7", "e8", "e9", "e10", "e11"]


def test_slo_evaluate_and_breaches_equal(tmp_path):
    out = {}
    for name, (obs, tr, slo, fl, *_rest) in PACKS.items():
        obs.enable()
        h = obs.registry().histogram("paddle_tpu_request_ttft_seconds",
                                     "per-request time to first token")
        for v in np.random.default_rng(8).exponential(0.3, 40):
            h.observe(float(v))
        slo.add(slo.SLO("ttft_p95", "paddle_tpu_request_ttft_seconds",
                        threshold_s=0.5, objective=0.95))
        slo.add(slo.SLO("ttft_p50", "paddle_tpu_request_ttft_seconds",
                        threshold_s=0.5, objective=0.5))
        slo.add(slo.SLO("typo", "paddle_tpu_no_such_seconds",
                        threshold_s=1.0, objective=0.9))
        fl.arm(str(tmp_path / name))
        res = [r.to_dict() for r in slo.evaluate()]
        breaches = obs.registry().get("paddle_tpu_slo_breaches_total")
        # bundle sequence numbers are process-wide: the reasons
        out[name] = (res, sorted((k, c.value) for k, c in
                                 breaches._series() if c.value),
                     [os.path.basename(b).split("_", 2)[2]
                      for b in fl.bundles()])
        with pytest.raises(ValueError):
            slo.SLO("bad", "m", threshold_s=1.0, objective=1.5)
    assert out["port"] == out["ref"]
    assert out["port"][1] == [(("ttft_p95",), 1.0)]
    assert out["port"][2] == ["slo_breach"]


def test_flight_retention_cooldown_and_faults_equal(tmp_path):
    out = {}
    for name, (obs, tr, slo, fl, fleet, perf, faults) in PACKS.items():
        obs.enable()
        d = tmp_path / name
        fl.arm(str(d), retention=2, capture_faults=True)
        obs.registry().counter("paddle_tpu_t_total", "t").inc(3)
        with tr.span("engine.step"):
            pass
        paths = [fl.trigger(r, detail={"i": i}) for i, r in
                 enumerate(("manual", "step_latency", "deadline_miss"))]
        with faults.inject("engine.step", exc=RuntimeError("x")):
            with pytest.raises(RuntimeError):
                faults.fault_point("engine.step", rid=1)
        # bundle sequence numbers are process-wide: the reasons
        kept = [os.path.basename(b).split("_", 2)[2] for b in fl.bundles()]
        b = fl.load_bundle(fl.bundles()[-1])
        fl.disarm()
        fl.arm(str(d), retention=8, min_interval_s=3600.0)
        first = fl.trigger("manual")
        second = fl.trigger("manual")
        counts = sorted((k, c.value) for k, c in obs.registry().get(
            "paddle_tpu_flight_bundles_total")._series() if c.value)
        fl.disarm()
        out[name] = (kept, b["meta"]["reason"], b["meta"]["detail"],
                     b["metrics"]["paddle_tpu_t_total"]["series"],
                     [e["name"] for e in b["trace"]], counts,
                     [os.path.basename(p).split("_", 2)[2] for p in paths],
                     os.path.basename(first).split("_", 2)[2], second,
                     fl.armed(),
                     fl.TRIGGER_REASONS)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["deadline_miss", "fault_point"]


@pytest.fixture
def _fleet_identity():
    """set_identity is process-wide: put both packages' back after."""
    saved = [(f, f._PROCESS, f._ROLE, f._ROLE_EXPLICIT)
             for f in (jfleet, tfleet)]
    yield
    for f, proc, role, explicit in saved:
        f._PROCESS, f._ROLE, f._ROLE_EXPLICIT = proc, role, explicit


def test_fleet_delta_bundle_and_local_merge_equal(_fleet_identity):
    out = {}
    for name, (obs, tr, slo, fl, fleet, *_r) in PACKS.items():
        obs.enable()
        base = _feed(obs, obs.metrics.MetricsRegistry(), 9).snapshot()
        cur_reg = _feed(obs, obs.metrics.MetricsRegistry(), 9)
        _feed(obs, cur_reg, 10)
        cur = cur_reg.snapshot()
        delta = fleet.delta_snapshot(cur, base)
        rebuilt = obs.metrics.MetricsRegistry()
        rebuilt.merge(base)
        rebuilt.merge(delta)
        fleet.set_identity(process="io-worker-0", role="io-worker")
        with tr.span("io.worker.batch"):
            pass
        obs.registry().counter("paddle_tpu_t_w_total", "w").inc(2)
        bundle = fleet.worker_farewell()
        obs.reset()
        fleet.merge_bundle_local(bundle)
        fleet.merge_bundle_local(None)
        out[name] = (delta, rebuilt.snapshot() == cur,
                     fleet.identity(), bundle["v"], bundle["seq"],
                     bundle["process"], bundle["role"],
                     sorted(bundle["metrics"]),
                     [(e["name"], e.get("ingested", False))
                      for e in tr.events()],
                     obs.snapshot()["paddle_tpu_t_w_total"]["series"])
    assert out["port"] == out["ref"]
    assert out["port"][1]


def test_perf_roofline_and_family_records_equal():
    out = {}
    for name, (obs, tr, slo, fl, fleet, perf, _f) in PACKS.items():
        # the family expectations recorded by earlier tests' compiles
        # outlive a window reset by design (they describe executables)
        perf._FAMILY_COST.clear()
        assert perf.device_peaks() is None      # the CPU: no series
        obs.enable()
        perf.observe_roofline("engine_decode", 0.01, perf.CostModel(
            flops=1e9, bytes_accessed=2e8))
        no_peak = obs.registry().get("paddle_tpu_roofline_utilization")
        silent = no_peak is None or not any(
            c.value for _k, c in no_peak._series())
        perf.set_device_peaks(1e12, 1e11)
        perf.observe_roofline("engine_decode", 0.02, perf.CostModel(
            flops=4e9, bytes_accessed=1e8))
        perf.observe_roofline("train_step", 0.0, perf.CostModel())
        perf.observe_roofline("train_step", 1.0, None)
        roof = sorted((k, c.value) for k, c in obs.registry().get(
            "paddle_tpu_roofline_utilization")._series() if c.value)
        recs = perf.family_records()
        out[name] = (silent, roof, recs)
        perf.reset_window()
        assert perf.family_records() == {}
    assert out["port"] == out["ref"]
    assert out["port"][1] == [(("engine_decode", "flops"), 0.2),
                              (("engine_decode", "hbm"), 0.05)]


def test_perf_series_have_the_reference_schema():
    """The executable, roofline and dispatch-engine series: the port
    registers each under the reference's name, kind, labels and
    buckets (the dispatch recorders themselves are JAX's own)."""
    jm, tm = jperf._metrics(), tperf._metrics()
    assert sorted(jm) == sorted(tm)
    for k in jm:
        assert (tm[k].name, tm[k].kind, tm[k].labelnames, tm[k].buckets) \
            == (jm[k].name, jm[k].kind, jm[k].labelnames, jm[k].buckets)
    assert tperf.DISPATCH_GAP_BUCKETS == jperf.DISPATCH_GAP_BUCKETS


def test_perf_count_cost_formulas_and_peaks():
    """count_cost's formulas (its docstring), record_compile's gauges,
    and the card's peaks: the H100's, matched by name."""
    c = tperf.count_cost("engine_decode", steps=2, rows=3, params=10,
                         param_bytes=20, layers=2, heads=4, head_dim=8,
                         attended=50, kv_token_bytes=6, logits_bytes=7)
    assert (c.flops, c.bytes_accessed) == (
        2 * 10 * 3 * 2 + 4 * 2 * 4 * 8 * 50, 2 * (20 + 7) + (50 + 6) * 6)
    c = tperf.count_cost("engine_ragged", tokens=5, head_rows=2, params=10,
                         head_params=4, param_bytes=20, layers=2, heads=4,
                         head_dim=8, attended=30, cached=9,
                         kv_token_bytes=6, logits_bytes=7)
    assert (c.flops, c.bytes_accessed) == (
        2 * 6 * 5 + 2 * 4 * 2 + 4 * 2 * 4 * 8 * 30, 20 + (9 + 5) * 6 + 7)
    c = tperf.count_cost("train_step", params=10, tokens=4, layers=2,
                         heads=4, head_dim=8, seq=2, causal=True,
                         param_bytes=40, update_bytes=280)
    assert (c.flops, c.bytes_accessed) == (
        6 * 10 * 4 + 6 * 2 * 4 * 8 * 2 * 4, 2 * 40 + 280)
    c = tperf.count_cost("optimizer_fused", elements=10, update_bytes=280)
    assert (c.flops, c.bytes_accessed, c.bytes_temp) == (170, 280, 0.0)
    with pytest.raises(ValueError):
        tperf.count_cost("nope")
    assert tperf.lookup("NVIDIA H100 80GB HBM3", tperf.PEAK_BF16_FLOPS) \
        == 989e12
    assert tperf.lookup("NVIDIA H100 80GB HBM3", tperf.HBM_BYTES_PER_SEC) \
        == 3.35e12
    assert tperf.lookup("cpu", tperf.PEAK_BF16_FLOPS, "x") == "x"
    tobs.enable()
    assert tperf.record_compile("train_step", c) is c
    assert tperf.record_compile("train_step", None) is None
    g = tobs.registry().get("paddle_tpu_executable_bytes")
    assert g.labels(family="train_step", kind="accessed").value == 280
    assert tperf.family_records()["train_step"]["compiles"] == 1
