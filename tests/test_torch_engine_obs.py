"""The port's LLMEngine observability against the reference engine's:
twin tiny GPTs with the same weights (`gpt_params_from_numpy`) serve the
same traffic with metrics and tracing on, and every series (counters,
gauge values of counts, histogram observation counts, label sets) and
the span trees (names, parents, depths) are equal, as in the reference's
TestEngineInstrumentation (tests/test_observability.py) and
tests/test_request_tracing.py's engine cases: obs_carry adoption, the
flight triggers (deadline miss, step latency, preemption storm),
rejections and aborts, and the disabled mode recording nothing.

The port's counts differ by design in two places, pinned here:

* compiles: the reference compiles one executable per packed-wave
  bucket ("engine_ragged") and decode chunk ("engine_decode"); the
  port's packed waves run eagerly and its decode steps are CUDA graphs
  only on the card, so on the CPU it reports no compile, no executable
  gauge and no compile stall in the TTFT budget;
* ``paddle_tpu_hbm_live_array_bytes``: the reference walks
  ``jax.live_arrays()``; the port reads the caching allocator's
  allocated bytes, 0 on the CPU.

Durations are never compared."""
import collections
import os
import tracemalloc

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.inference import SpeculativeConfig as JSpec
from paddle_tpu.inference.speculative import DraftProposer as JDraft
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import perf as jperf
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import LLMEngine as TEngine
from paddle_tpu_torch.inference import SpeculativeConfig as TSpec
from paddle_tpu_torch.inference.speculative import DraftProposer as TDraft
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.resilience import faults as tfaults
from torch_port_helpers import twin_gpts

SIDES = {"ref": (jobs, jflight, jperf, jfaults, JEngine, (JSpec, JDraft),
                 {}),
         "port": (tobs, tflight, tperf, tfaults, TEngine, (TSpec, TDraft),
                  {"device": "cpu"})}
BASE_KW = dict(max_batch=2, block_size=16, decode_chunk=4,
               prompt_quantum=16, max_model_len=64)
# by design (module docstring): not compared, the port's pinned
DEPARTED = ("paddle_tpu_compile_total", "paddle_tpu_compile_seconds",
            "paddle_tpu_executable_flops", "paddle_tpu_executable_bytes",
            "paddle_tpu_hbm_live_array_bytes",
            "paddle_tpu_dispatch_gap_seconds",
            "paddle_tpu_dispatch_gap_op_seconds_total",
            "paddle_tpu_dispatch_batch_size",
            "paddle_tpu_backward_graph_cache_total")


@pytest.fixture(scope="module")
def gpts():
    jm, tm = twin_gpts()
    return {"ref": jm, "port": tm}


@pytest.fixture(autouse=True)
def _clean():
    def off():
        for obs, fl, perf, faults, *_r in SIDES.values():
            obs.disable()
            obs.reset()
            fl.disarm()
            perf.set_device_peaks()
            faults.clear_all()
    off()
    yield
    off()


def _wrong(base):
    """A proposer of drafts the tiny models essentially never emit:
    every one is rejected, the same on both sides."""
    class Wrong(base):
        def propose(self, context, k):
            return np.full((k,), 1023, np.int32)
    return Wrong()


def _prompts(seed=0, lens=(5, 9, 13)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, (n,)).astype(np.int32) for n in lens]


def _shared_prefix_prompts():
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 1024, (t,))
                            .astype(np.int32)]) for t in (1, 2)]


def _drain(eng):
    done = {}
    while eng.has_unfinished:
        for r in eng.step():
            done[r.request_id] = r
    return done


def _serve(side, model, prompts, n_new, **kw):
    obs, fl, perf, faults, Engine, Spec, dev = SIDES[side]
    if kw.pop("spec", False):
        kw["speculative_config"] = Spec[0](proposer=_wrong(Spec[1]),
                                           num_speculative_tokens=3)
    eng = Engine(model, **{**BASE_KW, **kw, **dev})
    for i, p in enumerate(prompts):
        eng.add_request(i, p, max_new_tokens=n_new)
    return eng, _drain(eng)


def _flat(snap):
    """{(series, label values): value, or a histogram's observation
    count}, non-zero ones (earlier tests' registrations of a
    process-global registry read 0 after a reset), the departed series
    left out."""
    out = {}
    for name, rec in snap.items():
        if name in DEPARTED:
            continue
        for key, v in rec["series"].items():
            v = v["count"] if rec["kind"] == "histogram" else v
            if v:
                out[name, key] = v
    return out


def _nz(series):
    """A series dict without its zero values (see _flat)."""
    return {k: v for k, v in series.items() if v}


def _tree(evs):
    """The span tree without ids and times: a count of (name, parent's
    name, depth) triples, and each request's events by name under its
    root (one trace each)."""
    by_id = {e["span_id"]: e for e in evs if "span_id" in e}

    def depth(e):
        d = 0
        while e.get("parent_id") in by_id:
            e = by_id[e["parent_id"]]
            d += 1
        return d
    shape = collections.Counter(
        (e["name"], by_id[e["parent_id"]]["name"]
         if e.get("parent_id") in by_id else None, depth(e)) for e in evs)
    per_req = {}
    for e in evs:
        rid = e.get("args", {}).get("request_id")
        if rid is not None and e["name"].startswith("request"):
            per_req.setdefault(rid, []).append(
                (e["name"], e.get("args", {}).get("finish_reason")))
    roots = {e["trace_id"]: e for e in evs if e["name"] == "request"}
    connected = all(
        e["trace_id"] in roots
        and e["parent_id"] == roots[e["trace_id"]]["span_id"]
        for e in evs if e["name"].startswith("request."))
    return shape, {k: sorted(v) for k, v in per_req.items()}, connected


TRAFFIC = {
    # three prompts through max_batch 2: two admission waves
    "batch": lambda: (_prompts(), 6, {}),
    # two shared-prefix prompts through a pool too small for both:
    # preemption, resume through the prefix cache
    "preempt_prefix": lambda: (_shared_prefix_prompts(), 20, dict(
        block_size=8, num_blocks=8, enable_prefix_caching=True)),
    # speculative verify waves, every draft rejected
    "spec": lambda: (_prompts(1, (6, 11)), 8, dict(spec=True)),
}


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_engine_series_and_spans_equal_the_reference(gpts, traffic):
    prompts, n_new, kw = TRAFFIC[traffic]()
    out = {}
    for side in SIDES:
        obs = SIDES[side][0]
        obs.reset()
        obs.enable()
        eng, done = _serve(side, gpts[side], prompts, n_new, **kw)
        obs.disable()
        out[side] = (dict(eng.stats), _flat(obs.snapshot()),
                     _tree(obs.trace_events()),
                     {k: r.finish_reason for k, r in done.items()})
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    assert out["port"][2][2]              # one connected trace a request
    assert out["port"][3] == out["ref"][3]
    snap = tobs.snapshot()
    ev = snap["paddle_tpu_engine_events_total"]["series"]
    stats = out["port"][0]
    assert {k[0]: v for k, v in ev.items() if v} == {
        k: v for k, v in stats.items() if v and k not in (
            "prefix_cache_hit_tokens", "prefix_cache_miss_tokens",
            "spec_drafted_tokens", "spec_accepted_tokens")}
    # the departures, pinned: no compile on the CPU, no live bytes
    assert not any(snap.get("paddle_tpu_compile_total", {}).get(
        "series", {}).values())
    assert snap["paddle_tpu_hbm_live_array_bytes"]["series"][()] == 0
    budget = snap["paddle_tpu_request_ttft_budget_seconds"]["series"]
    assert budget[("compile_stall",)]["max"] == 0.0
    if traffic == "spec":
        names = {n for n, _p, _d in out["port"][2][0]}
        assert "engine.verify" in names and "request.verify" in names
    if traffic == "preempt_prefix":
        assert stats["preemptions"] >= 1
        assert any(n == "request.preempt" for evs in out["port"][2][1]
                   .values() for n, _r in evs)


def test_obs_carry_joins_the_earlier_trace(gpts):
    """A re-served request (obs_carry with reserve) stays in the trace it
    carried, and its prefill wall charges to affinity_miss."""
    out = {}
    for side in SIDES:
        obs, fl, perf, faults, Engine, _s, dev = SIDES[side]
        obs.enable()
        eng = Engine(gpts[side], **BASE_KW, **dev)
        tid, root = obs.tracing.new_trace_id(), obs.tracing.new_span_id()
        import time
        eng.add_request("r", _prompts()[0], max_new_tokens=4,
                        obs_carry=(tid, root, time.perf_counter() - 0.5,
                                   True))
        _drain(eng)
        evs = obs.trace_events()
        budget = obs.snapshot()[
            "paddle_tpu_request_ttft_budget_seconds"]["series"]
        out[side] = (
            sorted(e["name"] for e in evs if e.get("trace_id") == tid),
            all(e.get("parent_id") == root for e in evs
                if e.get("trace_id") == tid and e["name"] != "request"),
            [e.get("span_id") for e in evs if e["name"] == "request"]
            == [root],
            budget[("affinity_miss",)]["sum"] > 0,
            budget[("prefill_compute",)]["sum"] == 0,
            obs.snapshot()["paddle_tpu_request_ttft_seconds"]["series"][
                ()]["min"] >= 0.5)
        obs.disable()
        obs.reset()
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["request", "request.decode_chunk",
                              "request.prefill", "request.queue_wait"]
    assert all(out["port"][1:])


def test_deadline_miss_drops_a_bundle(gpts, tmp_path):
    out = {}
    for side in SIDES:
        obs, fl, perf, faults, Engine, _s, dev = SIDES[side]
        obs.enable()
        eng = Engine(gpts[side], **BASE_KW, **dev)
        fl.arm(str(tmp_path / side))
        eng.add_request("late", _prompts()[0], max_new_tokens=4,
                        deadline_s=0.0)        # expired on arrival
        (r,) = eng.step()
        (b,) = fl.bundles()
        bundle = fl.load_bundle(b)
        out[side] = (r.finish_reason, os.path.basename(b).split("_", 2)[2],
                     bundle["meta"]["detail"]["request_id"],
                     bundle["meta"]["detail"]["where"],
                     _nz(obs.snapshot()["paddle_tpu_request_finished_total"][
                         "series"]),
                     "paddle_tpu_engine_events_total" in bundle["metrics"],
                     sorted({e["name"] for e in bundle["trace"]}))
    assert out["port"] == out["ref"]
    assert out["port"][1] == "deadline_miss"


@pytest.mark.parametrize("trigger", ["step_latency", "preempt_storm"])
def test_step_latency_and_preempt_storm_bundles(gpts, tmp_path, trigger):
    out = {}
    for side in SIDES:
        obs, fl, perf, faults, Engine, _s, dev = SIDES[side]
        obs.enable()
        kw = dict(step_latency_threshold_s=0.0) \
            if trigger == "step_latency" else dict(preempt_storm=1)
        fl.arm(str(tmp_path / side), min_interval_s=3600.0, **kw)
        eng = Engine(gpts[side], **{**BASE_KW, "block_size": 8,
                                    "num_blocks": 8}, **dev)
        for i, p in enumerate(_shared_prefix_prompts()):
            eng.add_request(i, p, max_new_tokens=20)
        _drain(eng)
        bundles = fl.bundles()
        meta = fl.load_bundle(bundles[0])["meta"]
        out[side] = ([os.path.basename(b).split("_", 2)[2]
                      for b in bundles], sorted(meta["detail"]),
                     sorted(meta["extra"]["engine_stats"]))
        fl.disarm()
    assert out["port"] == out["ref"]
    assert out["port"][0] == [trigger]


def test_rejected_and_aborted_requests_are_counted(gpts):
    out = {}
    for side in SIDES:
        obs, fl, perf, faults, Engine, _s, dev = SIDES[side]
        obs.enable()
        eng = Engine(gpts[side], max_batch=2, block_size=8, num_blocks=5,
                     max_model_len=64, shed_load=True, **dev)
        eng.add_request("big", np.arange(30, dtype=np.int32),
                        max_new_tokens=30)
        eng.add_request("q", _prompts()[0], max_new_tokens=4)
        eng.abort_request("q")
        res = {r.request_id: r.finish_reason for r in eng.step()}
        snap = obs.snapshot()
        out[side] = (res, _nz(snap["paddle_tpu_request_finished_total"][
            "series"]), _nz(snap["paddle_tpu_engine_events_total"]["series"]),
            sorted(e.get("args", {}).get("finish_reason")
                   for e in obs.trace_events() if e["name"] == "request"))
        obs.disable()
        obs.reset()
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"big": "rejected", "q": "aborted"}


def test_rooflines_with_pinned_peaks(gpts):
    """With device peaks pinned, every packed wave and decode chunk is a
    roofline sample (the port compiles nothing on the CPU, so none is
    skipped: the reference skips its compiling first calls)."""
    tperf.set_device_peaks(1e12, 1e11)
    tobs.enable()
    eng, _done = _serve("port", gpts["port"], _prompts(), 6)
    roof = _nz(tobs.snapshot()["paddle_tpu_roofline_utilization"][
        "series"])
    assert {k[0] for k in roof} == {"engine_decode", "engine_ragged"}
    assert all(0 < v for v in roof.values())
    recs = tperf.family_records()
    assert recs["engine_ragged"]["runs"] == eng.stats["ragged_launches"]
    assert recs["engine_decode"]["runs"] == eng.stats["decode_chunks"]
    # no capture on the CPU: no family expectation recorded, each
    # sample carries its own shape count
    assert recs["engine_decode"]["expected"] is None
    assert recs["engine_decode"]["achieved_flops_per_s"] > 0


def test_disabled_mode_records_nothing(gpts):
    """Observability off: the stats dict keeps its exact counts, the
    registry and the ring stay empty (the reference's
    test_engine_stats_backward_compatible_when_disabled)."""
    out = {}
    for side in SIDES:
        obs = SIDES[side][0]
        eng, done = _serve(side, gpts[side], _prompts(), 4)
        assert isinstance(eng.stats, dict) and dict(eng.stats) == eng.stats
        snap = obs.snapshot()
        out[side] = (dict(eng.stats), sorted(eng.stats),
                     sum(v for v in snap.get(
                         "paddle_tpu_engine_events_total",
                         {"series": {}})["series"].values()),
                     obs.trace_events())
    assert out["port"] == out["ref"]
    assert out["port"][2:] == (0, [])


def test_disabled_mode_no_allocation_growth():
    """The reference's overhead guard on the port: request-id spans, the
    flight-armed check and the request histograms are one flag check
    each when off, and allocate nothing."""
    h = tobs.registry().histogram("t_ov2_seconds", "h")
    c = tobs.registry().counter("t_ov2_total", "h")
    assert not tobs.enabled() and not tflight.armed()

    def ops(n):
        for _ in range(n):
            with tobs.span("t.ov2", request_id="r"):
                pass
            h.observe(0.1)
            c.inc()
            if tflight._ARMED:
                pytest.fail("armed")
    ops(16)
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    ops(5000)
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 2048, f"disabled-mode ops leaked {grown}B"
    assert tobs.trace_events() == []
