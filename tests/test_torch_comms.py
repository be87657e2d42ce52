"""The port's collective observability (paddle_tpu_torch.observability.
comms and perf's interconnect tables) against the reference's, the parts
of tests/test_comms_obs.py that need no collective: the port has none yet
(ROADMAP item 26 brings them and their calls of start/finish), so these
tests drive start/finish/count directly on both sides, as the
reference's sync collectives do. Counts, label sets, trace events and
ledger records are equal; durations are never compared, only bounded
where a fault point injects a delay."""
import time
import tracemalloc

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.observability import comms as jcomms
from paddle_tpu.observability import perf as jperf
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import comms as tcomms
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.resilience import faults as tfaults
from torch_port_helpers import cpu_place, twin_gpts

SIDES = {"ref": (jobs, jcomms, jperf, jfaults),
         "port": (tobs, tcomms, tperf, tfaults)}
SERIES = ("paddle_tpu_collective_seconds",
          "paddle_tpu_collective_bytes_total",
          "paddle_tpu_collective_launches_total",
          "paddle_tpu_collective_algbw_bytes_per_sec",
          "paddle_tpu_collective_link_utilization")


@pytest.fixture(autouse=True)
def _clean():
    for obs, _c, perf, faults in SIDES.values():
        obs.disable()
        obs.reset()
        faults.clear_all()
    with cpu_place():
        yield
    for obs, _c, perf, faults in SIDES.values():
        faults.clear_all()
        perf.set_device_peaks()
        perf.set_interconnect_peaks()
        obs.disable()
        obs.reset()


def _out(side):
    """A finished collective's result on each side."""
    x = np.ones((4, 64), np.float32)
    return pt.to_tensor(x)._data if side == "ref" else \
        __import__("torch").from_numpy(x)


def _nonzero(obs, name):
    rec = obs.snapshot().get(name)
    out = {}
    for k, v in (rec["series"] if rec else {}).items():
        v = v["count"] if isinstance(v, dict) else v
        if v:
            out[k] = v
    return out


def _shape(obs):
    """{series: set of label tuples} of the collective series."""
    return {n: set(_nonzero(obs, n)) for n in SERIES}


def _events(obs, name):
    return [e for e in obs.trace_events() if e["name"] == name]


def test_start_finish_records_every_series():
    out = {}
    for side, (obs, comms, perf, _f) in SIDES.items():
        obs.enable()
        rec = comms.start("all_reduce", "world", 4 * 64 * 4)
        comms.finish(rec, _out(side))
        comms.finish(rec, _out(side))           # idempotent
        rec2 = comms.start("all_gather", "dp", 0)
        comms.finish(rec2)
        arr = _events(obs, "comms.arrival")
        out[side] = dict(
            shape=_shape(obs),
            counts={n: _nonzero(obs, n) for n in (
                "paddle_tpu_collective_bytes_total",
                "paddle_tpu_collective_launches_total",
                "paddle_tpu_collective_seconds")},
            arrivals=[(e["args"]["op"], e["args"]["group"]) for e in arr],
            spans=[(e["name"], e["args"]) for e in obs.trace_events()
                   if e["name"].startswith("comms.")
                   and e["name"] != "comms.arrival"],
            window=comms.window_comms_seconds() > 0)
    assert out["port"] == out["ref"]
    assert out["port"]["counts"]["paddle_tpu_collective_seconds"] == {
        ("all_reduce", "world"): 1, ("all_gather", "dp"): 1}
    assert out["port"]["shape"][
        "paddle_tpu_collective_link_utilization"] == set()


def test_count_only_and_reshard_records():
    out = {}
    for side, (obs, comms, _p, _f) in SIDES.items():
        obs.enable()
        comms.count("all_reduce", "mp", 1024, mode="in_trace", n=3)
        comms.note_reshard("all_gather", "sp", 2048)
        out[side] = ({n: _nonzero(obs, n) for n in SERIES},
                     [e["args"] for e in _events(obs, "comms.reshard")])
    assert out["port"] == out["ref"]
    assert out["port"][0]["paddle_tpu_collective_launches_total"] == {
        ("all_reduce", "in_trace"): 3, ("all_gather", "reshard"): 1}
    assert out["port"][0]["paddle_tpu_collective_seconds"] == {}


def test_call_seq_increments_and_survives_reset():
    out = {}
    for side, (obs, comms, _p, _f) in SIDES.items():
        obs.enable()
        seqs = []
        for _ in range(2):
            comms.finish(comms.start("all_reduce", "seqtest", 16))
        seqs.append([e["args"]["seq"] for e in _events(obs,
                                                        "comms.arrival")])
        obs.reset()         # the window resets, the call-seq does not
        comms.finish(comms.start("all_reduce", "seqtest", 16))
        seqs.append([e["args"]["seq"] for e in _events(obs,
                                                        "comms.arrival")])
        first = seqs[0]
        out[side] = (first[1] - first[0], seqs[1][0] - first[1],
                     len(seqs[1]))
    assert out["port"] == out["ref"] == (1, 1, 1)


def test_link_utilization_honest_about_unknown_device():
    out = {}
    for side, (obs, comms, perf, _f) in SIDES.items():
        obs.enable()
        comms.finish(comms.start("all_reduce", "world", 4096), _out(side))
        unknown = _nonzero(obs, "paddle_tpu_collective_link_utilization")
        perf.set_interconnect_peaks(ici=1e9, dcn=1e8)
        comms.finish(comms.start("all_reduce", "world", 4096), _out(side))
        util = _nonzero(obs, "paddle_tpu_collective_link_utilization")
        bw = _nonzero(obs, "paddle_tpu_collective_algbw_bytes_per_sec")[
            ("all_reduce",)]
        assert util[("all_reduce", "ici")] == pytest.approx(bw / 1e9)
        assert util[("all_reduce", "dcn")] == pytest.approx(bw / 1e8)
        out[side] = (unknown, set(util))
    assert out["port"] == out["ref"] == (
        {}, {("all_reduce", "ici"), ("all_reduce", "dcn")})


def test_interconnect_tables():
    """The card's NVLink under the reference's "ici" label; no network
    peak, so "dcn" is 0 and publishes nothing; an unknown card None."""
    assert tperf.interconnect_peaks("NVIDIA H100 80GB HBM3") == {
        "ici": 450e9, "dcn": 0.0}
    assert tperf.interconnect_peaks("Some Other Card") is None
    tperf.set_interconnect_peaks(ici=2e9)
    assert tperf.interconnect_peaks() == {"ici": 2e9, "dcn": 0.0}
    tobs.enable()
    tcomms.finish(tcomms.start("all_reduce", "world", 4096))
    assert set(_nonzero(tobs, "paddle_tpu_collective_link_utilization")) \
        == {("all_reduce", "ici")}


def test_fault_point_delays_arrival_and_span():
    out = {}
    for side, (obs, comms, _p, faults) in SIDES.items():
        obs.enable()
        t0 = time.perf_counter_ns() / 1000.0
        with faults.inject("comms.collective", delay=0.05,
                           match={"op": "all_reduce"}):
            comms.finish(comms.start("all_reduce", "world", 64), _out(side))
        arr = _events(obs, "comms.arrival")[-1]
        span = _events(obs, "comms.all_reduce")[-1]
        out[side] = (arr["ts"] - t0 >= 0.05e6, span["dur"] >= 0.05e6,
                     faults.fired("comms.collective"))
    assert out["port"] == out["ref"] == (True, True, 1)


def test_disabled_mode_zero_alloc():
    assert not tobs.enabled()

    def window(iters):
        tracemalloc.start()
        base = tracemalloc.get_traced_memory()[0]
        for _ in range(iters):
            tcomms.finish(tcomms.start("all_reduce", "world", 64))
            tcomms.count("all_reduce", "world", 64)
            tcomms.note_reshard("all_gather", "sp", 64)
            tcomms.note_train_step(0.1, None)
        grown = tracemalloc.get_traced_memory()[0] - base
        tracemalloc.stop()
        return grown

    window(2000)
    assert window(2000) < 1024
    assert tcomms.family_records() == {}


def test_goodput_fractions_with_pinned_peaks():
    out = {}
    for side, (obs, comms, perf, _f) in SIDES.items():
        obs.enable()
        perf.set_device_peaks(1e12, 1e11)
        comms._STEP_COMMS[0] = 0.04
        comms.note_train_step(0.1, perf.CostModel(flops=3e10,
                                                  bytes_accessed=1e9))
        out[side] = (_nonzero(obs, "paddle_tpu_train_goodput_fraction"),
                     comms._STEP_COMMS[0])
    got, consumed = out["port"]
    assert consumed == 0.0
    assert set(got) == set(out["ref"][0]) == {("comms",), ("compute",),
                                              ("stall",)}
    for k, v in out["ref"][0].items():
        assert got[k] == pytest.approx(v)
    assert got[("compute",)] == pytest.approx(0.3)


def test_goodput_unknown_device_publishes_comms_fraction_only():
    out = {}
    for side, (obs, comms, perf, _f) in SIDES.items():
        obs.enable()
        assert perf.device_peaks() is None          # the CPU
        comms._STEP_COMMS[0] = 0.01
        comms.note_train_step(0.1, perf.CostModel(flops=1e9,
                                                  bytes_accessed=1e6))
        out[side] = set(_nonzero(obs, "paddle_tpu_train_goodput_fraction"))
    assert out["port"] == out["ref"] == {("comms",)}


def test_train_step_emits_goodput():
    """TrainStep publishes the goodput fractions with each roofline
    sample (a tiny GPT states its attention shape, so its steps have an
    expectation: comms, compute and stall with pinned peaks)."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    _jm, tm = twin_gpts()
    tm.train()
    tobs.enable()
    tperf.set_device_peaks(1e12, 1e11)
    step = TrainStep(tm, AdamW(learning_rate=1e-3,
                               parameters=tm.parameters()),
                     lambda m, ids: m(ids).float().square().mean())
    ids = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(np.int64)
    for _ in range(4):
        step(ids)
    step._read_timings()
    good = _nonzero(tobs, "paddle_tpu_train_goodput_fraction")
    assert set(good) == {("compute",), ("stall",)}   # comms 0.0: no series
    rows = tobs.snapshot()["paddle_tpu_train_goodput_fraction"]["series"]
    assert ("comms",) in rows
    assert sum(rows.values()) <= 1.0 + 1e-9


def test_family_records_shape():
    out = {}
    for side, (obs, comms, perf, _f) in SIDES.items():
        obs.enable()
        perf.set_interconnect_peaks(ici=1e9)
        for _ in range(3):
            comms.finish(comms.start("all_reduce", "world", 4096),
                         _out(side))
        rec = comms.family_records()["comms_all_reduce"]
        assert rec["achieved_bytes_per_s"] > 0
        assert rec["utilization_ici"] == pytest.approx(
            rec["achieved_bytes_per_s"] / 1e9, rel=0.05)
        obs.reset()
        out[side] = (sorted(rec), rec["runs"], rec["compiles"],
                     comms.family_records())
    assert out["port"] == out["ref"]
    assert out["port"][1:] == (3, 0, {})
