"""paddle_tpu_torch.profiler against paddle_tpu.profiler on the CPU: the
same eager training script (two Linear layers, SGD) under a Profiler
session on each side gives the same per-op rows (op names and call
counts; the reference's test_profiler_ops.py cases), the dispatch
pointer swapped in and out, RecordEvent and observability spans in one
event stream with the same exported trace (names and nesting),
make_scheduler's states, and the registered FLAGS_benchmark. The device
timeline (torch.profiler's CUDA kernels) exists only on the card:
tests/test_torch_obs_cuda.py."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprof
import paddle_tpu.ops.registry as jreg
import paddle_tpu_torch as ptt
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
import paddle_tpu_torch.ops.registry as treg
from torch_port_helpers import cpu_place

SIDES = {"ref": (pt, jobs, jprof, jreg), "port": (ptt, tobs, tprof, treg)}


@pytest.fixture(autouse=True)
def _clean():
    for _p, obs, _pr, _r in SIDES.values():
        obs.disable()
        obs.reset()
    with cpu_place():
        yield
    for _p, obs, _pr, _r in SIDES.values():
        obs.disable()
        obs.reset()


def _train_steps(P, n):
    """The reference's test_profiler_ops.py script, weights from a numpy
    seed on both sides."""
    rng = np.random.default_rng(0)
    lins = [P.nn.Linear(32, 32) for _ in range(2)]
    for lin in lins:
        lin.weight.set_value(P.to_tensor(
            rng.standard_normal((32, 32)).astype(np.float32) / 8))
    params = lins[0].parameters() + lins[1].parameters()
    opt = P.optimizer.SGD(learning_rate=1e-3, parameters=params)
    x = P.to_tensor(rng.standard_normal((4, 32)).astype(np.float32))
    for _ in range(n):
        h = P.tanh(lins[0](x))
        loss = (lins[1](h) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def test_per_op_rows_equal_the_reference():
    rows = {}
    for side, (P, obs, prof, _r) in SIDES.items():
        p = prof.Profiler(timer_only=True)
        p.start()
        _train_steps(P, 5)
        p.stop()
        rows[side] = {k: v[0] for k, v in p.op_stats().items()}
        text = p.summary()
        assert "Operator Summary" in text and "tanh" in text
    common = {"linear", "tanh", "mean", "pow"}
    assert common <= set(rows["port"])
    assert {k: rows["port"][k] for k in common} == \
        {k: rows["ref"][k] for k in common}
    assert rows["port"]["linear"] == 10


def test_dispatch_pointer_swaps_and_sessions_reset():
    for side, (P, obs, prof, reg) in SIDES.items():
        assert reg.dispatch is reg._dispatch
        p = prof.Profiler(timer_only=True)
        p.start()
        try:
            assert reg.dispatch is reg._dispatch_profiled
            _train_steps(P, 2)
        finally:
            p.stop()
        assert reg.dispatch is reg._dispatch
        first = p.op_stats()["linear"][0]
        p2 = prof.Profiler(timer_only=True)
        with p2:
            _train_steps(P, 1)
        assert p2.op_stats()["linear"][0] < first


def _nesting(evs):
    by_id = {e["span_id"]: e for e in evs if "span_id" in e}
    return [(e["name"], by_id[e["parent_id"]]["name"]
             if e.get("parent_id") in by_id else None) for e in evs]


def test_one_event_stream_and_export(tmp_path):
    """RecordEvent and observability spans land in one ring; the
    profiler's export and the observability exporter see the same
    events, and a session leaves tracing as it found it."""
    out = {}
    for side, (P, obs, prof, _r) in SIDES.items():
        p = prof.Profiler(timer_only=True,
                          on_trace_ready=prof.export_chrome_tracing(
                              str(tmp_path / side), "w"))
        p.start()
        with prof.RecordEvent("user.region"):
            with obs.span("engine.step"):
                with obs.span("engine.prefill"):
                    pass
        ev = prof.RecordEvent("re")
        ev.begin()
        ev.end()
        ev.end()                                # idempotent
        p.stop()
        p.step()
        loaded = prof.load_profiler_result(
            str(tmp_path / side / "w.pb.trace.json"))["traceEvents"]
        obs_path = obs.export_chrome_trace(str(tmp_path / side / "o.json"))
        with open(obs_path) as f:
            obs_evs = json.load(f)["traceEvents"]
        out[side] = ([e["name"] for e in loaded], _nesting(loaded),
                     [e["name"] for e in obs_evs], obs.tracing.enabled(),
                     p.step_num, sorted(
                         line.split()[0] for line in
                         p.summary().splitlines()[2:]))
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["engine.prefill", "engine.step",
                              "user.region", "re"]
    assert out["port"][3] is False


@pytest.mark.parametrize("kw", [dict(closed=1, ready=1, record=2),
                                dict(closed=0, ready=1, record=3,
                                     repeat=2, skip_first=1)])
def test_make_scheduler_states_equal(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(12)] == [js(i).name for i in range(12)]
    assert [m.name for m in tprof.ProfilerTarget] == \
        [m.name for m in jprof.ProfilerTarget]
    assert [m.name for m in tprof.ProfilerState] == \
        [m.name for m in jprof.ProfilerState]


def test_flags_benchmark_registered_with_the_reference_default():
    assert ptt.get_flags("FLAGS_benchmark") == \
        pt.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
    ptt.set_flags({"FLAGS_benchmark": True})
    try:
        p = tprof.Profiler(timer_only=True)
        with p:
            _train_steps(ptt, 1)        # on the CPU: nothing to wait for
        assert p.op_stats()["tanh"][0] == 1
    finally:
        ptt.set_flags({"FLAGS_benchmark": False})


def test_no_device_trace_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device trace runs there")
    with tprof.Profiler() as p:
        _train_steps(ptt, 1)
    assert not [e for e in p.events() if "cat" in e]
