"""The explicit pipeline schedules (paddle_tpu_torch.distributed.
meta_parallel.pipeline_schedules and pipeline_parallel, ROADMAP item 26b)
against the reference's: tests/test_pipeline_schedules.py's 13 cases.

The generation cases hold every unit list exactly equal to the
reference's (kind, part, micro, stage and simulated cycle), then assert
the reference case's own properties on the port's. The execution cases
build the same pipeline in both packages (fleet dp 2 x mp 2 x pp 2, the
reference's weights carried by name) and hold the port's loss and
gradients under each schedule to the reference's legacy per-micro loop
on those weights (f32, rtol 1e-5, atol 1e-6; the reference case holds
its own schedules to its loop at rtol 1e-4). The reference's loop runs
unplaced (one device, no GSPMD compile per op): the function is the
placed one's. The pytree cases thread (hidden, mask) tuples across part
boundaries, which the port flattens by the reference's rule (a None
entry is no leaf)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu.distributed.meta_parallel import pipeline_schedules as jps
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu_torch.distributed.meta_parallel.pipeline_schedules import (
    _tree_leaves, build_schedule, max_in_flight)
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _reset_groups():
    for d in (jdist, tdist):
        d.destroy_process_group()
    jset_hcg(None)
    tset_hcg(None)
    with cpu_place():
        yield
    for d in (jdist, tdist):
        d.destroy_process_group()
    jset_hcg(None)
    tset_hcg(None)


def _same_units(mode, *args):
    got = build_schedule(mode, *args)
    want = jps.build_schedule(mode, *args)
    assert [(u.kind, u.part, u.micro, u.stage, u.cycle) for u in got] == \
        [(u.kind, u.part, u.micro, u.stage, u.cycle) for u in want]
    return got


def _check_dependencies(order, num_parts):
    done_f, done_b = set(), set()
    for u in order:
        if u.kind == "F":
            if u.part > 0:
                assert (u.part - 1, u.micro) in done_f, u
            done_f.add((u.part, u.micro))
        else:
            assert (u.part, u.micro) in done_f, u
            if u.part < num_parts - 1:
                assert (u.part + 1, u.micro) in done_b, u
            done_b.add((u.part, u.micro))
    return done_f, done_b


# ---- TestScheduleGeneration -----------------------------------------------
def test_1f1b_warmup_steady_drain():
    p, n = 4, 8
    order = _same_units("1F1B", p, n)
    done_f, done_b = _check_dependencies(order, p)
    assert len(done_f) == len(done_b) == p * n
    last = [u for u in order if u.stage == p - 1]
    assert [u.kind for u in last[:4]] == ["F", "B", "F", "B"]
    s0 = [u for u in order if u.stage == 0]
    first_b = next(i for i, u in enumerate(s0) if u.kind == "B")
    assert first_b == p
    assert max_in_flight(order, p) == [p - s for s in range(p)] == \
        jps.max_in_flight(jps.build_schedule("1F1B", p, n), p)


def test_fthenb_holds_everything():
    p, n = 4, 8
    order = _same_units("FThenB", p, n)
    _check_dependencies(order, p)
    assert max_in_flight(order, p) == [n] * p


def test_1f1b_beats_fthenb_on_memory():
    p, n = 4, 16
    f = max_in_flight(_same_units("FThenB", p, n), p)
    o = max_in_flight(_same_units("1F1B", p, n), p)
    assert max(o) < max(f)


def test_interleaved_dependencies_and_warmup():
    p, n, v = 2, 4, 2
    order = _same_units("Interleaved1F1B", p, n, v)
    done_f, done_b = _check_dependencies(order, p * v)
    assert len(done_f) == len(done_b) == p * v * n
    for u in order:
        assert u.stage == u.part % p
    kinds = [u.kind for u in order]
    assert "B" in kinds[:kinds[::-1].index("F") * -1 or len(kinds)]
    # the shapes phase 40b of chip_smoke.py runs
    _same_units("Interleaved1F1B", 2, 4, 2)
    _same_units("1F1B", 1, 4)
    _same_units("FThenB", 1, 4)


def test_overlap_cycles_use_disjoint_stages():
    order = _same_units("1F1B", 4, 8)
    by_cycle = {}
    for u in order:
        by_cycle.setdefault(u.cycle, []).append(u.stage)
    for c, stages in by_cycle.items():
        assert len(stages) == len(set(stages)), (c, stages)


def test_bad_modes_raise():
    for mode, args in (("zigzag", (2, 4)), ("Interleaved1F1B", (2, 4, 1)),
                       ("1F1B", (2, 4, 2))):
        with pytest.raises(ValueError) as want:
            jps.build_schedule(mode, *args)
        with pytest.raises(ValueError) as got:
            build_schedule(mode, *args)
        assert str(got.value) == str(want.value)


# ---- TestScheduledExecution ---------------------------------------------
def _linear_descs(P):
    mp = P.distributed.meta_parallel
    return [mp.LayerDesc(P.nn.Linear, 16, 32),
            mp.LayerDesc(P.nn.Linear, 32, 32),
            mp.LayerDesc(P.nn.Linear, 32, 16),
            mp.LayerDesc(P.nn.Linear, 16, 8)]


def _pipe(P, schedule_mode, descs, loss_fn, accumulate_steps=4, v=1):
    """The reference case's _build_pipe on package P."""
    strategy = P.distributed.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 2}
    cfg = {"accumulate_steps": accumulate_steps}
    if schedule_mode is not None:
        cfg["schedule_mode"] = schedule_mode
    strategy.pipeline_configs = cfg
    P.distributed.fleet.init(strategy=strategy)
    model = P.distributed.meta_parallel.PipelineLayer(
        layers=descs(P), loss_fn=loss_fn(P),
        num_virtual_pipeline_stages=v if v > 1 else None)
    return P.distributed.fleet.distributed_model(model), model


def _mse(P):
    return lambda out, lbl: P.ops.mean((out - lbl) ** 2)


def _reference_loop(descs, loss_fn, data, seed):
    """The reference's legacy loop, unplaced, on weights drawn from
    `seed`: (loss, {name: grad}, {name: weight})."""
    jset_hcg(None)
    pt.seed(seed)
    model = jdist.meta_parallel.PipelineLayer(
        layers=descs(pt), loss_fn=loss_fn(pt), num_stages=2)
    strategy = jdist.fleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": 4}
    pipe = jdist.meta_parallel.PipelineParallel(
        model, jdist.HybridCommunicateGroup(), strategy)
    loss = float(pipe.forward_backward_pipeline(data(pt)).numpy())
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    weights = {k: np.asarray(v._data) for k, v in
               model.state_dict().items()}
    return loss, grads, weights


_REFS = {}


def _reference(key, descs, loss_fn, data, seed):
    if key not in _REFS:
        _REFS[key] = _reference_loop(descs, loss_fn, data, seed)
    return _REFS[key]


def _xy(P):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 8)).astype(np.float32)
    return [P.to_tensor(x), P.to_tensor(y)]


def _port_pipe(mode, weights, descs=_linear_descs, loss_fn=_mse, v=1):
    pipe, model = _pipe(ptt, mode, descs, loss_fn, v=v)
    names = [n for n, _ in torch.nn.Module.named_parameters(model)]
    # parts differ in name with v (stages.<part>.<i>): carried in order
    model.set_state_dict({n: ptt.to_tensor(w) for n, w in
                          zip(names, weights.values())})
    return pipe, model


def _grads_in_order(model):
    return [p.grad.numpy() for _, p in model.named_parameters()]


def _held(model, loss, want_loss, want_grads):
    np.testing.assert_allclose(float(loss.numpy()), want_loss, **TOL)
    got = _grads_in_order(model)
    assert len(got) == len(want_grads)
    for g, (k, w) in zip(got, want_grads.items()):
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def test_1f1b_matches_legacy_loop():
    want_loss, want_g, w = _reference("linear", _linear_descs, _mse, _xy, 7)
    pipe, model = _port_pipe(None, w)
    _held(model, pipe.forward_backward_pipeline(_xy(ptt)), want_loss,
          want_g)
    pipe2, model2 = _port_pipe("1F1B", w)
    _held(model2, pipe2.forward_backward_pipeline(_xy(ptt)), want_loss,
          want_g)
    assert pipe2.last_executed == [
        (u.kind, u.part, u.micro) for u in pipe2.last_schedule]
    assert any(k == "B" for k, _, _ in pipe2.last_executed[:-5])


def test_fthenb_matches_legacy_loop():
    want_loss, want_g, w = _reference("linear", _linear_descs, _mse, _xy, 7)
    pipe, model = _port_pipe("FThenB", w)
    _held(model, pipe.forward_backward_pipeline(_xy(ptt)), want_loss,
          want_g)
    kinds = [k for k, _, _ in pipe.last_executed]
    assert kinds.index("B") == kinds.count("F")


def test_interleaved_vpp_runs_and_matches():
    want_loss, want_g, w = _reference("linear", _linear_descs, _mse, _xy, 7)
    pipe, model = _port_pipe("Interleaved1F1B", w, v=2)
    assert model.num_parts == 4 and model.num_chunks == 2
    _held(model, pipe.forward_backward_pipeline(_xy(ptt)), want_loss,
          want_g)
    assert pipe.last_executed == [
        (u.kind, u.part, u.micro) for u in
        jps.build_schedule("Interleaved1F1B", 2, 4, 2)]


def test_train_batch_with_optimizer_1f1b():
    """Two train_batch calls: each loss equals the reference's loop
    with the reference's AdamW on the same weights."""
    want_loss, _, w = _reference("linear", _linear_descs, _mse, _xy, 7)
    pipe, model = _port_pipe("1F1B", w)
    opt = tdist.fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters()))
    l1 = pipe.train_batch(_xy(ptt), opt)
    l2 = pipe.train_batch(_xy(ptt), opt)
    np.testing.assert_allclose(float(l1.numpy()), want_loss, **TOL)
    assert np.isfinite(float(l2.numpy()))
    assert float(l2.numpy()) < float(l1.numpy())
    jset_hcg(None)
    pt.seed(7)
    jm = jdist.meta_parallel.PipelineLayer(
        layers=_linear_descs(pt), loss_fn=_mse(pt), num_stages=2)
    strategy = jdist.fleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": 4}
    jpipe = jdist.meta_parallel.PipelineParallel(
        jm, jdist.HybridCommunicateGroup(), strategy)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters())
    jpipe.train_batch(_xy(pt), jopt)
    np.testing.assert_allclose(
        float(l2.numpy()), float(jpipe.train_batch(_xy(pt), jopt).numpy()),
        **TOL)


def test_eval_batch_forward_only():
    want_loss, _, w = _reference("linear", _linear_descs, _mse, _xy, 7)
    pipe, model = _port_pipe("1F1B", w)
    loss = pipe.eval_batch(_xy(ptt))
    np.testing.assert_allclose(float(loss.numpy()), want_loss, **TOL)
    assert all(k == "F" for k, _, _ in pipe.last_executed)
    assert all(p.grad is None for p in model.parameters())


# ---- TestPytreeActivations ----------------------------------------------
def _tuple_block(P):
    class TupleBlock(P.nn.Layer):
        def __init__(self, din, dout):
            super().__init__()
            self.lin = P.nn.Linear(din, dout)

        def forward(self, inputs):
            if isinstance(inputs, tuple):
                h, mask = inputs
            else:
                h, mask = inputs, None
            h = P.ops.tanh(self.lin(h))
            if mask is not None:
                h = h * mask
            return (h, mask)
    return TupleBlock


def _tuple_descs(P):
    mp = P.distributed.meta_parallel
    B = _tuple_block(P)
    return [mp.LayerDesc(B, 16, 32), mp.LayerDesc(B, 32, 32),
            mp.LayerDesc(B, 32, 8), mp.LayerDesc(B, 8, 8)]


def _tuple_loss(P):
    return lambda out, lbl: P.ops.mean((out[0] - lbl) ** 2)


def _tuple_data(P):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    mask = (rng.random((8, 1)) > 0.3).astype(np.float32)
    y = rng.standard_normal((8, 8)).astype(np.float32)
    return [(P.to_tensor(x), P.to_tensor(mask)), P.to_tensor(y)]


def test_tuple_activations_train_under_1f1b():
    want_loss, want_g, w = _reference("tuple", _tuple_descs, _tuple_loss,
                                      _tuple_data, 11)
    pipe, model = _port_pipe("1F1B", w, _tuple_descs, _tuple_loss)
    loss = pipe.forward_backward_pipeline(_tuple_data(ptt))
    assert np.isfinite(float(loss.numpy()))
    assert len(_grads_in_order(model)) >= 4
    # the flatten rule: a None entry is no leaf, as in JAX
    t = ptt.to_tensor(np.ones(2, np.float32))
    assert _tree_leaves((1, None, [2, None])) == [1, 2]
    assert _tree_leaves((t, None)) == [t]


def test_tuple_matches_legacy_loop():
    want_loss, want_g, w = _reference("tuple", _tuple_descs, _tuple_loss,
                                      _tuple_data, 11)
    for mode in (None, "1F1B"):
        pipe, model = _port_pipe(mode, w, _tuple_descs, _tuple_loss)
        _held(model, pipe.forward_backward_pipeline(_tuple_data(ptt)),
              want_loss, want_g)
