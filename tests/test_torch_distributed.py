"""The collectives, ``parallel`` and ``topology`` (paddle_tpu_torch.
distributed) against the reference's, ROADMAP Queue A item 26a.

Eager rank-major mode, on the CPU world of 8 ranks (the reference's 8
host devices; the port's rule reads the same ``XLA_FLAGS``): each case of
tests/test_distributed.py's ``TestCollectives`` and ``TestP2PMatching``
runs on both packages from the same numpy input. Max, min, broadcast,
gather, scatter and all_to_all results are exact; SUM and AVG within
rtol 1e-6 (XLA and torch add in different orders). Then
``TestTopologyFleet::test_hcg_axes``, ``TestDataParallel``, the
single-process recording cases of tests/test_comms_obs.py (the same
series and labels on both sides) and one two-rank job over gloo in
spawned processes (the launcher's environment, per-rank tensors,
DataParallel's gradient average), with a timeout of its own."""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu import observability as jobs
from paddle_tpu.observability import comms as jcomms
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import comms as tcomms
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg
from torch_port_helpers import cpu_place

SIDES = {"ref": (pt, jdist, jobs), "port": (ptt, tdist, tobs)}
EXACT = dict(rtol=0, atol=0)
SUM_TOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(autouse=True)
def _reset():
    # each package's per-(op, group) arrival counter survives obs.reset()
    # by design; other files in this process (the reference's
    # tests/test_comms_obs.py) count from where they find it, so it is
    # put back after each test
    seqs = [(c._SEQ, dict(c._SEQ)) for c in (jcomms, tcomms)]
    for _, d, obs in SIDES.values():
        d.destroy_process_group()
        obs.disable()
        obs.reset()
    jset_hcg(None)
    tset_hcg(None)
    with cpu_place():
        yield
    for _, d, obs in SIDES.values():
        d.destroy_process_group()
        obs.disable()
        obs.reset()
    jset_hcg(None)
    tset_hcg(None)
    for seq, saved in seqs:
        seq.clear()
        seq.update(saved)


def _both(fn):
    """fn(P, dist) -> numpy result on each side."""
    return [np.asarray(fn(P, d)) for P, d, _ in SIDES.values()]


def _eq(fn, tol=EXACT):
    want, got = _both(fn)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **tol)
    return got


# ---- TestCollectives ------------------------------------------------------
def test_world_is_eight_cpu_ranks():
    for _, d, _ in SIDES.values():
        d.init_parallel_env()
        assert d.get_world_size() == 8
        assert d.get_rank() == 0
        assert d.is_initialized()
        assert d.get_world_size_by_group(d.new_group()) == 8


def _all_reduce(op, x):
    def run(P, d):
        t = P.to_tensor(x)
        d.all_reduce(t, op=getattr(d.ReduceOp, op))
        return t.numpy()
    return run


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD", "AVG"])
def test_all_reduce(op):
    x = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    got = _eq(_all_reduce(op, x), SUM_TOL if op in ("SUM", "AVG", "PROD")
              else EXACT)
    np.testing.assert_allclose(
        got, np.broadcast_to(getattr(np, op.lower() if op != "AVG"
                                     else "mean")(x, 0), x.shape),
        rtol=1e-6)


def test_all_reduce_max_of_a_range():
    got = _eq(_all_reduce("MAX", np.arange(8.0)))
    np.testing.assert_array_equal(got, np.full(8, 7.0))


def test_broadcast():
    def run(P, d):
        x = P.to_tensor(np.arange(8.0))
        d.broadcast(x, src=3)
        return x.numpy()
    np.testing.assert_array_equal(_eq(run), np.full(8, 3.0))


def test_all_gather_concat_and_list():
    def run(P, d):
        x = P.to_tensor(np.arange(16, dtype=np.float32).reshape(8, 2))
        out = d.all_gather(x)
        assert out.shape == [8, 16]
        parts = []
        d.all_gather(parts, x)
        return np.concatenate([out.numpy().ravel()] +
                              [p.numpy().ravel() for p in parts])
    _eq(run)


def test_reduce_scatter():
    def run(P, d):
        out = d.reduce_scatter(P.to_tensor(
            np.arange(64, dtype=np.float32).reshape(8, 8)))
        assert out.shape == [8, 1]
        return out.numpy()
    _eq(run, SUM_TOL)


def test_reduce_scatter_into_a_tensor_from_a_list():
    def run(P, d):
        dst = P.to_tensor(np.zeros((8, 1), np.float32))
        src = [P.to_tensor(np.arange(64, dtype=np.float32).reshape(8, 8))]
        d.reduce_scatter(dst, src)
        return dst.numpy()
    _eq(run, SUM_TOL)


def test_all_to_all():
    g = 8
    x = np.zeros((g, g), np.float32)
    for r in range(g):
        x[r] = r * 10 + np.arange(g)   # rank r sends r*10+c to rank c
    got = _eq(lambda P, d: d.all_to_all(P.to_tensor(x)).numpy())
    np.testing.assert_array_equal(got, x.T)


def test_all_to_all_list_style():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)

    def run(P, d):
        outs = []
        d.alltoall(outs, [P.to_tensor(x[i]) for i in range(8)])
        return np.stack([o.numpy() for o in outs])
    _eq(run)


@pytest.mark.parametrize("style", ["list", "split"])
def test_scatter(style):
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)

    def run(P, d):
        t = P.to_tensor(np.zeros((8, 2), np.float32))
        if style == "list":
            d.scatter(t, [P.to_tensor(x[i, :2]) for i in range(8)])
        else:
            t = P.to_tensor(x)
            d.scatter(t, src=2)
        return t.numpy()
    _eq(run)


def test_subgroup():
    def run(P, d):
        g = d.new_group([0, 1, 2, 3])
        x = P.to_tensor(np.arange(4.0))
        d.all_reduce(x, group=g)
        return x.numpy()
    np.testing.assert_array_equal(_eq(run), np.full(4, 6.0))


def test_reduce_to_dst():
    def run(P, d):
        x = P.to_tensor(np.ones(8, np.float32))
        d.reduce(x, dst=2)
        return x.numpy()
    want = np.ones(8)
    want[2] = 8.0
    np.testing.assert_array_equal(_eq(run), want)


def test_async_work_and_torch_tensors():
    """sync_op=False gives a Work whose wait() finishes the call; a
    torch tensor is reduced in place and comes back as itself."""
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    t = ptt.to_tensor(x)
    w = tdist.all_reduce(t, sync_op=False)
    assert w.wait() is True and w.is_completed()
    raw = torch.from_numpy(x.copy())
    assert tdist.all_reduce(raw) is raw
    want = pt.to_tensor(x)
    jdist.all_reduce(want)
    np.testing.assert_allclose(t.numpy(), want.numpy(), **SUM_TOL)
    np.testing.assert_allclose(raw.numpy(), want.numpy(), **SUM_TOL)


def test_rank_major_shape_is_checked():
    for P, d, _ in SIDES.values():
        with pytest.raises(ValueError, match="rank-major"):
            d.all_reduce(P.to_tensor(np.ones((3, 2), np.float32)))


# ---- TestP2PMatching ------------------------------------------------------
def test_recv_matches_destination_in_pair_group():
    def run(P, d):
        d.init_parallel_env()
        g = d.new_group([2, 5])
        a = P.to_tensor(np.full((4,), 1.0, np.float32))
        b = P.to_tensor(np.full((4,), 2.0, np.float32))
        d.send(a, dst=5, group=g)
        d.send(b, dst=2, group=g)
        out = P.to_tensor(np.zeros((4,), np.float32))
        d.recv(out, src=5, group=g)      # addressed to rank 2
        out2 = P.to_tensor(np.zeros((4,), np.float32))
        d.recv(out2, src=2, group=g)     # addressed to rank 5
        return np.stack([out.numpy(), out2.numpy()])
    np.testing.assert_array_equal(_eq(run), [[2.0] * 4, [1.0] * 4])


def test_recv_without_send_raises():
    for P, d, _ in SIDES.values():
        d.init_parallel_env()
        g = d.new_group([0, 1])
        with pytest.raises(RuntimeError, match="no outstanding send"):
            d.recv(P.to_tensor(np.zeros((4,), np.float32)), src=1, group=g)


def test_recv_no_match_for_receiver_raises():
    def run(P, d):
        d.init_parallel_env()
        g = d.new_group([0, 1])
        a = P.to_tensor(np.ones((2,), np.float32))
        d.send(a, dst=1, group=g)
        out = P.to_tensor(np.zeros((2,), np.float32))
        with pytest.raises(RuntimeError, match="addressed to rank 0"):
            d.recv(out, src=1, group=g)
        d.recv(out, src=0, group=g)
        return out.numpy()
    np.testing.assert_array_equal(_eq(run), np.ones(2))


def test_recv_no_group_rank_collision():
    def run(P, d):
        d.init_parallel_env()
        g = d.new_group([1, 3])
        a = P.to_tensor(np.ones((2,), np.float32))
        d.send(a, dst=1, group=g)
        out = P.to_tensor(np.zeros((2,), np.float32))
        with pytest.raises(RuntimeError, match="addressed to rank 3"):
            d.recv(out, src=1, group=g)
        d.recv(out, src=3, group=g)
        return out.numpy()
    np.testing.assert_array_equal(_eq(run), np.ones(2))


def test_batch_isend_irecv():
    def run(P, d):
        g = d.new_group([0, 1])
        a = P.to_tensor(np.full((3,), 7.0, np.float32))
        out = P.to_tensor(np.zeros((3,), np.float32))
        works = d.batch_isend_irecv([d.P2POp(d.isend, a, 1, g),
                                     d.P2POp(d.irecv, out, 0, g)])
        for w in works:
            w.wait()
        return out.numpy()
    np.testing.assert_array_equal(_eq(run), np.full(3, 7.0))


# ---- TestTopologyFleet / TestDataParallel ---------------------------------
def test_hcg_axes():
    for _, d, _ in SIDES.values():
        hcg = d.HybridCommunicateGroup(dp=2, mp=2, pp=2)
        assert hcg.get_data_parallel_world_size() == 2
        assert hcg.get_model_parallel_world_size() == 2
        assert hcg.get_pipe_parallel_world_size() == 2
        assert hcg.mesh.shape == {"dp": 2, "pp": 2, "sharding": 1,
                                  "sep": 1, "mp": 2}
        assert hcg.get_parallel_mode() == "pipeline"
        assert hcg.get_dp_sep_parallel_group().nranks == 2
        assert hcg.topology().get_coord(5) == (1, 0, 0, 0, 1)
    with pytest.raises(ValueError, match="needs 16 devices"):
        tdist.HybridCommunicateGroup(dp=4, mp=4)


def test_data_parallel_wrapper_delegates_and_trains():
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    out = []
    for P, d, _ in SIDES.values():
        d.init_parallel_env()
        inner = P.nn.Linear(8, 4)
        inner.weight.set_value(w)
        dp = d.DataParallel(inner)
        assert len(dp.parameters()) == len(inner.parameters())
        assert set(dp.state_dict()) == set(inner.state_dict())
        loss = dp.scale_loss((dp(P.to_tensor(x)) ** 2).mean())
        loss.backward()
        assert dp.apply_collective_grads() is None   # rank-major: no-op
        assert inner.weight.grad is not None
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
        w0 = inner.weight.numpy().copy()
        opt.step()
        assert not np.allclose(inner.weight.numpy(), w0)
        out.append(inner.weight.numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-7)


def test_data_parallel_state_dict_round_trip():
    for P, d, _ in SIDES.values():
        d.init_parallel_env()
        inner = P.nn.Linear(4, 4)
        dp = d.DataParallel(inner)
        inner2 = P.nn.Linear(4, 4)
        d.DataParallel(inner2).set_state_dict(dict(dp.state_dict()))
        np.testing.assert_array_equal(inner2.weight.numpy(),
                                      inner.weight.numpy())


def test_spawn_runs_once():
    for _, d, _ in SIDES.values():
        assert d.spawn(lambda a, b: a + b, args=(2, 3)) == 5
        env = d.ParallelEnv()
        assert (env.rank, env.world_size, env.nranks) == (0, 8, 8)


# ---- recording (tests/test_comms_obs.py's single-process cases) ----------
def _nonzero(obs, name):
    rec = obs.snapshot().get(name)
    out = {}
    for key, val in (rec["series"] if rec else {}).items():
        if isinstance(val, dict):
            if val["count"]:
                out[key] = val["count"]
        elif val:
            out[key] = val
    return out


def _every_collective(P, d):
    g = d.new_group()
    n = g.nranks
    x = np.ones((n, 8 * n), np.float32)
    d.all_reduce(P.to_tensor(x))
    d.reduce(P.to_tensor(x), dst=0)
    d.broadcast(P.to_tensor(x), src=0)
    d.all_gather(P.to_tensor(x))
    gathered = []
    d.all_gather(gathered, P.to_tensor(x))
    d.reduce_scatter(P.to_tensor(x))
    d.all_to_all(P.to_tensor(x))
    outs = []
    d.all_to_all(outs, [P.to_tensor(x[i]) for i in range(n)])
    d.scatter(P.to_tensor(x), src=0)
    d.barrier()
    d.send(P.to_tensor(x[0]), dst=g.ranks[-1])
    d.recv(P.to_tensor(np.zeros_like(x[0])), src=g.ranks[0])


SERIES = ("paddle_tpu_collective_seconds",
          "paddle_tpu_collective_launches_total",
          "paddle_tpu_collective_bytes_total")


def test_every_eager_collective_records_as_the_reference():
    got = {}
    for side, (P, d, obs) in SIDES.items():
        obs.enable()
        _every_collective(P, d)
        got[side] = {s: _nonzero(obs, s) for s in SERIES}
        got[side]["events"] = sorted(
            (e["name"], e["args"].get("op", ""), e["args"].get("seq", 0))
            for e in obs.trace_events() if e["name"] == "comms.arrival")
        bw = _nonzero(obs, "paddle_tpu_collective_algbw_bytes_per_sec")
        assert bw[("all_reduce",)] > 0
        obs.disable()
        obs.reset()
    assert got["port"] == got["ref"]
    hist = got["port"]["paddle_tpu_collective_seconds"]
    assert {op for op, _ in hist} >= {
        "all_reduce", "reduce", "broadcast", "all_gather", "reduce_scatter",
        "all_to_all", "scatter", "barrier", "send", "recv"}
    assert hist[("all_gather", "world")] == 2
    assert got["port"]["paddle_tpu_collective_bytes_total"][
        ("all_reduce",)] == 8 * 8 * 4


def test_async_wait_closes_timing_and_is_idempotent():
    for P, d, obs in SIDES.values():
        obs.enable()
        x = np.ones((8, 16), np.float32)
        w = d.all_reduce(P.to_tensor(x), sync_op=False)
        assert _nonzero(obs, "paddle_tpu_collective_launches_total") == {
            ("all_reduce", "eager"): 1.0}
        assert _nonzero(obs, "paddle_tpu_collective_seconds") == {}
        assert w.wait() is True
        w.wait()
        assert _nonzero(obs, "paddle_tpu_collective_seconds") == {
            ("all_reduce", "world"): 1}
        obs.disable()
        obs.reset()


def test_link_utilization_honest_about_unknown_device():
    from paddle_tpu_torch.observability import perf
    tobs.enable()
    x = np.ones((8, 64), np.float32)
    tdist.all_reduce(ptt.to_tensor(x))
    assert _nonzero(tobs, "paddle_tpu_collective_link_utilization") == {}
    try:
        perf.set_interconnect_peaks(ici=1e9, dcn=1e8)
        tdist.all_reduce(ptt.to_tensor(x))
        util = _nonzero(tobs, "paddle_tpu_collective_link_utilization")
        assert set(util) == {("all_reduce", "ici"), ("all_reduce", "dcn")}
    finally:
        perf.set_interconnect_peaks()


def test_disabled_mode_records_nothing():
    for P, d, obs in SIDES.values():
        assert not obs.enabled()
        _every_collective(P, d)
        d.all_reduce(P.to_tensor(np.ones((8, 4), np.float32)),
                     sync_op=False).wait()
        assert obs.trace_events() == []
        for s in SERIES:
            assert _nonzero(obs, s) == {}


# ---- two ranks over gloo --------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_over_gloo():
    """Two spawned processes, the launcher's environment, per-rank CPU
    tensors: every collective's result is the function of both ranks'
    inputs; DataParallel averages the two ranks' gradients."""
    from torch_dist_cases import two_rank_worker
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=two_rank_worker, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(out.get(timeout=60) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
    for r in range(2):
        assert isinstance(res[r], dict), res[r]
    x = [np.arange(6, dtype=np.float32) + 10 * r for r in range(2)]
    for r in range(2):
        got = res[r]
        np.testing.assert_array_equal(got["world"], [2, r, 2, r])
        np.testing.assert_array_equal(got["all_reduce_sum"], x[0] + x[1])
        np.testing.assert_array_equal(got["all_reduce_max"], x[1])
        np.testing.assert_array_equal(got["all_reduce_min"], x[0])
        np.testing.assert_array_equal(got["all_reduce_prod"], x[0] * x[1])
        np.testing.assert_allclose(got["all_reduce_avg"],
                                   (x[0] + x[1]) / 2, rtol=1e-6)
        np.testing.assert_array_equal(got["all_reduce_tensor"], x[0] + x[1])
        np.testing.assert_array_equal(got["all_reduce_async"], x[0] + x[1])
        np.testing.assert_array_equal(got["reduce"],
                                      x[0] + x[1] if r == 1 else x[r])
        np.testing.assert_array_equal(got["broadcast"], x[1])
        np.testing.assert_array_equal(got["all_gather_list"], np.stack(x))
        np.testing.assert_array_equal(got["all_gather"], np.concatenate(x))
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      (x[0] + x[1])[3 * r:3 * r + 3])
        np.testing.assert_array_equal(
            got["all_to_all"], np.concatenate([x[0][3 * r:3 * r + 3],
                                               x[1][3 * r:3 * r + 3]]))
        np.testing.assert_array_equal(
            got["all_to_all_list"], np.stack([x[0][3 * r:3 * r + 3],
                                              x[1][3 * r:3 * r + 3]]))
        np.testing.assert_array_equal(
            got["scatter"], x[0][3 * r:3 * r + 3] + (100, 200)[r])
        np.testing.assert_array_equal(got["grad_after"],
                                      (res[0]["grad_before"]
                                       + res[1]["grad_before"]) / 2)
        np.testing.assert_array_equal(got["hcg"], [r, 2, 1])
        np.testing.assert_array_equal(got["hcg_dp_all_reduce"], x[0] + x[1])
        np.testing.assert_array_equal(got["destroyed"], [0])
    np.testing.assert_array_equal(res[1]["recv"], x[0])
    assert not np.array_equal(res[0]["grad_before"], res[1]["grad_before"])
