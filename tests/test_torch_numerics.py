"""The port's numerics plane (paddle_tpu_torch.observability.numerics and
its hooks in Optimizer.step, TrainStep, GradScaler and the reverse pass)
against the reference's (tests/test_numerics.py's classes), at its sizes:
a 3-layer MLP of width 8 and two Linear layers of width 6, the same numpy
weights and inputs on both sides.

Records are compared key by key with the reference's: f32 norms within
rel 1e-5 (the two frameworks sum the same f32 gradients in other orders,
a few ulps apart), counts, sources, steps, sentinel reasons, flight
bundle counts and pull counts exactly. A parameter is compared by its
position in the optimizer's list: the two packages name their
parameters differently. The update ratio divides ‖new w − w‖ by ‖w‖, and
new w − w cancels: one ulp of w in an element of the new value is ~1e-4
of that element's update, so it is held within rel 1e-3, as the
reference's own test holds it against float64. The backward tap's
`segments` differs by design: the reference taps each fused segment of
its engine, the port one torch backward (1 a backward), pinned here."""
import math
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import observability as jobs
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.autograd import dispatch_queue as jdq
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.amp import GradScaler as TScaler
from paddle_tpu_torch.autograd import dispatch_queue as tdq
from paddle_tpu_torch.jit import TrainStep as TTrainStep
from paddle_tpu_torch.kernels import multi_tensor_adam as mta
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import numerics as tnum
from paddle_tpu_torch.resilience import faults as tfaults
from torch_port_helpers import cpu_place


def _ref_poison(p):
    g = p._grad
    g._set_data(g._data.at[0, 0].set(float("nan")))


def _port_poison(p):
    p._grad_holder().grad[0, 0] = float("nan")


SIDES = {
    "ref": types.SimpleNamespace(
        P=pt, num=jnum, obs=jobs, flight=jflight, faults=jfaults, dq=jdq,
        Scaler=JScaler, TrainStep=JTrainStep, fleet=jfleet,
        poison=_ref_poison),
    "port": types.SimpleNamespace(
        P=ptt, num=tnum, obs=tobs, flight=tflight, faults=tfaults, dq=tdq,
        Scaler=TScaler, TrainStep=TTrainStep, fleet=tfleet,
        poison=_port_poison),
}
NORM = dict(rel=1e-5)
RATIO = dict(rel=1e-3)


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_OPT", raising=False)
    with cpu_place():
        yield
    for S in SIDES.values():
        S.num.disable()
        S.num.reset_window()
        S.faults.clear_all()
        S.flight.disarm()
        S.obs.disable()
        S.obs.reset()
        S.dq.set_dispatch_mode("whole_graph")


def _weights(seed, n=3, width=8):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((width, width)).astype(np.float32),
           rng.standard_normal((width,)).astype(np.float32))
          for _ in range(n)]
    x = rng.standard_normal((4, width)).astype(np.float32)
    return ws, x


def _mlp(S, ws):
    layers = [S.P.nn.Linear(w.shape[0], w.shape[1]) for w, _b in ws]
    for lyr, (w, b) in zip(layers, ws):
        lyr.weight.set_value(S.P.to_tensor(w))
        lyr.bias.set_value(S.P.to_tensor(b))
    return layers


def _forward(S, layers, x):
    h = x
    for lyr in layers[:-1]:
        h = S.P.ops.tanh(lyr(h))
    return (layers[-1](h) ** 2).mean()


def _setup(S, seed, opt="SGD", n=3, width=8, **okw):
    """(layers, params, optimizer, step): tests/test_numerics.py's MLP
    and its eager step (backward, step, clear_grad)."""
    ws, x_np = _weights(seed, n, width)
    layers = _mlp(S, ws)
    params = [p for lyr in layers for p in lyr.parameters()]
    o = getattr(S.P.optimizer, opt)(learning_rate=1e-2, parameters=params,
                                   **okw)
    x = S.P.to_tensor(x_np)

    def step():
        _forward(S, layers, x).backward()
        o.step()
        o.clear_grad()
    return layers, params, o, step


def _norm_rec(rec, names):
    """A record with its parameter names replaced by their positions."""
    if rec is None:
        return None
    idx = {n: i for i, n in enumerate(names)}
    out = dict(rec)
    out["per_param"] = [(idx[n], v, c) for n, v, c in rec["per_param"]]
    if rec["first_nonfinite_param"] is not None:
        out["first_nonfinite_param"] = idx[rec["first_nonfinite_param"]]
    return out


def _close(a, b, tol):
    if a is None or b is None:
        return a is b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return a == pytest.approx(b, **tol)


def assert_records_equal(got, want):
    """`got` (port) against `want` (reference), both by _norm_rec: norms
    within NORM, the update ratio within RATIO, the rest exactly."""
    assert set(got) == set(want)
    for k in ("step", "source", "nonfinite", "first_nonfinite_param"):
        assert got[k] == want[k], k
    for k in ("grad_norm", "param_norm", "loss", "lr"):
        assert _close(got[k], want[k], NORM), (k, got[k], want[k])
    assert _close(got["update_ratio"], want["update_ratio"], RATIO)
    assert set(got["group_norms"]) == set(want["group_norms"])
    for g, v in want["group_norms"].items():
        assert _close(got["group_norms"][g], v, NORM), g
    assert [(i, c) for i, _v, c in got["per_param"]] == \
        [(i, c) for i, _v, c in want["per_param"]]
    for (_i, a, _c), (_j, b, _d) in zip(got["per_param"],
                                        want["per_param"]):
        assert _close(a, b, NORM)
    if want["backward"] is None:
        assert got["backward"] is None
    else:
        assert got["backward"]["nonfinite"] == want["backward"]["nonfinite"]
        assert _close(got["backward"]["grad_norm"],
                      want["backward"]["grad_norm"], NORM)
        assert got["backward"]["segments"] == 1


def _names(S, params, opt):
    if S.P is ptt:
        return [opt._names[id(p._data)] for p in params]
    return [p.name for p in params]


def _series(S, name):
    rec = S.obs.snapshot().get(name)
    return {k: v for k, v in (rec["series"] if rec else {}).items() if v}


def _both(fn):
    """fn(S) on each side: {"ref": ..., "port": ...}."""
    return {side: fn(S) for side, S in SIDES.items()}


# ---------------------------------------------------------------------------
# the statistics against the reference's
# ---------------------------------------------------------------------------
class TestInStepStats:
    def test_fused_optimizer_stats_equal_the_reference(self):
        def run(S):
            _l, params, opt, step = _setup(S, 0)
            S.obs.enable()
            S.num.enable(interval=1)
            step()
            rec = _norm_rec(S.num.flush(), _names(S, params, opt))
            return rec, {n: _series(S, n) for n in (
                "paddle_tpu_train_grad_norm", "paddle_tpu_train_param_norm",
                "paddle_tpu_train_update_ratio")}
        out = _both(run)
        (got, gs), (want, ws) = out["port"], out["ref"]
        assert got["source"] == "optimizer_fused"
        assert_records_equal(got, want)
        assert set(gs["paddle_tpu_train_grad_norm"]) == {("all",), ("g0",)}
        for name, rows in ws.items():
            assert set(gs[name]) == set(rows)
            for k, v in rows.items():
                assert gs[name][k] == pytest.approx(
                    v, **(RATIO if "ratio" in name else NORM))

    @pytest.mark.parametrize("opt", ["Adam", "AdamW"])
    def test_multi_tensor_update_stats_equal_the_reference(self, opt):
        """The update with a multi-tensor form (Adam, AdamW: the kernel's
        statistics variant on the card, its plain version here), two
        groups with their own decays, three steps."""
        def run(S):
            ws, x_np = _weights(1)
            layers = _mlp(S, ws)
            o = getattr(S.P.optimizer, opt)(
                learning_rate=1e-2, weight_decay=0.01, parameters=[
                    {"params": layers[0].parameters()},
                    {"params": layers[1].parameters() +
                     layers[2].parameters(), "weight_decay": 0.1}])
            params = [p for lyr in layers for p in lyr.parameters()]
            x = S.P.to_tensor(x_np)
            S.obs.enable()
            S.num.enable(interval=1)
            recs = []
            for _ in range(3):
                _forward(S, layers, x).backward()
                o.step()
                o.clear_grad()
                recs.append(S.num.flush())
            return [_norm_rec(r, _names(S, params, o)) for r in recs]
        out = _both(run)
        for got, want in zip(out["port"], out["ref"]):
            assert got["source"] == "optimizer_fused"
            assert set(got["group_norms"]) == {"g0", "g1"}
            assert_records_equal(got, want)

    def test_whole_graph_backward_tap(self):
        """A backward-only loop: the tap alone gives the grad norm and
        nonfinite count, published by flush() as a backward record."""
        def run(S):
            ws, x_np = _weights(1)
            layers = _mlp(S, ws)
            S.num.enable(interval=1)
            with S.dq.backward_dispatch_mode("whole_graph"):
                _forward(S, layers, S.P.to_tensor(x_np)).backward()
            grads = [p.grad.numpy().astype(np.float64)
                     for lyr in layers for p in lyr.parameters()]
            return S.num.flush(), grads
        out = _both(run)
        (got, grads), (want, _g) = out["port"], out["ref"]
        assert got["source"] == want["source"] == "backward"
        assert_records_equal(_norm_rec(got, []), _norm_rec(want, []))
        gn = math.sqrt(sum(float(np.sum(g ** 2)) for g in grads))
        assert got["backward"]["grad_norm"] == pytest.approx(gn, **NORM)

    def test_tap_covers_what_the_backward_adds(self):
        """Two backwards before one step: each tap covers the cotangents
        its backward added, not the accumulated .grad."""
        def run(S):
            ws, x_np = _weights(2)
            layers = _mlp(S, ws)
            S.num.enable(interval=1)
            x = S.P.to_tensor(x_np)
            _forward(S, layers, x).backward()
            _forward(S, layers, x * 2.0).backward()
            return S.num.flush()
        out = _both(run)
        got = out["port"]
        assert got["backward"]["segments"] == 2
        assert_records_equal(_norm_rec({**got, "backward": dict(
            got["backward"], segments=1)}, []), _norm_rec(out["ref"], []))

    def test_eager_fallback_same_series(self, monkeypatch):
        """PADDLE_TPU_FUSED_OPT=0: the reference's every parameter takes
        the per-tensor rule; on both sides the record says
        optimizer_eager, with the same numbers, and no fused step is
        counted. The port's update still goes through its multi-tensor
        form (the kernel on the card), which computes the same rule."""
        monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "0")

        def run(S):
            _l, params, opt, step = _setup(S, 2, opt="Adam")
            S.obs.enable()
            S.num.enable(interval=1)
            n0 = mta.multi_tensor_adam.plain_calls
            step()
            return _norm_rec(S.num.flush(), _names(S, params, opt)), \
                _series(S, "paddle_tpu_optimizer_fused_step_total"), \
                mta.multi_tensor_adam.plain_calls - n0
        out = _both(run)
        assert out["port"][0]["source"] == "optimizer_eager"
        assert_records_equal(out["port"][0], out["ref"][0])
        assert out["port"][1] == out["ref"][1] == {}
        assert out["port"][2] == 1 and out["ref"][2] == 0

    def test_trainstep_stats_and_loss(self):
        def run(S):
            ws, x_np = _weights(3)
            layers = _mlp(S, ws)

            class M(S.P.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.ls = S.P.nn.LayerList(layers)

                def forward(self, x):
                    return _forward(S, list(self.ls), x)

            m = M()
            opt = S.P.optimizer.SGD(learning_rate=1e-2,
                                    parameters=m.parameters())
            S.obs.enable()
            S.num.enable(interval=1)
            ts = S.TrainStep(m, opt)
            x = S.P.to_tensor(x_np)
            losses = [float(np.asarray(ts(x).numpy())) for _ in range(3)]
            rec = S.num.flush()
            return rec, losses, S.num.pulls()
        out = _both(run)
        (got, losses, _pg), (want, _l, _pw) = out["port"], out["ref"]
        assert got["source"] == "train_step"
        assert got["loss"] == pytest.approx(losses[-1], rel=1e-6)
        # names: the model's parameter names on both sides
        assert [n for n, _v, _c in got["per_param"]] == \
            [n for n, _v, _c in want["per_param"]]
        assert_records_equal(_norm_rec(got, [n for n, _v, _c in
                                             got["per_param"]]),
                             _norm_rec(want, [n for n, _v, _c in
                                              want["per_param"]]))

    @pytest.mark.parametrize("fused", [True, False])
    def test_per_group_rows(self, fused, monkeypatch):
        if not fused:
            monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "0")

        def run(S):
            rng = np.random.default_rng(4)
            l1, l2 = S.P.nn.Linear(8, 8), S.P.nn.Linear(8, 8)
            for lyr in (l1, l2):
                for p in lyr.parameters():
                    p.set_value(S.P.to_tensor(rng.standard_normal(
                        p.shape).astype(np.float32)))
            opt = S.P.optimizer.SGD(
                learning_rate=1e-2,
                parameters=[{"params": l1.parameters()},
                            {"params": l2.parameters(),
                             "learning_rate": 0.5}])
            x = S.P.to_tensor(rng.standard_normal((4, 8)).astype(
                np.float32))
            S.obs.enable()
            S.num.enable(interval=1)
            (l2(S.P.ops.tanh(l1(x))) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
            params = l1.parameters() + l2.parameters()
            return (_norm_rec(S.num.flush(), _names(S, params, opt)),
                    set(_series(S, "paddle_tpu_train_grad_norm")))
        out = _both(run)
        (got, rows), (want, wrows) = out["port"], out["ref"]
        assert got["source"] == ("optimizer_fused" if fused
                                 else "optimizer_eager")
        assert set(got["group_norms"]) == {"g0", "g1"}
        assert rows == wrows == {("g0",), ("g1",), ("all",)}
        assert_records_equal(got, want)

    def test_sampling_cadence(self):
        def run(S):
            _l, _p, _o, step = _setup(S, 5)
            S.num.enable(interval=4)
            base = S.num.pulls()
            for _ in range(9):              # samples at ticks 0, 4, 8
                step()
            S.num.flush()
            return S.num.pulls() - base
        assert _both(run) == {"ref": 3, "port": 3}


# ---------------------------------------------------------------------------
# read-only taps: bit-identical training with the plane on vs off
# ---------------------------------------------------------------------------
class TestBitIdentical:
    @pytest.mark.parametrize("mode", ["whole_graph", "batched",
                                      "per_node"])
    @pytest.mark.parametrize("opt", ["Adam", "SGD"])
    def test_params_and_states_bit_identical(self, mode, opt):
        S = SIDES["port"]

        def run(plane_on):
            _l, params, o, step = _setup(S, 7, opt=opt)
            if plane_on:
                S.num.enable(interval=1)
            with S.dq.backward_dispatch_mode(mode):
                for _ in range(4):
                    step()
            S.num.disable()
            return ([p.numpy().tobytes() for p in params],
                    [{k: v.numpy().tobytes() for k, v in
                      o._accumulators[id(p._data)].items()}
                     for p in params])
        assert run(False) == run(True)

    def test_trainstep_bit_identical(self):
        S = SIDES["port"]
        ws, x_np = _weights(8)

        def run(plane_on):
            layers = _mlp(S, ws)

            class M(S.P.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.ls = S.P.nn.LayerList(layers)

                def forward(self, x):
                    return _forward(S, list(self.ls), x)

            m = M()
            opt = S.P.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=m.parameters())
            if plane_on:
                S.num.enable(interval=1)
            ts = S.TrainStep(m, opt)
            losses = [ts(S.P.to_tensor(x_np)).numpy().tobytes()
                      for _ in range(4)]
            S.num.disable()
            return losses, [p.numpy().tobytes() for p in m.parameters()]
        assert run(False) == run(True)


# ---------------------------------------------------------------------------
# the pull budget, the family budget, the disabled path
# ---------------------------------------------------------------------------
class TestBudgets:
    def test_at_most_one_pull_per_step(self):
        def run(S):
            _l, _p, _o, step = _setup(S, 8)
            S.num.enable(interval=1)
            base = S.num.pulls()
            for _ in range(6):
                step()
            mid = S.num.pulls() - base
            S.num.flush()
            return mid, S.num.pulls() - base
        assert _both(run) == {"ref": (5, 6), "port": (5, 6)}

    def test_stats_variant_is_one_more_compile(self):
        """A TrainStep signature gains exactly one compile when the plane
        turns on (its statistics variant), and none after."""
        S = SIDES["port"]
        ws, x_np = _weights(9)
        layers = _mlp(S, ws)

        class M(S.P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.ls = S.P.nn.LayerList(layers)

            def forward(self, x):
                return _forward(S, list(self.ls), x)

        m = M()
        ts = S.TrainStep(m, S.P.optimizer.SGD(learning_rate=1e-2,
                                              parameters=m.parameters()))
        S.obs.enable()
        x = S.P.to_tensor(x_np)
        compiles = []
        for on in (False, False, True, True, True):
            if on:
                S.num.enable(interval=1)
            ts(x)
            compiles.append(_series(S, "paddle_tpu_compile_total").get(
                ("train_step", "compile"), 0))
        assert compiles == [1, 1, 2, 2, 2]

    def test_disabled_mode_zero_alloc_and_zero_pulls(self):
        import tracemalloc
        num = tnum
        assert not tobs.enabled() and not num.enabled()
        base_pulls = num.pulls()

        def window(iters):
            tracemalloc.start()
            base = tracemalloc.get_traced_memory()[0]
            for _ in range(iters):
                num.note_backward_tap(None)
                num.submit(None, (), ())
                num.note_loss_scale(1.0)
                num.note_found_inf()
                num.want_stats()
            grown = tracemalloc.get_traced_memory()[0] - base
            tracemalloc.stop()
            return grown

        window(4000)
        g1, g2 = window(4000), window(4000)
        assert g2 < 1024, (g1, g2)
        assert num.pulls() == base_pulls
        assert num._PENDING is None and not num._STEP_TAPS

    def test_disabled_step_builds_no_table(self):
        _l, _p, opt, step = _setup(SIDES["port"], 10, opt="Adam")
        for _ in range(2):
            step()
        assert "_stats_tables" not in opt.__dict__


# ---------------------------------------------------------------------------
# chaos: the sentinel and its forensics
# ---------------------------------------------------------------------------
class TestChaosDivergence:
    def test_poisoned_gradient_exactly_one_bundle(self, tmp_path):
        def run(S):
            _l, params, opt, step = _setup(S, 10)
            names = _names(S, params, opt)
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.obs.enable()
            S.num.enable(interval=1)
            S.flight.arm(str(d))
            for _ in range(3):
                step()
            with S.faults.inject("numerics.check",
                                 exc=S.num.PoisonGradient(param=names[2]),
                                 times=1, match={"where": "step"}):
                step()
            for _ in range(3):
                step()
            S.num.flush()
            bundles = S.flight.bundles(str(d))
            b = S.flight.load_bundle(bundles[0])
            det = b["meta"]["detail"]
            rows = b["metrics"]["paddle_tpu_train_nonfinite_total"][
                "series"]
            spans = [e for e in b["trace"] if e["name"] == "numerics.check"]
            return dict(
                bundles=len(bundles), reason=b["meta"]["reason"],
                first=names.index(det["first_nonfinite_param"]),
                reasons=det["reasons"], loss_history=det["loss_history"],
                step=det["step"],
                grad_counted=any(s["labels"]["where"] == "grad"
                                 and s["value"] > 0 for s in rows),
                span_named=det["trace_id"] in {e.get("trace_id")
                                               for e in spans})
        out = _both(run)
        assert out["port"] == out["ref"]
        assert out["port"]["bundles"] == 1 and out["port"]["first"] == 2
        assert out["port"]["reason"] == "numerics_divergence"

    def test_clean_run_zero_bundles_zero_counts(self, tmp_path):
        def run(S):
            _l, _p, _o, step = _setup(S, 11)
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.obs.enable()
            S.num.enable(interval=1)
            S.flight.arm(str(d))
            for _ in range(4):
                step()
            S.num.flush()
            return (S.flight.bundles(str(d)),
                    _series(S, "paddle_tpu_train_nonfinite_total"))
        assert _both(run) == {"ref": ([], {}), "port": ([], {})}

    def test_latch_rearms_after_clean_step(self, tmp_path):
        def run(S):
            _l, params, _o, step = _setup(S, 12)
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.obs.enable()
            S.num.enable(interval=1)
            S.flight.arm(str(d))
            step()
            for _ in range(2):
                with S.faults.inject("numerics.check",
                                     exc=S.num.PoisonGradient(
                                         value=float("inf")),
                                     times=1, match={"where": "step"}):
                    step()
            rng = np.random.default_rng(13)
            for p in params:
                p.set_value(S.P.to_tensor(
                    rng.standard_normal(p.shape).astype(np.float32)))
            for _ in range(3):
                step()
            with S.faults.inject("numerics.check",
                                 exc=S.num.PoisonGradient(
                                     value=float("inf")),
                                 times=1, match={"where": "step"}):
                step()
            for p in params:
                p.set_value(S.P.to_tensor(
                    rng.standard_normal(p.shape).astype(np.float32)))
            step()
            S.num.flush()
            return len(S.flight.bundles(str(d)))
        assert _both(run) == {"ref": 2, "port": 2}

    def _fake_steps(self, S, scales):
        for scale in scales:
            g = S.P.to_tensor(np.full((16,), scale, np.float32))._data
            w = S.P.to_tensor(np.ones((16,), np.float32))._data
            S.num.submit(S.num.pack_stats([w], [g], [w - 0.01 * g]),
                         names=("w",), groups=("g0",), lr=0.01)

    def test_grad_spike_detection(self, tmp_path):
        def run(S):
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.num.enable(interval=1, spike_factor=5.0, min_window=4)
            S.obs.enable()
            S.flight.arm(str(d))
            self._fake_steps(S, [1.0] * 6 + [100.0])
            S.num.flush()
            bundles = S.flight.bundles(str(d))
            return [S.flight.load_bundle(b)["meta"]["detail"]["reasons"]
                    for b in bundles]
        assert _both(run) == {"ref": [["grad_spike"]],
                              "port": [["grad_spike"]]}

    def test_sustained_regime_change_releases_latch(self, tmp_path):
        def run(S):
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.num.enable(interval=1, spike_factor=5.0, min_window=4,
                         window=8)
            S.obs.enable()
            S.flight.arm(str(d))
            self._fake_steps(S, [1.0] * 6 + [20.0] * 12)
            S.num.flush()
            first = len(S.flight.bundles(str(d)))
            self._fake_steps(S, [float("nan")])
            S.num.flush()
            bundles = S.flight.bundles(str(d))
            return first, len(bundles), S.flight.load_bundle(
                bundles[-1])["meta"]["detail"]["reasons"]
        out = _both(run)
        assert out["port"] == out["ref"] == (1, 2, ["nonfinite"])

    def test_loss_scale_floor_fires(self, tmp_path):
        def run(S):
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.num.enable(interval=1, loss_scale_floor=4.0)
            S.flight.arm(str(d))
            S.num.note_loss_scale(32.0, decreased=True)
            before = S.flight.bundles(str(d))
            S.num.note_loss_scale(4.0, decreased=True)
            bundles = S.flight.bundles(str(d))
            det = S.flight.load_bundle(bundles[0])["meta"]["detail"]
            return (before, len(bundles), det["reasons"],
                    det["loss_scale_history"][-2:])
        out = _both(run)
        assert out["port"] == out["ref"] == (
            [], 1, ["loss_scale_floor"], [32.0, 4.0])


# ---------------------------------------------------------------------------
# AMP: the GradScaler's reports
# ---------------------------------------------------------------------------
def _scaler_loop(S, scaler, width=6, seed=20):
    ws, x_np = _weights(seed, n=2, width=width)
    lin = _mlp(S, ws)
    params = [p for lyr in lin for p in lyr.parameters()]
    opt = S.P.optimizer.SGD(learning_rate=1e-2, parameters=params)
    x = S.P.to_tensor(x_np)

    def step(poison=False):
        with S.dq.backward_dispatch_mode("whole_graph"):
            scaler.scale(_forward(S, lin, x)).backward()
            if poison:
                S.poison(params[0])
            scaler.step(opt)
            opt.clear_grad()
    return params, opt, step


class TestAMP:
    def test_dynamic_scaling_under_injected_overflow(self):
        def run(S):
            S.obs.enable()
            S.num.enable(interval=1)
            base = S.num.pulls()
            scaler = S.Scaler(init_loss_scaling=2.0 ** 10,
                              decr_every_n_nan_or_inf=2,
                              incr_every_n_steps=3)
            _p, _o, step = _scaler_loop(S, scaler)
            for _ in range(2):
                step()
            with S.faults.inject("numerics.check",
                                 exc=S.num.PoisonGradient(), times=2,
                                 match={"where": "amp"}):
                step()
                step()
            for _ in range(3):
                step()
            rec = S.num.flush()
            return (scaler._scale, {n: _series(S, n) for n in (
                "paddle_tpu_amp_steps_total",
                "paddle_tpu_amp_scale_decreases_total",
                "paddle_tpu_amp_loss_scale",
                "paddle_tpu_train_nonfinite_total")},
                S.num.pulls() - base, rec["step"], rec["source"])
        out = _both(run)
        assert out["port"] == out["ref"]
        scale, series, *_ = out["port"]
        assert scale == 2.0 ** 10
        assert series["paddle_tpu_train_nonfinite_total"] == {
            ("grad",): 2}

    def test_skipped_step_taps_do_not_leak(self, tmp_path):
        def run(S):
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.obs.enable()
            S.num.enable(interval=1)
            S.flight.arm(str(d))
            scaler = S.Scaler(init_loss_scaling=2.0 ** 8,
                              decr_every_n_nan_or_inf=10)
            _p, _o, step = _scaler_loop(S, scaler, seed=23)
            step()
            step(poison=True)
            drained = not S.num._STEP_TAPS
            step()
            step()
            rec = S.num.flush()
            return (drained, rec["nonfinite"], rec["backward"]["nonfinite"],
                    S.flight.bundles(str(d)))
        out = _both(run)
        assert out["port"] == out["ref"] == (
            True, {"grad": 0, "param": 0, "loss": 0}, 0, [])

    def test_floor_fires_once_and_set_loss_scaling_rearms(self, tmp_path):
        """A scale halved on every skipped step reaches the floor: one
        bundle with the scale history; set_loss_scaling re-arms, and the
        next collapse fires its own."""
        def run(S):
            d = tmp_path / ("ref" if S.P is pt else "port")
            S.num.enable(interval=1, loss_scale_floor=2.0)
            S.flight.arm(str(d))
            scaler = S.Scaler(init_loss_scaling=16.0,
                              decr_every_n_nan_or_inf=1)
            _p, _o, step = _scaler_loop(S, scaler, seed=24)
            with S.faults.inject("numerics.check",
                                 exc=S.num.PoisonGradient(),
                                 match={"where": "amp"}):
                for _ in range(5):
                    step()
                first = len(S.flight.bundles(str(d)))
                scaler.set_loss_scaling(8.0)
                for _ in range(3):
                    step()
            bundles = S.flight.bundles(str(d))
            det = S.flight.load_bundle(bundles[0])["meta"]["detail"]
            return (first, len(bundles), det["reasons"],
                    det["loss_scale_history"], scaler._scale)
        out = _both(run)
        assert out["port"] == out["ref"]
        assert out["port"][:3] == (1, 2, ["loss_scale_floor"])
        assert out["port"][3] == [8.0, 4.0, 2.0]


# ---------------------------------------------------------------------------
# plumbing: obs.reset, the fleet bundle, the flight reason
# ---------------------------------------------------------------------------
class TestPlumbing:
    def test_reset_clears_numerics_window(self):
        num = tnum
        num.enable(interval=1)
        one = torch.ones(4)
        num.submit(num.pack_stats([one], [one], [one]), names=("w",),
                   groups=("g0",))
        assert num._PENDING is not None
        tobs.reset()
        assert num._PENDING is None and num.last() is None
        assert num.enabled()

    def test_series_ride_fleet_farewell(self):
        def run(S):
            S.obs.enable()
            S.num.enable(interval=1)
            one = S.P.to_tensor(np.ones(4, np.float32))._data
            S.num.submit(S.num.pack_stats([one], [one], [one]),
                         names=("w",), groups=("g0",))
            S.num.flush()
            snap = S.fleet.worker_farewell()["metrics"]
            return {k: v for k, v in snap[
                "paddle_tpu_train_grad_norm"]["series"].items() if v}
        out = _both(run)
        assert out["port"] == out["ref"] and out["port"]

    def test_flight_reason_registered(self):
        assert "numerics_divergence" in tflight.TRIGGER_REASONS


# ---------------------------------------------------------------------------
# the statistics variant's plain version against pack_stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decoupled", [False, True])
def test_multi_tensor_stats_plain_equal_pack_stats(decoupled):
    """multi_tensor_adam(stats=...)'s plain version, laid out by
    pack_rows, equals pack_stats over a clone of the pre-update work
    arrays, the gradients and the new values, rows in `positions`
    order; the update equals the statistics-off update bit for bit."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(7, 5), (5,), (33,), (4, 4)]

    def slots():
        g2 = torch.Generator().manual_seed(1)
        out = []
        for i, sh in enumerate(shapes):
            w = torch.randn(sh, generator=g2)
            g = torch.randn(sh, generator=g2).to(
                torch.bfloat16 if i == 1 else torch.float32)
            out.append(mta.AdamSlot(
                w, g, torch.zeros(sh), torch.zeros(sh), torch.ones(()),
                torch.ones(()), wd=0.1 if i % 2 else 0.0))
        return out
    del gen
    on, off = slots(), slots()
    olds = [s.w.clone() for s in on]
    positions = [2, 0, 3, 1]
    table = torch.zeros(4, mta.STATS_COLS)
    lr = torch.tensor(1e-2)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled)
    mta.multi_tensor_adam(on, lr, stats=table, positions=positions, **kw)
    mta.multi_tensor_adam(off, lr, **kw)
    for a, b in zip(on, off):
        for k in ("w", "m", "v", "beta1_pow", "beta2_pow"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    order = sorted(range(4), key=lambda i: positions[i])
    want = tnum.pack_stats([olds[i] for i in order],
                           [on[i].g for i in order],
                           [on[i].w for i in order])
    got = mta.pack_rows(table)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
