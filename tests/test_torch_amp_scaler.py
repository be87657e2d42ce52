"""paddle_tpu_torch's GradScaler, amp.decorate and the AMP support checks
against paddle_tpu's, on the same numpy values: AdamW on both sides,
the same Linear weights and inputs, a gradient poisoned with nan at
chosen steps. The cases of tests/test_numerics.py's GradScaler tests
that need no observability, and decorate's O2 in f16."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.amp import GradScaler as JScaler
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import cpu_place

W = 6
# f32: the same f32 forward and backward on both sides, sums in other
# orders (a few ulps in the gradients); AdamW divides m by sqrt(v), so a
# parameter moves by about lr a step and its error stays a few ulps of
# lr: 1e-6 absolute at lr 1e-2
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    # the layers are made on the default place: the CPU here
    with cpu_place():
        yield


def _arrays(seed):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((W, W)).astype(np.float32) / 2
          for _ in range(2)]
    bs = [rng.standard_normal((W,)).astype(np.float32) / 4
          for _ in range(2)]
    x = rng.standard_normal((4, W)).astype(np.float32)
    return ws, bs, x


class _Both:
    """Two Linear layers with tanh between them, on each side, with
    AdamW over their parameters (weights then biases, layer by layer)
    and a scaler each."""

    def __init__(self, seed=0, scaler_kw=None, lr=1e-2, o2_f16=False):
        ws, bs, x = _arrays(seed)
        self.jlin = [pt.nn.Linear(W, W) for _ in range(2)]
        self.tlin = [Linear(W, W) for _ in range(2)]
        for jl, tl, w, b in zip(self.jlin, self.tlin, ws, bs):
            jl.weight.set_value(pt.to_tensor(w))
            jl.bias.set_value(pt.to_tensor(b))
            with torch.no_grad():
                tl.weight.copy_(torch.from_numpy(w))
                tl.bias.copy_(torch.from_numpy(b))
        self.jp = [p for lyr in self.jlin for p in lyr.parameters()]
        self.tp = [p for lyr in self.tlin
                   for p in torch.nn.Module.parameters(lyr)]
        self.jopt = pt.optimizer.AdamW(learning_rate=lr, parameters=self.jp)
        self.topt = AdamW(learning_rate=lr, parameters=self.tp)
        self.o2 = o2_f16
        if o2_f16:
            self.jlin, self.jopt = pt.amp.decorate(
                self.jlin, self.jopt, level="O2", dtype="float16")
            self.tlin, self.topt = tamp.decorate(
                self.tlin, self.topt, level="O2", dtype="float16")
            self.jopt, self.topt = self.jopt[0], self.topt[0]
        self.jx, self.tx = pt.to_tensor(x), torch.from_numpy(x)
        kw = {"init_loss_scaling": 2.0 ** 8, **(scaler_kw or {})}
        self.js, self.ts = JScaler(**kw), GradScaler(**kw)

    def _forward(self, side):
        lin, x, ops, ac = ((self.jlin, self.jx, pt.ops, pt.amp.auto_cast)
                           if side == "j" else
                           (self.tlin, self.tx, torch, tamp.auto_cast))
        with ac(enable=self.o2, level="O2", dtype="float16"):
            h = ops.tanh(lin[0](x))
            y = lin[1](h)
        y = y.astype("float32") if side == "j" else y.float()
        return (y ** 2).mean()

    def backward(self, poison=False):
        """The scaled loss's backward on both sides; `poison` sets the
        first weight's gradient [0, 0] to nan on both."""
        self.js.scale(self._forward("j")).backward()
        self.ts.scale(self._forward("t")).backward()
        if poison:
            g = self.jp[0]._grad
            g._set_data(g._data.at[0, 0].set(float("nan")))
            self.tp[0].grad[0, 0] = float("nan")

    def step(self, poison=False):
        """One scaled step on both sides; returns whether each side ran
        its optimizer."""
        self.backward(poison)
        n = (self.jopt._step_count, self.topt._step_count)
        self.js.step(self.jopt)
        self.ts.step(self.topt)
        self.jopt.clear_grad()
        self.topt.clear_grad()
        return (self.jopt._step_count > n[0], self.topt._step_count > n[1])

    def params(self):
        return ([np.asarray(p._data, np.float32) for p in self.jp],
                [p.detach().float().numpy() for p in self.tp])


def _counters(s):
    return (s._scale, s._good_steps, s._bad_steps)


# (scaler keywords, steps poisoned) of 8 steps: a skip that halves the
# scale at once, two bad steps in a row that halve it once, and growth
# back after incr_every_n_steps good ones
SCHEDULES = {
    "decr_every_1": (dict(decr_every_n_nan_or_inf=1,
                          incr_every_n_steps=3), {1}),
    "decr_every_2": (dict(decr_every_n_nan_or_inf=2,
                          incr_every_n_steps=3), {2, 3}),
    "bad_good_bad": (dict(decr_every_n_nan_or_inf=2,
                          incr_every_n_steps=2), {1, 3, 4}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scaler_trajectory_matches_reference(name):
    """The parameters after every step, the scale, the good and bad step
    counts and each skip equal the reference's over a run with poisoned
    steps: the counts and the skips exactly, the parameters within
    F32_TOL."""
    kw, poisoned = SCHEDULES[name]
    b = _Both(scaler_kw=kw)
    scales = []
    for i in range(8):
        ran = b.step(poison=i in poisoned)
        assert ran == (i not in poisoned,) * 2, i
        assert _counters(b.ts) == _counters(b.js), i
        scales.append(b.ts._scale)
        for tp, jp in zip(*reversed(b.params())):
            np.testing.assert_allclose(tp, jp, **F32_TOL)
    # halved, then grown again
    assert min(scales) < 2.0 ** 8 and scales[-1] > min(scales)


def test_dynamic_scaling_skip_halve_recover():
    """Two bad steps in a row at decr_every_n_nan_or_inf=2 are both
    skipped and halve the scale once; incr_every_n_steps clean steps
    bring it back (test_numerics.py's injected-overflow case)."""
    b = _Both(scaler_kw=dict(init_loss_scaling=2.0 ** 10,
                             decr_every_n_nan_or_inf=2,
                             incr_every_n_steps=3))
    for _ in range(2):
        b.step()
    assert b.ts._scale == 2.0 ** 10
    w = b.tp[0].detach().clone()
    assert b.step(poison=True) == (False, False)
    assert b.step(poison=True) == (False, False)
    assert torch.equal(b.tp[0].detach(), w)
    assert b.ts._scale == b.js._scale == 2.0 ** 9
    for _ in range(3):
        b.step()
    assert b.ts._scale == b.js._scale == 2.0 ** 10


def test_scale_never_drops_below_one():
    b = _Both(scaler_kw=dict(init_loss_scaling=4.0,
                             decr_every_n_nan_or_inf=1))
    for _ in range(4):
        b.step(poison=True)
        assert _counters(b.ts) == _counters(b.js)
    assert b.ts._scale == 1.0


def test_one_unscale_and_one_sync_a_step():
    """One unscale pass and one host read a step (the reference's
    _unscale_stats contract): the only value scaler.step brings to the
    host is the found-inf flag."""
    b = _Both()
    reads = []
    cls = torch.Tensor
    orig = {n: getattr(cls, n) for n in ("__bool__", "item", "__float__",
                                         "__int__", "tolist")}

    def counting(name):
        def f(self, *a, **k):
            reads.append(name)
            return orig[name](self, *a, **k)
        return f

    for i in range(5):
        b.backward(poison=i == 2)
        try:
            for n in orig:
                setattr(cls, n, counting(n))
            b.ts.step(b.topt)
        finally:
            for n, f in orig.items():
                setattr(cls, n, f)
        b.topt.clear_grad()
        assert len(reads) == i + 1, reads
    assert b.ts._unscale_stats == {"dispatches": 5, "syncs": 5}


def test_explicit_unscale_not_applied_twice():
    """unscale_ then step (the clipping pattern) unscales once: the
    gradients after unscale_ are the scaled ones over the scale, step
    adds no second pass, and the parameters equal the reference's doing
    the same; the next step's own unscale runs again."""
    b = _Both()
    b.backward()
    scaled = [p.grad.clone() for p in b.tp]
    b.ts.unscale_(b.topt)
    b.js.unscale_(b.jopt)
    for p, g in zip(b.tp, scaled):
        torch.testing.assert_close(p.grad, g * (1.0 / 2 ** 8), rtol=0,
                                   atol=0)
    b.ts.step(b.topt)
    b.js.step(b.jopt)
    assert b.ts._unscale_stats["dispatches"] == 1
    for tp, jp in zip(*reversed(b.params())):
        np.testing.assert_allclose(tp, jp, **F32_TOL)
    b.topt.clear_grad()
    b.jopt.clear_grad()
    b.step()
    assert b.ts._unscale_stats["dispatches"] == 2
    for tp, jp in zip(*reversed(b.params())):
        np.testing.assert_allclose(tp, jp, **F32_TOL)


def test_state_dict_roundtrip_mid_decay():
    """A scaler one bad step into a decay of three, saved and loaded
    into a scaler built with other arguments: every field comes from the
    checkpoint, the dict equals the reference's, and the restored scaler
    finishes the decay where the original would."""
    kw = dict(init_loss_scaling=2.0 ** 10, incr_ratio=4.0, decr_ratio=0.25,
              incr_every_n_steps=7, decr_every_n_nan_or_inf=3)
    b = _Both(scaler_kw=kw)
    b.step()
    b.step()
    b.step(poison=True)
    assert b.ts._bad_steps == 1 and b.ts._scale == 2.0 ** 10
    sd = b.ts.state_dict()
    assert sd == b.js.state_dict()
    s2 = GradScaler()
    s2.load_state_dict(sd)
    for attr in ("_scale", "_incr_ratio", "_decr_ratio", "_incr_every",
                 "_decr_every", "_good_steps", "_bad_steps", "_found_inf",
                 "_dynamic"):
        assert getattr(s2, attr) == getattr(b.ts, attr), attr
    s3 = GradScaler()
    s3.set_state_dict(sd)
    assert s3.state_dict() == sd
    s2._found_inf = True
    s2.update()
    assert s2._bad_steps == 2
    s2._found_inf = True
    s2.update()
    assert s2._scale == 2.0 ** 10 * 0.25 and s2._bad_steps == 0


def test_loss_scaling_accessors_and_disabled_scaler():
    s, js = GradScaler(init_loss_scaling=512.0), JScaler(
        init_loss_scaling=512.0)
    got = s.get_loss_scaling()
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(np.asarray(js.get_loss_scaling()._data))
    s._good_steps = s._bad_steps = 3
    s.set_loss_scaling(64.0)
    assert (s._scale, s._good_steps, s._bad_steps) == (64.0, 0, 0)
    assert s.is_enable() and not GradScaler(enable=False).is_enable()
    # disabled: scale is the identity and step is the optimizer's step
    b = _Both()
    off = GradScaler(enable=False)
    loss = b._forward("t")
    assert off.scale(loss) is loss
    loss.backward()
    off.minimize(b.topt, loss)
    assert b.topt._step_count == 1 and off._unscale_stats["syncs"] == 0


def test_decorate_o2_f16_matches_reference():
    """decorate(level="O2", dtype="float16"): f16 parameters, f32
    masters made at the first step, the optimizer's multi_precision set;
    one scaled step equals the reference's. Both sides run the f16
    forward on the CPU (f16 products summed in f32 here, and by XLA
    there): the f16 gradients agree to an f16 ulp or two, AdamW's first
    step moves each master by ~lr in the sign of its gradient, so the
    masters agree to 1e-5 and the f16 parameters to an f16 ulp."""
    b = _Both(o2_f16=True)
    assert all(p.dtype == torch.float16 for p in b.tp)
    assert b.topt._multi_precision and b.jopt._multi_precision
    assert b.step() == (True, True)
    for p, jp in zip(b.tp, b.jp):
        mw = b.topt._master_weights[id(p)]
        assert mw.dtype == torch.float32 and p.dtype == torch.float16
        np.testing.assert_allclose(
            mw.numpy(), np.asarray(b.jopt._master_weights[id(jp)]),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            p.detach().float().numpy(), np.asarray(jp._data, np.float32),
            rtol=2 ** -10, atol=2 ** -14)
    # a poisoned f16 gradient is skipped on both sides
    assert b.step(poison=True) == (False, False)
    assert _counters(b.ts) == _counters(b.js)


def test_decorate_takes_names_and_dtypes_and_lists():
    m1, m2 = Linear(4, 4), Linear(4, 4)
    opt = AdamW(parameters=list(m1.parameters()) + list(m2.parameters()))
    ms, opts = tamp.decorate([m1, m2], [opt], level="O2",
                             dtype=torch.float16)
    assert ms == [m1, m2] and opts == [opt] and opt._multi_precision
    assert all(p.dtype == torch.float16 for m in ms for p in m.parameters())
    m3 = Linear(4, 4)
    assert tamp.decorate(m3, level="O1", dtype="float16") is m3
    assert m3.weight.dtype == torch.float32       # O1 casts nothing
    m4 = tamp.decorate(Linear(4, 4), dtype="bfloat16")
    assert m4.weight.dtype == torch.bfloat16


def test_support_checks_equal_the_reference():
    assert tamp.is_bfloat16_supported() == pt.amp.is_bfloat16_supported()
    assert tamp.is_float16_supported() == pt.amp.is_float16_supported()


def test_auto_cast_takes_float16():
    """f16 names no longer raise, and f16 flows through the O1/O2 rule:
    a white op's inputs go to f16, a black op's to f32, under O2 every
    other op's to f16 (the reference's dtypes, op for op)."""
    x = torch.randn(2, 8)
    w = torch.randn(8, 8)
    with tamp.auto_cast(dtype="float16"):
        assert tamp.amp_dtype() == torch.float16
        assert F.linear(x, w).dtype == torch.float16
        assert F.layer_norm(x.half(), torch.ones(8),
                            torch.zeros(8)).dtype == torch.float32
    with tamp.auto_cast(level="O2", dtype="float16"):
        assert tamp.maybe_cast_inputs("gelu", None, x)[0].dtype \
            == torch.float16
        assert tamp.maybe_cast_inputs("softmax", None, x.half())[0].dtype \
            == torch.float32
    with pt.amp.auto_cast(dtype="float16"):
        jy = pt.ops.linear(pt.to_tensor(x.numpy()), pt.to_tensor(w.numpy()))
    assert str(np.asarray(jy._data).dtype) == "float16"
    assert ptt.amp.amp_dtype() == torch.bfloat16      # restored
