"""paddle_tpu_torch's AMP, optimizers, LR schedulers, gradient clips and
optimizer-state carry-over against paddle_tpu's, on the same numpy
values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import ops
from paddle_tpu.amp import state as jstate
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer_state_from_numpy
from paddle_tpu_torch.amp import state as tstate
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

# the update math is the same f32 op sequence on both sides; XLA may
# contract a*b+c into one FMA or rewrite x/sqrt(y), so a few ulps apart
OPT_TOL = dict(rtol=2e-6, atol=2e-7)


def test_amp_lists_equal_the_reference():
    assert tstate.WHITE_LIST == jstate.WHITE_LIST
    assert tstate.BLACK_LIST == jstate.BLACK_LIST


def _dt(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x._data).dtype)


def _op_pairs(in_dtype):
    """(name, reference call, port call) for the ops GPT touches, on the
    same values (inputs of `in_dtype`, parameters f32)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, 64)).astype(np.float32)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    lbl = rng.integers(0, 64, (2, 128)).astype(np.int32)
    q = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
    J = lambda a: pt.to_tensor(a).astype(in_dtype)
    T = lambda a: torch.from_numpy(a).to(getattr(torch, in_dtype))
    JP, TP = pt.to_tensor, torch.from_numpy
    return [
        ("linear", lambda: ops.linear(J(x), JP(w), JP(b)),
         lambda: F.linear(T(x), TP(w), TP(b))),
        ("matmul", lambda: ops.matmul(J(x), JP(w), transpose_y=True),
         lambda: F.matmul(T(x), TP(w), transpose_y=True)),
        ("layer_norm", lambda: ops.layer_norm(J(x), JP(b), JP(b)),
         lambda: F.layer_norm(T(x), TP(b), TP(b))),
        ("sdpa", lambda: ops.scaled_dot_product_attention(
            J(q), J(q), J(q), is_causal=True),
         lambda: F.scaled_dot_product_attention(T(q), T(q), T(q),
                                                is_causal=True)),
        ("cross_entropy", lambda: ops.cross_entropy(J(x), JP(lbl)),
         lambda: F.cross_entropy(T(x), TP(lbl))),
        ("gelu", lambda: ops.gelu(J(x), approximate=True),
         lambda: F.gelu(T(x), approximate=True)),
    ]


# (input dtype, autocast dtype); the ids of the bf16 autocast cases are
# their input dtypes
CAST_CASES = [("float32", "bfloat16"), ("bfloat16", "bfloat16"),
              ("float32", "float16"), ("float16", "float16")]


@pytest.mark.parametrize("level", ["off", "O1", "O2"])
@pytest.mark.parametrize(
    "in_dtype,amp_dtype", CAST_CASES,
    ids=["float32", "bfloat16", "float32-f16cast", "float16-f16cast"])
def test_op_output_dtypes_under_autocast(level, in_dtype, amp_dtype):
    got, want = {}, {}
    for name, jcall, tcall in _op_pairs(in_dtype):
        with pt.amp.auto_cast(enable=level != "off",
                              level="O1" if level == "off" else level,
                              dtype=amp_dtype):
            want[name] = _dt(jcall())
        with ptt.amp.auto_cast(enable=level != "off",
                               level="O1" if level == "off" else level,
                               dtype=amp_dtype):
            got[name] = _dt(tcall())
    assert got == want
    assert not ptt.amp.is_auto_cast_enabled()


def test_autocast_keeps_gradients_on_f32_parameters():
    """A white op's cast of an f32 parameter stays inside autograd: the
    f32 parameter receives the gradient (in f32)."""
    w = torch.randn(8, 8, requires_grad=True)
    with ptt.amp.auto_cast(level="O1"):
        y = F.linear(torch.randn(4, 8), w)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad is not None and w.grad.dtype == torch.float32


def _params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(16, 8), (8,), (3, 5, 4)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    return ps, grads


OPTS = {
    "adam": (JAdam, Adam, dict(beta1=0.9, beta2=0.99, epsilon=1e-6)),
    "adam_l2": (JAdam, Adam, dict(weight_decay=0.05)),
    "adamw": (JAdamW, AdamW, dict(weight_decay=0.01)),
    "adamw_bf16_moments": (JAdamW, AdamW,
                           dict(weight_decay=0.1, moment_dtype="bfloat16")),
    "adamw_f16_moments": (JAdamW, AdamW,
                          dict(weight_decay=0.1, moment_dtype="float16")),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_step_matches_reference(name):
    jcls, tcls, kw = OPTS[name]
    ps, grads = _params()
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in ps]
    jo = jcls(learning_rate=3e-3, parameters=jp, **kw)
    to = tcls(learning_rate=3e-3, parameters=tp, **kw)
    for gs in grads:
        for p, g in zip(jp, gs):
            p._grad = pt.to_tensor(g)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._data),
                                   **OPT_TOL)
    for a, b in zip(tp, jp):
        ta, jb = to._accumulators[id(a)], jo._accumulators[id(b)]
        for k in ("moment1", "moment2"):
            assert str(ta[k].dtype).endswith(str(jb[k].dtype))
            np.testing.assert_allclose(ta[k].float().numpy(),
                                       np.asarray(jb[k], np.float32),
                                       rtol=1e-5, atol=1e-8)
        assert ta["beta1_pow"].dtype == torch.float32
        assert float(ta["beta2_pow"]) == float(jb["beta2_pow"])


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16_moments",
                                  "adamw_f16_moments"])
def test_functional_update_matches_reference(name):
    """functional_update, the reference's public name (out of place):
    an f32 lr scalar, first group's hyperparameters, no clip. TrainStep
    itself updates in place (test_train_step_update_matches_reference)."""
    jcls, tcls, kw = OPTS[name]
    ps, grads = _params(1)
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    tp = [torch.from_numpy(p.copy()) for p in ps]
    clip = dict(grad_clip=jclip.ClipGradByGlobalNorm(1e-3))
    jo = jcls(learning_rate=1e-2, parameters=jp, **kw, **clip)
    to = tcls(learning_rate=1e-2, parameters=tp, **kw,
              grad_clip=tclip.ClipGradByGlobalNorm(1e-3))
    jarr = [p._data for p in jp]
    jst = [jo._get_state(p) for p in jp]
    tst = [to._get_state(p) for p in tp]
    for gs in grads:
        jarr, jst = jo.functional_update(
            jarr, [jnp.asarray(g) for g in gs], jst,
            jnp.asarray(1e-2, jnp.float32))
        tp, tst = to.functional_update(
            tp, [torch.from_numpy(g.copy()) for g in gs], tst,
            torch.tensor(1e-2))
    for a, b in zip(tp, jarr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
    # no clip on this path: a clipped step would have moved ~1e-3 of it
    assert max(np.abs(a.numpy() - p).max() for a, p in zip(tp, ps)) > 0.03


class _Weights(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.ws = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays])


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16_moments",
                                  "adamw_f16_moments"])
def test_train_step_update_matches_reference(name):
    """TrainStep's update (in place, on every device): the loss
    sum(w * g) hands each parameter the gradient g exactly, so three
    TrainStep calls on the CPU take the reference's functional_update
    three times, first group's hyperparameters, no clip."""
    jcls, tcls, kw = OPTS[name]
    ps, grads = _params(1)
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    jo = jcls(learning_rate=1e-2, parameters=jp, **kw,
              grad_clip=jclip.ClipGradByGlobalNorm(1e-3))
    model = _Weights(ps)
    to = tcls(learning_rate=1e-2, parameters=model.parameters(), **kw,
              grad_clip=tclip.ClipGradByGlobalNorm(1e-3))

    def loss_fn(m, *gs):
        return sum((w * g).sum() for w, g in zip(m.ws, gs))

    step = ptt.TrainStep(model, to, loss_fn)
    jarr = [p._data for p in jp]
    jst = [jo._get_state(p) for p in jp]
    for gs in grads[:3]:
        jarr, jst = jo.functional_update(
            jarr, [jnp.asarray(g) for g in gs], jst,
            jnp.asarray(1e-2, jnp.float32))
        step(*gs)
    for a, b in zip(model.ws, jarr):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **OPT_TOL)
    for a, b in zip(model.ws, jst):
        ta = to._get_state(a)
        for k in ("moment1", "moment2"):
            assert str(ta[k].dtype).endswith(str(b[k].dtype))
            np.testing.assert_allclose(ta[k].float().numpy(),
                                       np.asarray(b[k], np.float32),
                                       rtol=1e-5, atol=1e-8)
        assert float(ta["beta2_pow"]) == float(b["beta2_pow"])
    # no clip on this path: a clipped step would have moved ~1e-3 of it
    assert max(np.abs(a.detach().numpy() - p).max()
               for a, p in zip(model.ws, ps)) > 0.02


def test_lr_schedulers_match_reference():
    def both(name, *a, **kw):
        return getattr(jlr, name)(*a, **kw), getattr(tlr, name)(*a, **kw)
    pairs = [
        both("StepDecay", 0.1, step_size=3, gamma=0.5),
        both("PolynomialDecay", 0.1, decay_steps=7, end_lr=0.001,
             power=2.0),
        both("CosineAnnealingDecay", 0.1, T_max=9),
        both("OneCycleLR", 0.1, total_steps=20),
        both("NoamDecay", 512, 4),
        (jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.1, 10), 5, 0.0, 0.1),
         tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.1, 10), 5, 0.0, 0.1)),
    ]
    for j, t in pairs:
        seq_j, seq_t = [], []
        for _ in range(20):
            seq_j.append(j())
            seq_t.append(t())
            j.step()
            t.step()
        assert seq_t == seq_j, type(t).__name__
        assert t.state_dict() == j.state_dict()


def test_scheduler_drives_the_optimizer_lr():
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[torch.zeros(2)])
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError):
        opt.set_lr(0.3)


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_clips_match_reference(kind):
    ps, grads = _params(2)
    gs = [g * 3 for g in grads[0]]
    j = {"global": jclip.ClipGradByGlobalNorm(1.5),
         "norm": jclip.ClipGradByNorm(2.0),
         "value": jclip.ClipGradByValue(0.5)}[kind]
    t = {"global": tclip.ClipGradByGlobalNorm(1.5),
         "norm": tclip.ClipGradByNorm(2.0),
         "value": tclip.ClipGradByValue(0.5)}[kind]
    want = j([(None, pt.to_tensor(g)) for g in gs])
    got = t([(None, torch.from_numpy(g.copy())) for g in gs])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                   rtol=1e-6, atol=1e-7)
    assert any(not np.allclose(a.numpy(), g) for (_, a), g in zip(got, gs))


def test_step_applies_grad_clip():
    p = torch.ones(4, requires_grad=True)
    opt = Adam(learning_rate=0.1, parameters=[p],
               grad_clip=tclip.ClipGradByValue(1e-12))
    p.grad = torch.full((4,), 5.0)
    opt.step()
    # a clipped gradient of 1e-12 still moves Adam by ~lr (sign), while
    # the moments see the clipped value
    assert float(opt._accumulators[id(p)]["moment1"].abs().max()) < 1e-12


def test_optimizer_state_from_numpy_round_trip():
    """A paddle_tpu AdamW checkpoint carried into the port by name: the
    state dict round-trips, and one more step continues identically."""
    ps, grads = _params(3)
    jp = [pt.to_tensor(p, stop_gradient=False) for p in ps]
    jo = JAdamW(learning_rate=1e-2, parameters=jp, weight_decay=0.01)
    for gs in grads[:2]:
        for p, g in zip(jp, gs):
            p._grad = pt.to_tensor(g)
        jo.step()
    sd = {k: (v if k == "global_step" else np.asarray(v._data))
          for k, v in jo.state_dict().items()}
    names = {p.name: f"layer.{i}.weight" for i, p in enumerate(jp)}
    tp = [(f"layer.{i}.weight",
           torch.from_numpy(np.asarray(p._data).copy()).requires_grad_())
          for i, p in enumerate(jp)]
    to = AdamW(learning_rate=1e-2, parameters=tp, weight_decay=0.01)
    to.set_state_dict(optimizer_state_from_numpy(sd, names))
    back = to.state_dict()
    assert back["global_step"] == 2
    assert len(back) == len(sd)
    for ref_key, v in sd.items():
        if ref_key == "global_step":
            continue
        pname, acc = next((p, ref_key[len(p) + 1:]) for p in names
                          if ref_key.startswith(p + "_"))
        got = back[f"{names[pname]}_{acc}"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(v, np.float32))
    for (_, p), g in zip(tp, grads[2]):
        p.grad = torch.from_numpy(g.copy())
    for p, g in zip(jp, grads[2]):
        p._grad = pt.to_tensor(g)
    to.step()
    jo.step()
    for (_, a), b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._data),
                                   **OPT_TOL)


def test_f16_parameters_and_state_from_numpy():
    """f16 arrays carry over as f16 tensors: a model's f16 parameters,
    and a reference checkpoint of f16 parameters under multi_precision
    with f16 moments (f32 masters); one more step from it continues as
    the reference's. The masters and the update are f32 on both sides
    (OPT_TOL); the f16 parameters are the masters' casts."""
    from paddle_tpu_torch import gpt_params_from_numpy
    named = {"w": np.arange(6, dtype=np.float16).reshape(2, 3) / 7}
    got = gpt_params_from_numpy(named)["w"]
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), named["w"])
    ps, grads = _params(4)
    jp = [pt.to_tensor(p.astype(np.float16), stop_gradient=False)
          for p in ps]
    kw = dict(learning_rate=1e-2, weight_decay=0.01, multi_precision=True,
              moment_dtype="float16")
    jo = JAdamW(parameters=jp, **kw)
    for gs in grads[:2]:
        for p, g in zip(jp, gs):
            p._grad = pt.to_tensor(g.astype(np.float16))
        jo.step()
    sd = {k: (v if k == "global_step" else np.asarray(v._data))
          for k, v in jo.state_dict().items()}
    assert any(k.endswith("_moment1") and v.dtype == np.float16
               for k, v in sd.items())
    names = {p.name: f"p{i}" for i, p in enumerate(jp)}
    tp = [(f"p{i}", _to_port(np.asarray(p._data)).requires_grad_())
          for i, p in enumerate(jp)]
    assert all(t.dtype == torch.float16 for _, t in tp)
    to = AdamW(parameters=tp, **kw)
    to.set_state_dict(optimizer_state_from_numpy(sd, names))
    st = to._get_state(tp[0][1])
    assert st["moment1"].dtype == torch.float16
    for (_, p), g in zip(tp, grads[2]):
        p.grad = torch.from_numpy(g.astype(np.float16))
    for p, g in zip(jp, grads[2]):
        p._grad = pt.to_tensor(g.astype(np.float16))
    to.step()
    jo.step()
    for (_, a), b in zip(tp, jp):
        np.testing.assert_allclose(to._master_weights[id(a)].numpy(),
                                   np.asarray(jo._master_weights[id(b)]),
                                   **OPT_TOL)
        np.testing.assert_array_equal(
            a.detach().numpy(),
            to._master_weights[id(a)].to(torch.float16).numpy())


def _to_port(arr):
    from paddle_tpu_torch.convert import _to_tensor
    return _to_tensor(arr)
