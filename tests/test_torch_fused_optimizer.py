"""paddle_tpu_torch's multi-tensor optimizer step and multi_precision
master weights against paddle_tpu's fused and eager steps, on the CPU.

On the CPU the multi-tensor update (kernels/multi_tensor_adam.py) runs
its plain version, the per-tensor rule written into each tensor in
place; on the card the same call is one launch of the CUDA kernel
(tests/test_torch_train_graph_cuda.py holds the two together)."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import optimizer_state_from_numpy
from paddle_tpu_torch.convert import _to_tensor
from paddle_tpu_torch.kernels import multi_tensor_adam as mta
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import Adam, AdamW

LR, STEPS = 0.01, 3
# the reference's own limit between its fused and eager multi_precision
# steps (tests/test_fused_optimizer.py:52): a bf16 forward rounds the
# gradients differently in XLA and torch, and a bf16 parameter is one
# bf16 ulp (2^-8 relative) from its master
MP_TOL = dict(rtol=2e-2, atol=2e-2)


def _x():
    return np.random.default_rng(0).standard_normal((4, 16)).astype(
        np.float32)


def _reference(fused, dtype="bfloat16", mp=True, steps=STEPS, **kw):
    """tests/test_fused_optimizer.py's run: a seeded 16x16 Linear in
    `dtype`, AdamW(lr 0.01, weight decay 0.01), `steps` steps of
    mean((lin(x) in f32)^2). Returns (initial weights, the optimizer,
    the Linear)."""
    os.environ["PADDLE_TPU_FUSED_OPT"] = "1" if fused else "0"
    try:
        pt.seed(0)
        lin = pt.nn.Linear(16, 16)
        if dtype != "float32":
            lin = getattr(lin, dtype)()
        init = {n: np.asarray(p._data) for n, p in
                lin.named_parameters()}
        x = pt.to_tensor(_x()).astype(dtype)
        opt = JAdamW(learning_rate=LR, parameters=lin.parameters(),
                     multi_precision=mp, weight_decay=0.01, **kw)
        for _ in range(steps):
            loss = (lin(x).astype("float32") ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        return init, opt, lin
    finally:
        os.environ.pop("PADDLE_TPU_FUSED_OPT", None)


def _port(init, dtype="bfloat16", mp=True, steps=STEPS, **kw):
    tdt = getattr(torch, dtype)
    lin = Linear(16, 16, device="cpu", dtype=tdt)
    lin.load_state_dict({n: _to_tensor(a) for n, a in init.items()})
    x = torch.from_numpy(_x()).to(tdt)
    opt = AdamW(learning_rate=LR,
                parameters=torch.nn.Module.named_parameters(lin),
                multi_precision=mp, weight_decay=0.01, **kw)
    for _ in range(steps):
        loss = (lin(x).float() ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return opt, lin


def _f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("fused", [True, False], ids=["ref_fused",
                                                      "ref_eager"])
def test_multi_precision_adamw_matches_reference(fused):
    init, jopt, jlin = _reference(fused)
    n0 = mta.multi_tensor_adam.plain_calls
    topt, tlin = _port(init)
    # every parameter's work array is its f32 master: one multi-tensor
    # call a step
    assert mta.multi_tensor_adam.plain_calls - n0 == STEPS
    for (n, tp), jp in zip(torch.nn.Module.named_parameters(tlin),
                           jlin.parameters()):
        assert tp.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(tp), np.asarray(jp._data,
                                                        np.float32),
                                   **MP_TOL)
        tm = topt._master_weights[id(tp)]
        jm = jopt._master_weights[id(jp)]
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MP_TOL)
        # the parameter is its master's cast
        assert torch.equal(tp.detach(), tm.to(torch.bfloat16))
        assert not np.allclose(_f32(tp), init[n].astype(np.float32))


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"],
                         ids=["f32_moments", "bf16_moments"])
@pytest.mark.parametrize("fused", [True, False], ids=["ref_fused",
                                                      "ref_eager"])
def test_multi_precision_master_update_matches_reference(fused,
                                                         moment_dtype):
    """The master arithmetic alone, with no forward: the same bf16
    gradients (seeded, rounded once from f32) go into both sides'
    multi_precision AdamW over bf16 parameters in two groups with their
    own decays. With f32 moments, masters and moments agree within a
    few f32 ulps (XLA may contract a*b+c into one FMA), and each bf16
    parameter is its master's cast on both sides, so the parameters
    agree exactly. With bf16 moments, that ulp may round a moment one
    bf16 ulp (2^-7 relative at most) the other way; the update it
    feeds, at most about lr a step, then moves by that share, and the
    parameter by one bf16 ulp."""
    rng = np.random.default_rng(7)
    shapes = [(16, 8), (8,), (3, 5, 4), (33, 7)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]
    kw = {} if moment_dtype is None else dict(moment_dtype=moment_dtype)
    groups = lambda xs: [  # noqa: E731
        {"params": xs[:2], "weight_decay": 0.01},
        {"params": xs[2:], "weight_decay": 0.1}]
    jp = [pt.to_tensor(p, stop_gradient=False).astype("bfloat16")
          for p in ps]
    tp = [torch.from_numpy(p.copy()).to(torch.bfloat16).requires_grad_()
          for p in ps]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(_f32(a), np.asarray(b._data,
                                                          np.float32))
    jopt = JAdamW(learning_rate=LR, parameters=groups(jp),
                  multi_precision=True, **kw)
    topt = AdamW(learning_rate=LR, parameters=groups(tp),
                 multi_precision=True, **kw)
    os.environ["PADDLE_TPU_FUSED_OPT"] = "1" if fused else "0"
    try:
        for gs in grads:
            for p, g in zip(jp, gs):
                p._grad = pt.to_tensor(g).astype("bfloat16")
            for p, g in zip(tp, gs):
                p.grad = torch.from_numpy(g.copy()).to(torch.bfloat16)
            jopt.step()
            topt.step()
    finally:
        os.environ.pop("PADDLE_TPU_FUSED_OPT", None)
    if moment_dtype is None:
        master_tol, moment_tol = (dict(rtol=1e-6, atol=1e-7),
                                  dict(rtol=2e-6, atol=1e-8))
        param_tol = dict(rtol=0, atol=0)
    else:
        ulp = 2.0 ** -7
        master_tol = dict(rtol=0, atol=STEPS * LR * ulp)
        moment_tol = param_tol = dict(rtol=ulp, atol=1e-30)
    for a, b in zip(tp, jp):
        tm = topt._master_weights[id(a)]
        jm = np.asarray(jopt._master_weights[id(b)])
        np.testing.assert_allclose(tm.numpy(), jm, **master_tol)
        np.testing.assert_allclose(_f32(a), np.asarray(b._data, np.float32),
                                   **param_tol)
        assert torch.equal(a.detach(), tm.to(torch.bfloat16))
        tst, jst = topt._accumulators[id(a)], jopt._accumulators[id(b)]
        for k in ("moment1", "moment2"):
            assert str(tst[k].dtype).endswith(str(jst[k].dtype)), k
            np.testing.assert_allclose(_f32(tst[k]),
                                       np.asarray(jst[k], np.float32),
                                       err_msg=k, **moment_tol)
        for k in ("beta1_pow", "beta2_pow"):
            assert float(tst[k]) == float(np.asarray(jst[k])), k
    # the update took effect in both groups
    assert all(not np.array_equal(_f32(a), p.astype(np.float32))
               for a, p in zip(tp, ps))


def test_masters_are_f32_and_moments_follow_them():
    init, jopt, jlin = _reference(True, steps=1)
    topt, tlin = _port(init, steps=1)
    ps = list(torch.nn.Module.parameters(tlin))
    assert len(topt._master_weights) == len(ps) == 2
    assert all(m.dtype == torch.float32
               for m in topt._master_weights.values())
    for tp, jp in zip(ps, jlin.parameters()):
        tst, jst = topt._accumulators[id(tp)], jopt._accumulators[id(jp)]
        for k in ("moment1", "moment2"):
            assert tst[k].dtype == torch.float32
            assert str(jst[k].dtype) == "float32"
    # moment_dtype overrides the master's dtype, on both sides
    _, jopt, jlin = _reference(True, steps=1, moment_dtype="bfloat16")
    topt, tlin = _port(init, steps=1, moment_dtype="bfloat16")
    for tp, jp in zip(torch.nn.Module.parameters(tlin), jlin.parameters()):
        assert topt._accumulators[id(tp)]["moment1"].dtype == torch.bfloat16
        assert str(jopt._accumulators[id(jp)]["moment1"].dtype) == \
            "bfloat16"
    # without masters, a bf16 parameter's moments are bf16 (its dtype)
    topt, tlin = _port(init, mp=False, steps=1)
    assert not topt._master_weights
    for tp in torch.nn.Module.parameters(tlin):
        assert topt._accumulators[id(tp)]["moment2"].dtype == torch.bfloat16


def test_bf16_without_masters_takes_the_per_tensor_rule():
    """The reference keeps low-precision work arrays off its fused step
    (optimizer.py:331-337); so does the port: no multi-tensor call."""
    init, _, jlin = _reference(False, mp=False)
    n0 = mta.multi_tensor_adam.plain_calls
    _, tlin = _port(init, mp=False)
    assert mta.multi_tensor_adam.plain_calls == n0
    for tp, jp in zip(torch.nn.Module.parameters(tlin), jlin.parameters()):
        assert tp.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(tp), np.asarray(jp._data,
                                                        np.float32),
                                   **MP_TOL)


def test_state_dict_round_trips_the_masters():
    init, _, _ = _reference(True, steps=1)
    topt, tlin = _port(init, steps=2)
    sd = topt.state_dict()
    names = [n for n, _ in torch.nn.Module.named_parameters(tlin)]
    assert sorted(k for k in sd if k.endswith("_master")) == \
        sorted(f"{n}_master" for n in names)
    for n, p in torch.nn.Module.named_parameters(tlin):
        assert sd[f"{n}_master"].dtype == torch.float32
        assert torch.equal(sd[f"{n}_master"], topt._master_weights[id(p)])
    # a fresh optimizer loaded from it takes the same next step
    twin = Linear(16, 16, device="cpu", dtype=torch.bfloat16)
    twin.load_state_dict(torch.nn.Module.state_dict(tlin))
    topt2 = AdamW(learning_rate=LR,
                  parameters=torch.nn.Module.named_parameters(twin),
                  multi_precision=True, weight_decay=0.01)
    topt2.set_state_dict(sd)
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    for opt, lin in ((topt, tlin), (topt2, twin)):
        (lin(x).float() ** 2).mean().backward()
        opt.step()
    for a, b in zip(torch.nn.Module.parameters(tlin),
                    torch.nn.Module.parameters(twin)):
        assert torch.equal(a, b)
    for a, b in zip(topt.state_dict().values(), topt2.state_dict().values()):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def _slots_and_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = [(16, 8), (8,), (3, 5, 4), (1,), (0,), (33, 7)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    return ps, grads


@pytest.mark.parametrize("cls,decays", [
    (AdamW, (0.01, 0.1)), (Adam, (0.05, 0.0))], ids=["adamw", "adam_l2"])
def test_multi_tensor_plain_equals_the_per_tensor_rule(cls, decays):
    """Two groups with their own decays: the multi-tensor plain version
    writes exactly what _update_rule returns, tensor by tensor, in f32."""
    ps, grads = _slots_and_grads(4)
    half = len(ps) // 2
    mk = lambda: [torch.from_numpy(p.copy()) for p in ps]  # noqa: E731
    fused_ps, rule_ps = mk(), mk()
    opts = []
    for tps in (fused_ps, rule_ps):
        opts.append(cls(learning_rate=3e-3, beta1=0.8, beta2=0.95,
                        epsilon=1e-6, parameters=[
                            {"params": tps[:half], "weight_decay": decays[0]},
                            {"params": tps[half:],
                             "weight_decay": decays[1]}]))
    fo, ro = opts
    lr = torch.tensor(3e-3)
    groups = [ro._param_groups[0]] * half + \
        [ro._param_groups[1]] * (len(ps) - half)
    n0 = mta.multi_tensor_adam.plain_calls
    for gs in grads:
        fo._multi_tensor_update(
            [(p, torch.from_numpy(g), fo._get_state(p), grp, None)
             for p, g, grp in zip(fused_ps, gs, [fo._param_groups[0]] * half
                                  + [fo._param_groups[1]] * (len(ps)
                                                             - half))], lr)
        for p, g, grp in zip(rule_ps, gs, groups):
            new_p, new_st = ro._update_rule(p, torch.from_numpy(g),
                                            ro._get_state(p), lr, grp)
            p.copy_(new_p)
            ro._accumulators[id(p)] = new_st
    assert mta.multi_tensor_adam.plain_calls - n0 == len(grads)
    for a, b in zip(fused_ps, rule_ps):
        assert torch.equal(a, b)
        sa, sb = fo._accumulators[id(a)], ro._accumulators[id(b)]
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    # the decays took effect: the groups' tensors moved differently
    assert not torch.equal(fused_ps[0], torch.from_numpy(ps[0]))


def test_step_makes_one_multi_tensor_call_for_every_f32_parameter():
    ps, grads = _slots_and_grads(5)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in ps]
    opt = AdamW(learning_rate=1e-3, parameters=tp)
    n0 = mta.multi_tensor_adam.plain_calls
    for gs in grads:
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    assert mta.multi_tensor_adam.plain_calls - n0 == len(grads)
    slot = mta.AdamSlot(*(torch.zeros(1),) * 4, torch.ones(()),
                        torch.ones(()))
    with pytest.raises(ValueError, match="unknown path"):
        mta.multi_tensor_adam([slot], torch.tensor(1.0), beta1=0.9,
                              beta2=0.99, eps=1e-8, decoupled=True,
                              path="x")
    # a CPU tensor cannot take the kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        mta.multi_tensor_adam([slot], torch.tensor(1.0), beta1=0.9,
                              beta2=0.99, eps=1e-8, decoupled=True,
                              path="cuda")


def test_lr_scalar_is_static_and_refilled():
    opt = AdamW(learning_rate=1e-3, parameters=[torch.zeros(2)])
    a = opt._lr_tensor(1e-3, torch.device("cpu"))
    b = opt._lr_tensor(5e-4, torch.device("cpu"))
    assert a is b and a.dtype == torch.float32
    assert float(a) == np.float32(5e-4)


@pytest.mark.parametrize("mp", [True, False], ids=["masters", "no_masters"])
def test_resume_from_reference_state_with_masters(mp):
    """A reference multi_precision checkpoint carried in by name
    (convert.optimizer_state_from_numpy): masters arrive as f32, and the
    resumed port run takes the reference's next step."""
    init, jopt, jlin = _reference(True, mp=mp, steps=2)
    sd = {k: (v if k == "global_step" else np.asarray(v._data))
          for k, v in jopt.state_dict().items()}
    assert any(k.endswith("_master") for k in sd) == mp
    names = {p.name: n for n, p in jlin.named_parameters()}
    tlin = Linear(16, 16, device="cpu", dtype=torch.bfloat16)
    tlin.load_state_dict({n: _to_tensor(np.asarray(p._data))
                          for n, p in jlin.named_parameters()})
    topt = AdamW(learning_rate=LR,
                 parameters=torch.nn.Module.named_parameters(tlin),
                 multi_precision=mp, weight_decay=0.01)
    topt.set_state_dict(optimizer_state_from_numpy(sd, names))
    assert topt._step_count == 2
    if mp:
        for n, p in torch.nn.Module.named_parameters(tlin):
            m = topt._master_weights[id(p)]
            assert m.dtype == torch.float32
            ref = next(v for k, v in sd.items()
                       if k.endswith("_master") and names[k[:-7]] == n)
            np.testing.assert_array_equal(m.numpy(), ref)
    # one more step on both sides, from the same state
    x = pt.to_tensor(_x()).astype("bfloat16")
    (jlin(x).astype("float32") ** 2).mean().backward()
    os.environ["PADDLE_TPU_FUSED_OPT"] = "1"
    try:
        jopt.step()
    finally:
        os.environ.pop("PADDLE_TPU_FUSED_OPT", None)
    (tlin(torch.from_numpy(_x()).to(torch.bfloat16)).float() ** 2
     ).mean().backward()
    topt.step()
    for tp, jp in zip(torch.nn.Module.parameters(tlin), jlin.parameters()):
        np.testing.assert_allclose(_f32(tp), np.asarray(jp._data,
                                                        np.float32),
                                   **MP_TOL)
        if mp:
            np.testing.assert_allclose(
                topt._master_weights[id(tp)].numpy(),
                np.asarray(jopt._master_weights[id(jp)]), **MP_TOL)


def test_set_state_dict_refills_existing_state_in_place():
    """A loaded state lands in the tensors the optimizer already holds
    (a captured TrainStep graph reads those addresses); a master too."""
    init, _, _ = _reference(True, steps=1)
    topt, tlin = _port(init, steps=1)
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in topt.state_dict().items()}
    held = {id(p): (dict(topt._accumulators[id(p)]),
                    topt._master_weights[id(p)])
            for p in torch.nn.Module.parameters(tlin)}
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    (tlin(x).float() ** 2).mean().backward()
    topt.step()
    topt.set_state_dict(sd)
    for n, p in torch.nn.Module.named_parameters(tlin):
        st, mw = held[id(p)]
        for k, t in st.items():
            assert topt._accumulators[id(p)][k] is t
            assert torch.equal(t, sd[f"{n}_{k}"])
        assert topt._master_weights[id(p)] is mw
        assert torch.equal(mw, sd[f"{n}_master"])
