"""incubate's fused layers as ``nn.Layer``s, LookAhead / ModelAverage and
asp against the reference's on the CPU.

- The fused layers on the eager API's Tensors (FusedTransformerEncoderLayer,
  FusedLinear, FusedDropoutAdd, FusedEcMoe), the reference's weights
  carried in by name; built from ParamAttrs; `init_generator` draws.
- LookAhead over SGD and Adam, ModelAverage's window, apply and restore
  (tests/test_parity_gaps_r4.py:192-215, test_fused_optimizer.py:143-160)
  step by step on both packages from the same weights.
- asp's n:m masks equal to the reference's exactly (ties by index), the
  decorated optimizer keeping them, density.
- The slice as a whole: a 2-layer encoder stack (d_model 128, 2 heads of
  64, FFN 256, 128 tokens: B1/B2's plain versions here) trained 3 steps
  under asp.decorate(LookAhead(AdamW, k=2)) with an identity_loss on both
  packages.

f32 throughout; tolerances are stated at each comparison."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.incubate import asp as jasp
from paddle_tpu_torch import fused_params_from_numpy
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_port_helpers import cpu_place, jax_state_numpy


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield
    jasp.reset_excluded_layers()
    tasp.reset_excluded_layers()
    jasp._masks.clear()
    tasp._masks.clear()


def _twin(name, *args, **kw):
    """(reference layer, port layer) with the reference's weights, moved
    off their constant initial values where they are biases or scales."""
    pt.seed(0)
    jl = getattr(pt.incubate.nn, name)(*args, **kw)
    tl = getattr(ptt.incubate.nn, name)(*args, **kw)
    named = jax_state_numpy(jl)
    rng = np.random.default_rng(1)
    for k, v in named.items():
        named[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    jl.set_state_dict({k: pt.to_tensor(v) for k, v in named.items()})
    assert list(tl.state_dict()) == list(named)
    tl.set_state_dict(named)
    return jl, tl


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.numpy()),
                               np.asarray(want.numpy()), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_encoder_layer_takes_tensors_and_their_grads(pre_ln):
    """A Tensor in, a Tensor out; forward within 1e-5 and every
    parameter's grad within 1e-4 of the reference (dropout off), through
    B1's and B2's plain versions."""
    jl, tl = _twin("FusedTransformerEncoderLayer", 128, 2, 256,
                   dropout_rate=0.0, normalize_before=pre_ln)
    x = np.random.default_rng(2).standard_normal((2, 128, 128)).astype(
        np.float32)
    n = (fa.flash_fwd.plain_calls, fa.flash_bwd.plain_calls)
    outs = []
    for P, layer in ((ptt, tl), (pt, jl)):
        y = layer(P.to_tensor(x))
        (y * y).mean().backward()
        outs.append((y, {k: p.grad for k, p in layer.named_parameters()}))
    assert (fa.flash_fwd.plain_calls - n[0],
            fa.flash_bwd.plain_calls - n[1]) == (1, 1)
    (y, g), (wy, wg) = outs
    assert isinstance(y, ptt.Tensor) and isinstance(tl.parameters(), list)
    _close(y, wy, 1e-5)
    assert list(g) == list(wg)
    # the attention's norm that a pre- or post-LN block leaves unused
    unused = {f"fused_attn.{'ln' if pre_ln else 'pre_ln'}_{s}"
              for s in ("scale", "bias")}
    for k in g:
        assert (g[k] is None) == (wg[k] is None) == (k in unused), k
        if g[k] is not None:
            _close(g[k], wg[k], 1e-4, k)


def test_layers_build_from_param_attrs_and_init_generator():
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn.initializer import Constant, Normal
    ffn = ptt.incubate.nn.FusedFeedForward(
        16, 32, linear1_weight_attr=ParamAttr(name="w1",
                                              initializer=Constant(0.25)),
        linear2_bias_attr=ParamAttr(initializer=Normal(1.0, 0.0)),
        ln1_scale_attr=ParamAttr(initializer=Constant(3.0)))
    assert ffn.linear1_weight.name == "w1"
    assert bool((ffn.linear1_weight._data == 0.25).all())
    assert bool((ffn.linear2_bias._data == 1.0).all())
    # as in the reference, the layer-norm parameters take no attr
    assert bool((ffn.ln_scale._data == 1.0).all())
    draws = [ptt.incubate.nn.FusedTransformerEncoderLayer(
        16, 2, 32, init_generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    for a, b in zip(*(torch.nn.Module.parameters(d) for d in draws)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_linear_dropout_add_and_ec_moe_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    for transpose in (False, True):
        jl, tl = _twin("FusedLinear", 8, 6, transpose_weight=transpose)
        _close(tl(ptt.to_tensor(x)), jl(pt.to_tensor(x)), 1e-5)
    jl, tl = _twin("FusedEcMoe", 8, 12, 3, act_type="gelu")
    gate = rng.standard_normal((2, 3, 3)).astype(np.float32)
    _close(tl(ptt.to_tensor(x), ptt.to_tensor(gate)),
           jl(pt.to_tensor(x), pt.to_tensor(gate)), 1e-5)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        jd = pt.incubate.nn.FusedDropoutAdd(0.25, mode=mode)
        td = ptt.incubate.nn.FusedDropoutAdd(0.25, mode=mode)
        jd.eval()
        td.eval()
        _close(td(ptt.to_tensor(x), ptt.to_tensor(x)),
               jd(pt.to_tensor(x), pt.to_tensor(x)), 1e-6)
    td.train()
    td.generator = torch.Generator().manual_seed(0)
    y = td(ptt.to_tensor(np.ones((64, 64), np.float32)),
           ptt.to_tensor(np.zeros((64, 64), np.float32))).numpy()
    assert set(np.unique(y)) <= {0.0, 1.0}        # downscale: kept as is
    assert 0.65 < (y == 1.0).mean() < 0.85


# ---------------------------------------------------------------------------
# LookAhead and ModelAverage
# ---------------------------------------------------------------------------
def _linears(seed=0):
    pt.seed(seed)
    jl = pt.nn.Linear(4, 4)
    tl = ptt.nn.Linear(4, 4)
    tl.set_state_dict(jax_state_numpy(jl))
    return jl, tl


def _loss(P, lin, x):
    return (lin(P.to_tensor(x)) ** 2).mean()


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_lookahead_matches_reference(inner):
    """k = 2 over 4 steps: the weights after every step within 1e-6
    (SGD) / 1e-5 (Adam: the port's multi-tensor form on the CPU) of the
    reference's."""
    jl, tl = _linears()
    x = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    opts = []
    for P, lin in ((ptt, tl), (pt, jl)):
        base = getattr(P.optimizer, inner)(learning_rate=0.1,
                                           parameters=lin.parameters())
        opts.append(P.incubate.LookAhead(base, alpha=0.5, k=2))
    w0 = tl.weight.numpy().copy()
    for _ in range(4):
        for (P, lin), opt in zip(((ptt, tl), (pt, jl)), opts):
            _loss(P, lin, x).backward()
            opt.step()
            opt.clear_grad()
        _close(tl.weight, jl.weight, 1e-6 if inner == "SGD" else 1e-5)
        _close(tl.bias, jl.bias, 1e-6 if inner == "SGD" else 1e-5)
    assert not np.allclose(tl.weight.numpy(), w0)


def test_model_average_matches_reference_and_restores_bit_for_bit():
    jl, tl = _linears(1)
    x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    runs = []
    for P, lin in ((ptt, tl), (pt, jl)):
        inner = P.optimizer.SGD(learning_rate=0.1,
                                parameters=lin.parameters())
        ma = P.incubate.ModelAverage(0.5, parameters=lin.parameters(),
                                     min_average_window=2,
                                     max_average_window=3)
        for _ in range(5):
            _loss(P, lin, x).backward()
            inner.step()
            inner.clear_grad()
            ma.step()
        live = lin.weight.numpy().copy()
        with ma.apply():
            avg = lin.weight.numpy().copy()
        runs.append((live, avg, lin.weight.numpy().copy()))
    (live, avg, after), (wlive, wavg, _) = runs
    np.testing.assert_allclose(avg, wavg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(live, wlive, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(avg, live)
    np.testing.assert_array_equal(after, live)


# ---------------------------------------------------------------------------
# asp
# ---------------------------------------------------------------------------
def test_mask_1d_equals_the_reference_with_ties():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    w[0, :4] = [1.0, -1.0, 1.0, 0.5]          # a three-way tie
    w[1, :4] = 2.0                            # all equal
    w[2, :4] = 0.0
    w[3] = np.round(w[3])                     # many ties
    for n, m in ((2, 4), (1, 4), (4, 8)):
        got = tasp._mask_1d(torch.from_numpy(w), n, m).numpy()
        want = np.asarray(jasp._mask_1d(pt.to_tensor(w)._data, n, m))
        np.testing.assert_array_equal(got, want)
        assert (got.reshape(-1, m).sum(-1) == n).all()
    odd = torch.ones(3, 6)
    assert bool((tasp._mask_1d(odd, 2, 4) == 1).all())
    assert tasp.calculate_density(ptt.to_tensor(w)) == \
        jasp.calculate_density(pt.to_tensor(w))


def _stack(P, n_layers=2):
    return P.nn.Sequential(*[P.incubate.nn.FusedTransformerEncoderLayer(
        128, 2, 256, dropout_rate=0.0) for _ in range(n_layers)])


def test_encoder_stack_trained_under_lookahead_and_asp_both_packages():
    """The slice as a whole: the FFN weights pruned 2:4 (the attention's
    excluded by name), 3 AdamW steps under LookAhead (k = 2) decorated by
    asp, an identity_loss mean loss. Masks equal exactly; losses within
    1e-5 and every parameter within 2e-5 of the reference's at each step;
    the pruned weights still 2:4 after the steps."""
    pt.seed(0)
    jst = _stack(pt)
    tst = _stack(ptt)
    tst.set_state_dict(jax_state_numpy(jst))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    tgt = rng.standard_normal((2, 128, 128)).astype(np.float32)
    runs = []
    for P, A, st in ((ptt, tasp, tst), (pt, jasp, jst)):
        A.set_excluded_layers([n for n, _ in st.named_parameters()
                               if "fused_attn" in n])
        masks = A.prune_model(st)
        opt = A.decorate(P.incubate.LookAhead(P.optimizer.AdamW(
            learning_rate=1e-3, parameters=st.parameters()), k=2))
        losses = []
        for _ in range(3):
            out = st(P.to_tensor(x))
            loss = P.incubate.identity_loss(
                (out - P.to_tensor(tgt)) ** 2, reduction="mean")
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        runs.append((masks, losses, {k: np.asarray(p.numpy()) for k, p in
                                     st.named_parameters()}))
    (masks, losses, params), (wmasks, wlosses, wparams) = runs
    assert sorted(masks) == sorted(wmasks) == sorted(
        f"{i}.ffn.linear{j}_weight" for i in range(2) for j in (1, 2))
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(),
                                      np.asarray(wmasks[k].numpy()))
    np.testing.assert_allclose(losses, wlosses, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(params[k], wparams[k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)
        if k in masks:
            groups = params[k].reshape(-1, 4)
            assert ((groups != 0).sum(-1) <= 2).all(), k
