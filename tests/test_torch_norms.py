"""paddle_tpu_torch's fused norms (B4 layer norm, B5 RMS norm) against
paddle_tpu's, on the same numpy inputs.

The reference computes two functions under one name (kernels/norms.py's
docstring): its Pallas kernels apply the affine in f32 and cast once,
its off-TPU forms cast first. The port's plain kernel-form versions are
held to the Pallas kernels in interpret mode, the port's CPU path to
the off-TPU forms, and the gradients to jax.vjp of the reference's
custom_vjp. The CUDA kernels themselves are held to the plain versions
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phase 8).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as JIF
import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.kernels import norms as tn

jn = importlib.import_module("paddle_tpu.kernels.pallas.norms")

# (rows, width): the reference's own test shape, LLaMA-2-7B's width, and
# odd rows with a width that is neither a multiple of 128 nor of 8
SHAPES = [(64, 256), (16, 4096), (7, 1000)]


def _inputs(shape, seed=0, mean=1.0):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + mean).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    b = rng.standard_normal((h,)).astype(np.float32)
    return x, w, b


def _j(a, dt):
    return None if a is None else jnp.asarray(a, jnp.dtype(dt))


def _t(a, dt):
    return None if a is None else torch.from_numpy(a).to(getattr(torch, dt))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(getattr(a, "_data", a), np.float32)


def _rel_close(got, want, tol, floor=1.0):
    """|got - want| <= tol * (|want| + floor * rms of want's row),
    element by element: a value near 0 is held to its row's size."""
    got, want = _np(got), _np(want)
    row = np.sqrt((want ** 2).mean(-1, keepdims=True))
    bad = np.abs(got - want) > tol * (np.abs(want) + floor * row)
    assert not bad.any(), (float(np.abs(got - want)[bad].max()),
                           int(bad.sum()))


# f32: the two sides sum the row in different orders (~1e-7 relative).
# bf16: both round the same f32 value, computed to ~1e-7 apart, once;
# values straddling a rounding boundary then differ by one bf16 ulp
# (2^-8..2^-7 relative), which 2^-7 of the row's size covers.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("affine", ["none", "weight", "both"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_layer_norm_matches_pallas_interpret(shape, dt, affine):
    x, w, b = _inputs(shape)
    w = None if affine == "none" else w
    b = b if affine == "both" else None
    want = jn._ln_pallas(_j(x, dt), _j(w, dt), _j(b, dt), 1e-5,
                         interpret=True)
    got = tn.layer_norm_fwd(_t(x, dt), _t(w, dt), _t(b, dt), 1e-5,
                            path="torch")
    assert got.dtype == getattr(torch, dt)
    _rel_close(got, want, TOL[dt])


@pytest.mark.parametrize("affine", ["none", "weight"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_rms_norm_matches_pallas_interpret(shape, dt, affine):
    x, w, _ = _inputs(shape, seed=1)
    w = None if affine == "none" else w
    want = jn._rms_pallas(_j(x, dt), _j(w, dt), 1e-6, interpret=True)
    got = tn.rms_norm_fwd(_t(x, dt), _t(w, dt), 1e-6, path="torch")
    assert got.dtype == getattr(torch, dt)
    _rel_close(got, want, TOL[dt])


# the off-TPU forms apply the affine after the cast, in bf16 here: one
# more rounding on each side, which XLA may fuse away, so 2 ulps
XLA_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cpu_path_matches_xla_form(shape, dt):
    x, w, b = _inputs(shape, seed=2)
    n0 = tn.layer_norm_fwd.kernel_launches, tn.rms_norm_fwd.kernel_launches
    got_ln = tn.layer_norm(_t(x, dt), _t(w, dt), _t(b, dt), 1e-5)
    got_rms = tn.rms_norm(_t(x, dt), _t(w, dt), 1e-6)
    _rel_close(got_ln, jn._ln_xla(_j(x, dt), _j(w, dt), _j(b, dt), 1e-5),
               XLA_TOL[dt])
    _rel_close(got_rms, jn._rms_xla(_j(x, dt), _j(w, dt), 1e-6),
               XLA_TOL[dt])
    assert (tn.layer_norm_fwd.kernel_launches,
            tn.rms_norm_fwd.kernel_launches) == n0


def test_mixed_dtypes_promote_as_the_reference():
    """bf16 x with an f32 weight: the off-TPU form promotes the affine to
    f32, as jnp does; the kernel form keeps x's dtype."""
    x, w, b = _inputs((8, 256), seed=3)
    want = jn._ln_xla(_j(x, "bfloat16"), _j(w, "float32"),
                      _j(b, "float32"), 1e-5)
    got = tn.layer_norm(_t(x, "bfloat16"), _t(w, "float32"),
                        _t(b, "float32"))
    assert str(got.dtype).endswith(str(want.dtype))
    _rel_close(got, want, 2.0 ** -7)
    plain = tn.layer_norm_fwd(_t(x, "bfloat16"), _t(w, "float32"),
                              _t(b, "float32"), path="torch")
    assert plain.dtype == torch.bfloat16


def test_kernel_form_and_xla_form_split_in_bf16():
    """The reference's known split (ROADMAP Queue C): in bf16 with an
    affine the two forms differ, by at most 2 bf16 ulps of each value
    (the kernel form rounds once, the other twice); chip_smoke.py phase
    9 holds fused_rms_norm against LLaMA's RMSNorm to this same limit."""
    x, w, _ = _inputs((64, 4096), seed=4)
    xb, wb = _t(x, "bfloat16"), _t(w, "bfloat16")
    kern = tn.rms_norm_fwd(xb, wb, 1e-5, path="torch")
    xla = tn._rms_xla(xb, wb, 1e-5)
    assert (kern != xla).any()
    _rel_close(kern, xla, 2.0 ** -6, floor=2.0 ** -8)


def _jax_grads(fn, args, g):
    _, vjp = jax.vjp(fn, *args)
    return vjp(g)


@pytest.mark.parametrize("affine", ["none", "weight", "both"])
def test_layer_norm_grads_match_jax_vjp(affine):
    x, w, b = _inputs((16, 512), seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    jw = None if affine == "none" else jnp.asarray(w)
    jb = jnp.asarray(b) if affine == "both" else None
    _, vjp = jax.vjp(lambda x_: jn.layer_norm(x_, jw, jb, 1e-5),
                     jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = None if affine == "none" else torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if affine == "both" else None
    tn.layer_norm(tx, tw, tb, 1e-5).backward(torch.from_numpy(g))
    # dx sums over the row in different orders on the two sides
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    if affine != "none":
        args = (jnp.asarray(x), jnp.asarray(w)) + \
            ((jnp.asarray(b),) if affine == "both" else ())
        want = _jax_grads(
            lambda x_, w_, *b_: jn.layer_norm(x_, w_, b_[0] if b_ else None,
                                              1e-5), args, jnp.asarray(g))
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-4)
        if affine == "both":
            np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[2]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_w", [False, True])
def test_rms_norm_grads_match_jax_vjp(with_w):
    x, w, _ = _inputs((16, 512), seed=7)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    if with_w:
        want = _jax_grads(lambda x_, w_: jn.rms_norm(x_, w_, 1e-6),
                          (jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    else:
        want = _jax_grads(lambda x_: jn.rms_norm(x_, None, 1e-6),
                          (jnp.asarray(x),), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_() if with_w else None
    tn.rms_norm(tx, tw, 1e-6).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    if with_w:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-4)


def test_grads_pass_gradcheck_f64():
    rng = np.random.default_rng(9)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)) \
        .requires_grad_()
    x, w, b = mk(4, 13), mk(13), mk(13)
    assert torch.autograd.gradcheck(
        lambda x_, w_, b_: tn.layer_norm(x_, w_, b_, 1e-5), (x, w, b))
    assert torch.autograd.gradcheck(
        lambda x_, w_: tn.rms_norm(x_, w_, 1e-6), (x, w))
    # a missing weight gets no gradient, and x still does
    assert torch.autograd.gradcheck(
        lambda x_: tn.layer_norm(x_, None, None, 1e-5), (x,))


def _ref_incubate(name, args, kw, amp):
    with pt.amp.auto_cast(enable=amp, level="O1"):
        return getattr(JIF, name)(*[None if a is None else pt.to_tensor(a)
                                    for a in args], **kw)


def _torch(a):
    """numpy (f32 or ml_dtypes bf16) -> torch, bit for bit."""
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t


def _port_incubate(name, args, kw, amp):
    with ptt.amp.auto_cast(enable=amp, level="O1"):
        return getattr(TIF, name)(*[None if a is None else _torch(a)
                                    for a in args], **kw)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "O1"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_incubate_norms_match_reference(dt, amp):
    """fused_rms_norm, fused_layer_norm and
    fused_bias_dropout_residual_layer_norm (dropout off), AMP-black:
    under O1 bf16 inputs are normalised in f32."""
    x, w, b = _inputs((6, 3, 256), seed=10)
    r = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)
    cast = lambda a: a.astype(jnp.bfloat16) if dt == "bfloat16" else a
    cases = [
        ("fused_rms_norm", (cast(x), w), dict(epsilon=1e-6)),
        ("fused_layer_norm", (cast(x), w, b), dict(epsilon=1e-5)),
        ("fused_bias_dropout_residual_layer_norm", (cast(x), cast(r), b, w, b),
         dict(dropout_rate=0.0, ln_epsilon=1e-5)),
        ("fused_bias_dropout_residual_layer_norm", (cast(x), cast(r), b, w, b),
         dict(dropout_rate=0.5, training=False)),
    ]
    for name, args, kw in cases:
        want = _ref_incubate(name, args, kw, amp)
        got = _port_incubate(name, args, kw, amp)
        assert str(got.dtype).endswith(str(np.asarray(want._data).dtype)), \
            name
        _rel_close(got, want, 1e-5 if got.dtype == torch.float32
                   else 2.0 ** -6)


def test_bias_dropout_residual_draws_from_the_generator():
    x, w, b = _inputs((4, 64), seed=12)
    t = lambda a: torch.from_numpy(a.copy())
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        outs.append(TIF.fused_bias_dropout_residual_layer_norm(
            t(x), t(x), t(b), t(w), t(b), dropout_rate=0.5, generator=g))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    off = TIF.fused_bias_dropout_residual_layer_norm(
        t(x), t(x), t(b), t(w), t(b), dropout_rate=0.0)
    assert not torch.equal(outs[0], off)


def test_cpu_tensors_never_reach_the_kernels():
    x, w, b = _inputs((8, 128), seed=13)
    t = lambda a: torch.from_numpy(a)
    n0 = (tn.layer_norm_fwd.kernel_launches, tn.rms_norm_fwd.kernel_launches,
          tn.layer_norm_fwd.plain_calls, tn.rms_norm_fwd.plain_calls)
    TIF.fused_layer_norm(t(x), t(w), t(b))
    TIF.fused_rms_norm(t(x), t(w))
    n1 = (tn.layer_norm_fwd.kernel_launches, tn.rms_norm_fwd.kernel_launches,
          tn.layer_norm_fwd.plain_calls, tn.rms_norm_fwd.plain_calls)
    assert n1 == (n0[0], n0[1], n0[2] + 1, n0[3] + 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tn.layer_norm_fwd(t(x), path="cuda")
    with pytest.raises(ValueError, match="unknown path"):
        tn.rms_norm_fwd(t(x), path="pallas")


def test_kernel_takes_any_rows_and_width():
    """The reference's TPU gate (rows % 8 == 0, h % 128 == 0) is no rule
    of the CUDA kernel: its argument checks take odd shapes, read a 2-D
    row-strided view in place and flatten other shapes to rows."""
    assert not (7 % 8 == 0 and 1000 % 128 == 0)    # the gate would refuse
    for shape in [(7, 1000), (1, 1), (3, 5, 33), (0, 8)]:
        x = torch.zeros(shape)
        x2, wt, wc, bt, bc = tn._kernel_args("layer_norm", x, None, None)
        assert x2.shape == (int(np.prod(shape[:-1])), shape[-1])
        assert wt is None and bt is None
    big = torch.zeros(6, 300)
    view = big[:, 10:110]
    x2, *_ = tn._kernel_args("rms_norm", view, torch.ones(100), None)
    assert x2.data_ptr() == view.data_ptr() and x2.stride() == (300, 1)
    with pytest.raises(ValueError, match=r"weight must be"):
        tn._kernel_args("layer_norm", big, torch.ones(7), None)
    with pytest.raises(TypeError):
        tn._kernel_args("layer_norm", big.double(), None, None)
