"""nn.utils and nn.quant (paddle_tpu_torch/nn/utils, nn/quant) against
the reference's on the CPU.

nn.utils: weight_norm / remove_weight_norm and spectral_norm on the same
layer weights give the same outputs, parameters and derived weights
(spectral_norm's persistent u too) within 1e-5 (rtol = atol: the same
f32 norms and products, summed in other orders). The port's gradients
reach the new parameters through torch autograd, which the reference's
eager tape does not do (ROADMAP Queue C): they are held to the same
function differentiated by torch directly. The clips and the vector
helpers equal the reference's, on Layers' Parameters and on a model's
torch parameters.

nn.quant: the int8 and int4 codes, the int4 nibble packing (low nibble
first) and LLM.int8()'s outlier split are equal exactly; the scales and
the dequantized weights too (the same f32 products); the linear
products within 1e-5 in f32 and within one bf16 rounding (8e-3
relative) in bf16."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import quant as tq
from torch_port_helpers import cpu_place, twin_layers

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


def _a(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _twin_linear(i=4, o=3, seed=0):
    return twin_layers("Linear", i, o, seed=seed)


# ---------------------------------------------------------------- nn.utils
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_reference(dim):
    jm, tm = _twin_linear()
    pt.nn.utils.weight_norm(jm, dim=dim)
    ptt.nn.utils.weight_norm(tm, dim=dim)
    assert list(tm._parameters) == list(jm._parameters) == [
        "bias", "weight_g", "weight_v"]
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(_np(tm.state_dict()[k]), _np(v),
                                   err_msg=k, **TOL)
    x = _a(2, 4, seed=1)
    got, want = tm(ptt.to_tensor(x)), jm(pt.to_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **TOL)
    # the gradients reach weight_g and weight_v: those of w = g v / |v|
    got.sum().backward()
    g = torch.from_numpy(_np(tm.weight_g)).requires_grad_()
    v = torch.from_numpy(_np(tm.weight_v)).requires_grad_()
    axes = (1 - dim,) if dim is not None else (0, 1)
    w = g * v / torch.sqrt((v * v).sum(axes, keepdim=True))
    (torch.from_numpy(x) @ w).sum().backward()
    np.testing.assert_allclose(_np(tm.weight_g.grad), g.grad.numpy(), **TOL)
    np.testing.assert_allclose(_np(tm.weight_v.grad), v.grad.numpy(), **TOL)


def test_remove_weight_norm_matches_reference():
    jm, tm = _twin_linear()
    for P, m in ((pt, jm), (ptt, tm)):
        P.nn.utils.weight_norm(m)
        m(P.to_tensor(np.ones((1, 4), np.float32)))
        P.nn.utils.remove_weight_norm(m)
        assert "weight" in m._parameters and "weight_g" not in m._parameters
    np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **TOL)
    y = tm(ptt.to_tensor(np.ones((2, 4), np.float32)))
    (y * y).sum().backward()
    assert tm.weight.grad is not None
    # a layer without weight_norm comes back as it is
    assert ptt.nn.utils.remove_weight_norm(tm) is tm


@pytest.mark.parametrize("iters,dim", [(1, None), (5, 1)])
def test_spectral_norm_matches_reference(iters, dim):
    """Three forwards: the outputs, the derived weight and the persistent
    u after each, as the reference's."""
    jm, tm = _twin_linear(8, 4)
    pt.nn.utils.spectral_norm(jm, n_power_iterations=iters, dim=dim)
    ptt.nn.utils.spectral_norm(tm, n_power_iterations=iters, dim=dim)
    assert list(tm._parameters) == list(jm._parameters)
    x = _a(3, 8, seed=2)
    for _ in range(3):
        np.testing.assert_allclose(_np(tm(ptt.to_tensor(x))),
                                   _np(jm(pt.to_tensor(x))), **TOL)
        np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **TOL)
        np.testing.assert_allclose(tm.weight_u.numpy(),
                                   np.asarray(jm.weight_u), **TOL)


def test_spectral_norm_converges_and_trains():
    """The reference's case: one iteration a call, u persisting, sigma
    reaches 1 over 40 calls; the gradient reaches weight_orig."""
    lin = ptt.nn.Linear(8, 4)
    ptt.nn.utils.spectral_norm(lin)
    x = ptt.to_tensor(np.ones((1, 8), np.float32))
    for _ in range(40):
        y = lin(x)
    s = np.linalg.svd(_np(lin.weight), compute_uv=False)
    np.testing.assert_allclose(s[0], 1.0, atol=5e-2)
    y.sum().backward()
    assert lin.weight_orig.grad is not None


def _grads_twins(seed=0):
    """(reference Linear, port Linear) with equal weights and grads."""
    jm, tm = _twin_linear(3, 3, seed)
    x = _a(2, 3, seed=3)
    for P, m in ((pt, jm), (ptt, tm)):
        (m(P.to_tensor(x)) ** 2.0 * 10.0).sum().backward()
    return jm, tm


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    jm, tm = _grads_twins()
    want = pt.nn.utils.clip_grad_norm_(jm.parameters(), 0.5, norm_type)
    got = ptt.nn.utils.clip_grad_norm_(tm.parameters(), 0.5, norm_type)
    assert isinstance(got, ptt.Tensor)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for (n, p), (_, q) in zip(tm.named_parameters(), jm.named_parameters()):
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), err_msg=n,
                                   **TOL)


def test_clip_grad_norm_on_torch_parameters_and_nonfinite():
    """A model's torch parameters get a torch total; a non-finite total
    raises with error_if_nonfinite, as in the reference."""
    _, tm = _grads_twins()
    ps = list(torch.nn.Module.parameters(tm))
    total = ptt.nn.utils.clip_grad_norm_(ps, 1e6)
    assert type(total) is torch.Tensor and total.shape == ()
    ps[0].grad[0, 0] = float("inf")
    with pytest.raises(RuntimeError, match="non-finite"):
        ptt.nn.utils.clip_grad_norm_(ps, 1.0, error_if_nonfinite=True)
    jm, _ = _grads_twins()
    jm.weight.grad._data = jm.weight.grad._data.at[0, 0].set(np.inf)
    with pytest.raises(RuntimeError, match="non-finite"):
        pt.nn.utils.clip_grad_norm_(jm.parameters(), 1.0,
                                    error_if_nonfinite=True)


def test_clip_grad_value_matches_reference():
    jm, tm = _grads_twins()
    pt.nn.utils.clip_grad_value_(jm.parameters(), 0.1)
    ptt.nn.utils.clip_grad_value_(tm.parameters(), 0.1)
    for p, q in zip(tm.parameters(), jm.parameters()):
        np.testing.assert_array_equal(_np(p.grad), _np(q.grad))
        assert np.abs(_np(p.grad)).max() <= 0.1


def test_parameter_vector_round_trip_matches_reference():
    jm, tm = _twin_linear(4, 2)
    want = pt.nn.utils.parameters_to_vector(jm.parameters())
    got = ptt.nn.utils.parameters_to_vector(tm.parameters())
    assert isinstance(got, ptt.Tensor)
    np.testing.assert_array_equal(_np(got), _np(want))
    vec = np.arange(_np(want).size, dtype=np.float32)
    pt.nn.utils.vector_to_parameters(pt.to_tensor(vec), jm.parameters())
    ptt.nn.utils.vector_to_parameters(ptt.to_tensor(vec), tm.parameters())
    for p, q in zip(tm.parameters(), jm.parameters()):
        np.testing.assert_array_equal(_np(p), _np(q))
    # torch parameters take torch tensors
    ps = list(torch.nn.Module.parameters(tm))
    flat = ptt.nn.utils.parameters_to_vector(ps)
    assert type(flat) is torch.Tensor
    torch.testing.assert_close(flat, torch.from_numpy(vec))


def test_utils_on_a_models_layer_children():
    """weight_norm on a Linear inside a torch Module trains through the
    parent, and the clip takes the parent's torch parameters."""
    lin = ptt.nn.Linear(4, 3)
    model = torch.nn.Sequential(lin, torch.nn.Tanh())
    ptt.nn.utils.weight_norm(lin)
    names = [n for n, _ in torch.nn.Module.named_parameters(model)]
    assert names == ["0.bias", "0.weight_g", "0.weight_v"]
    model(torch.ones(2, 4)).sum().backward()
    ps = list(torch.nn.Module.parameters(model))
    assert all(p.grad is not None for p in ps)
    total = ptt.nn.utils.clip_grad_norm_(ps, 1e-3)
    flat = torch.cat([p.grad.reshape(-1) for p in ps])
    assert float(total) > 1e-3
    np.testing.assert_allclose(float(flat.norm()), 1e-3, rtol=1e-4)


# ---------------------------------------------------------------- nn.quant
W = _a(16, 12, seed=4)
W[:, 3] = 0.0                    # a zero output channel: its scale is 0


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4",
                                  "llm.int8"])
def test_weight_quantize_codes_equal_the_reference(algo):
    q, s = tq.weight_quantize(torch.from_numpy(W), algo=algo)
    jq, js = pt.nn.quant.weight_quantize(pt.to_tensor(W), algo=algo)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    assert q.shape == ((12, 8) if algo == "weight_only_int4" else (12, 16))


def test_int4_packing_low_nibble_first():
    """Codes -7..7 pack two to a byte, the even input column in the low
    nibble, and unpack to themselves on both sides."""
    codes = np.array([[-7, 7, 0, -1, 3, -4, 5, 6]], np.int32)
    w = (codes.T * (1.0 / 7.0)).astype(np.float32)      # [in, out=1]
    q, s = tq.weight_quantize(torch.from_numpy(w), "weight_only_int4")
    b = q.numpy().view(np.uint8)[0]
    assert (b & 0xF).tolist() == [c & 0xF for c in codes[0, 0::2]]
    assert (b >> 4).tolist() == [c & 0xF for c in codes[0, 1::2]]
    np.testing.assert_array_equal(tq._unpack_int4(q).numpy(), codes)
    from paddle_tpu.nn.quant import _unpack_int4
    np.testing.assert_array_equal(np.asarray(_unpack_int4(
        pt.to_tensor(q.numpy())._data)), codes)


def test_quantize_rounds_half_to_even():
    """A weight at an exact half code rounds to the even code, as
    jnp.round does."""
    w = np.array([[2.5], [1.5], [-0.5], [127.0]], np.float32)  # scale 1
    q, _ = tq.weight_quantize(torch.from_numpy(w))
    assert q.numpy().tolist() == [[2, 2, 0, 127]]
    jq, _ = pt.nn.quant.weight_quantize(pt.to_tensor(w))
    np.testing.assert_array_equal(q.numpy(), _np(jq))


def test_quantize_refusals():
    for mod in (tq, pt.nn.quant):
        with pytest.raises(ValueError, match="unknown algo"):
            mod.weight_quantize(torch.zeros(4, 4) if mod is tq
                                else pt.to_tensor(np.zeros((4, 4),
                                                           np.float32)),
                                algo="int2")
        with pytest.raises(ValueError, match="even"):
            mod.weight_quantize(torch.zeros(3, 4) if mod is tq
                                else pt.to_tensor(np.zeros((3, 4),
                                                           np.float32)),
                                algo="weight_only_int4")


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_dequantize_matches_reference(algo):
    q, s = tq.weight_quantize(torch.from_numpy(W), algo=algo)
    got = tq.weight_dequantize(q, s, algo, "float32")
    want = pt.nn.quant.weight_dequantize(pt.to_tensor(q.numpy()),
                                         pt.to_tensor(s.numpy()), algo,
                                         "float32")
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert tq.weight_dequantize(q, s, algo).dtype == torch.float16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdt,bias", [("int8", True), ("int4", False),
                                      ("int8", False)])
def test_weight_only_linear_matches_reference(wdt, bias, dtype):
    algo = "weight_only_" + wdt
    x = _a(5, 16, seed=6)
    b = _a(12, seed=7)
    q, s = tq.weight_quantize(torch.from_numpy(W), algo=algo)
    outs = []
    for P in (pt, ptt):
        out = P.nn.quant.weight_only_linear(
            P.to_tensor(x).astype(dtype), P.to_tensor(q.numpy()),
            P.to_tensor(b) if bias else None, P.to_tensor(s.numpy()), wdt)
        outs.append(np.asarray(out.astype("float32").numpy()))
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(outs[1], outs[0], rtol=tol, atol=tol)


def test_llm_int8_linear_matches_reference_and_split_exact():
    """Two activation columns above the threshold: the outlier mask and
    the int8 codes of the rest equal numpy's (absmax per column, half
    to even), the output the reference's."""
    x = _a(6, 16, seed=8)
    x[:, 2] *= 30.0
    x[1, 9] = -11.0
    q, s = tq.weight_quantize(torch.from_numpy(W), algo="llm.int8")
    b = _a(12, seed=9)
    got = tq.llm_int8_linear(torch.from_numpy(x), q, torch.from_numpy(b), s)
    want = pt.nn.quant.llm_int8_linear(pt.to_tensor(x),
                                       pt.to_tensor(q.numpy()),
                                       pt.to_tensor(b),
                                       pt.to_tensor(s.numpy()))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    outlier, x_out, xq, a_scale = tq._int8_split(torch.from_numpy(x), 6.0)
    want_mask = np.abs(x).max(0) > 6.0
    assert want_mask.sum() == 2
    np.testing.assert_array_equal(outlier.numpy(), want_mask)
    x_in = np.where(want_mask, 0.0, x).astype(np.float32)
    scale = np.float32(np.abs(x_in).max() * np.float32(1.0 / 127.0))
    np.testing.assert_array_equal(
        xq.numpy(), np.clip(np.round(x_in / scale), -127, 127))
    np.testing.assert_array_equal(x_out.numpy(),
                                  np.where(want_mask, x, 0.0))


def test_quant_under_auto_cast_matches_reference():
    """weight_only_linear is AMP-white: under bf16 O1 x, bias and the
    scales are cast to bf16 first on both sides."""
    x = _a(4, 16, seed=10)
    q, s = tq.weight_quantize(torch.from_numpy(W))
    outs = []
    for P in (pt, ptt):
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = P.nn.quant.weight_only_linear(
                P.to_tensor(x), P.to_tensor(q.numpy()), None,
                P.to_tensor(s.numpy()))
        assert "bfloat16" in str(out.dtype)
        outs.append(np.asarray(out.astype("float32").numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=8e-3, atol=8e-3)
