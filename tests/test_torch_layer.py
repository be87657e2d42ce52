"""nn.Layer, Parameter and ParamAttr against the reference's
(paddle_tpu/nn/layer.py, nn/param_attr.py) on the CPU: the same Layer
subclass built in both packages from the same weights gives the same
parameter, buffer and sublayer names, state_dict keys, hook behaviour,
modes, casts and repr, and the same outputs within 1e-6 (f32: XLA and
torch sum the small products in other orders, a few ulps apart). The
port's Layers also keep one storage for both kinds of caller:
``set_state_dict`` writes in place (the same ``data_ptr``), torch's own
``nn.Module.parameters()`` yields the very tensors the Parameters wrap,
and a torch input stays torch."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _net(P):
    """A Layer subclass using every registration path."""
    nn = P.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3, weight_attr=nn.ParamAttr(
                name="fc_w", initializer=nn.initializer.Constant(0.5)))
            self.norm = nn.LayerNorm([3])
            self.bn = nn.BatchNorm1D(3)
            self.blocks = nn.LayerList([nn.Linear(3, 3),
                                        nn.Linear(3, 3, bias_attr=False)])
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(2.0))
            self.register_buffer("steps", P.to_tensor(
                np.zeros([1], np.float32)))
            self.register_buffer("cache", P.to_tensor(
                np.ones([2], np.float32)), persistable=False)

        def forward(self, x):
            x = self.norm(self.fc(x)) * self.scale
            for block in self.blocks:
                x = block(x)
            return x

    return Net()


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _twins():
    """(reference Net, port Net) with the reference's weights."""
    pt.seed(0)
    jn = _net(pt)
    tn = _net(ptt)
    missing, unexpected = tn.set_state_dict(_arrays(jn))
    assert missing == [] and unexpected == []
    return jn, tn


X = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)


def _out(net, P, x=X):
    return np.asarray(net(P.to_tensor(x)).numpy())


def test_names_keys_and_types_match_the_reference():
    jn, tn = _twins()
    for what in ("named_parameters", "named_buffers", "named_sublayers"):
        assert [n for n, _ in getattr(tn, what)()] == \
            [n for n, _ in getattr(jn, what)()], what
    assert [n for n, _ in tn.named_children()] == \
        [n for n, _ in jn.named_children()]
    # the layer's own parameters first, then each sublayer's; then the
    # persistable buffers the same way
    assert list(tn.state_dict()) == list(jn.state_dict()) == [
        "scale", "fc.weight", "fc.bias", "norm.weight", "norm.bias",
        "bn.weight", "bn.bias", "blocks.0.weight", "blocks.0.bias",
        "blocks.1.weight", "steps", "bn._mean", "bn._variance"]
    assert [n for n, _ in tn.named_buffers()] == ["steps", "cache",
                                                  "bn._mean",
                                                  "bn._variance"]
    sd = tn.state_dict(structured_name_prefix="net.")
    assert list(sd)[:2] == ["net.scale", "net.fc.weight"]
    assert [type(l).__name__ for l in tn.sublayers()] == \
        [type(l).__name__ for l in jn.sublayers()]
    assert len(tn.sublayers(include_self=True)) == len(tn.sublayers()) + 1
    for p in tn.parameters():
        assert isinstance(p, ptt.nn.Parameter) and p.persistable
        assert p.trainable and not p.stop_gradient
        assert repr(p).startswith("Parameter Tensor(")
    assert isinstance(tn.steps, ptt.Tensor) and not isinstance(
        tn.steps, ptt.nn.Parameter)
    assert tn.fc.weight is tn.fc.weight           # one wrapper a name
    assert tn.blocks[1].bias is None and jn.blocks[1].bias is None
    assert tn.full_name() == jn.full_name() == "net"
    assert repr(tn) == repr(jn)
    assert tn.create_tensor().dtype == torch.float32


def test_param_attr_initializer_and_name():
    jn, tn = _twins()
    pt.seed(1)
    fresh = {P: _net(P) for P in (pt, ptt)}
    for P, net in fresh.items():
        assert net.fc.weight.name == "fc_w"
        np.testing.assert_array_equal(net.fc.weight.numpy(), 0.5)
        np.testing.assert_array_equal(net.scale.numpy(), 2.0)
        np.testing.assert_array_equal(net.fc.bias.numpy(), 0.0)
        np.testing.assert_array_equal(net.norm.weight.numpy(), 1.0)
    attr = ptt.nn.ParamAttr(name="w", initializer=None, learning_rate=0.5,
                            trainable=False)
    assert (attr.name, attr.learning_rate, attr.trainable) == ("w", 0.5,
                                                               False)
    # create_parameter reads the initializer and the name only, as the
    # reference's does: trainable=False leaves the parameter trainable
    for P in (pt, ptt):
        lin = P.nn.Linear(2, 2, weight_attr=P.nn.ParamAttr(
            name="w", trainable=False))
        assert lin.weight.name == "w" and lin.weight.trainable


def test_outputs_and_gradients_match_the_reference():
    jn, tn = _twins()
    np.testing.assert_allclose(_out(tn, ptt), _out(jn, pt), rtol=TOL,
                               atol=TOL)
    for P, net in ((pt, jn), (ptt, tn)):
        loss = net(P.to_tensor(X)).sum()
        loss.backward()
    for (n, jp), (_, tp) in zip(jn.named_parameters(),
                                tn.named_parameters()):
        if n.startswith("bn."):
            # out of the forward: no grad in either package
            assert tp.grad is None and jp.grad is None
            continue
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_hooks_replace_inputs_and_outputs_and_come_off():
    jn, tn = _twins()
    outs = {}
    for P, net in ((pt, jn), (ptt, tn)):
        base, base2 = _out(net, P), _out(net, P, X * 2)
        pre = net.fc.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        hooked = _out(net, P)
        np.testing.assert_array_equal(hooked, base2)
        pre.remove()
        np.testing.assert_array_equal(_out(net, P), base)
        post = net.register_forward_post_hook(
            lambda layer, inputs, out: out + 1.0)
        np.testing.assert_allclose(_out(net, P), base + 1.0, rtol=1e-6,
                                   atol=1e-6)
        post.remove()
        np.testing.assert_array_equal(_out(net, P), base)
        # a single value returned by a pre-hook is the one input
        one = net.fc.register_forward_pre_hook(
            lambda layer, inputs: inputs[0] * 0.0)
        outs[P] = (hooked, _out(net, P))
        one.remove()
    for got, want in zip(outs[ptt], outs[pt]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_trainable_apply_and_modes():
    jn, tn = _twins()
    for P, net in ((pt, jn), (ptt, tn)):
        net.fc.weight.trainable = False
        assert net.fc.weight.stop_gradient
        net(P.to_tensor(X)).sum().backward()
        assert net.fc.weight.grad is None
        assert net.fc.bias.grad is not None
        net.fc.weight.trainable = True
    seen = {}
    for P, net in ((pt, jn), (ptt, tn)):
        names = []
        net.apply(lambda layer: names.append(type(layer).__name__))
        seen[P] = names
        net.eval()
        assert not any(l.training for l in net.sublayers(include_self=True))
        net.train()
        assert all(l.training for l in net.sublayers(include_self=True))
    assert seen[ptt] == seen[pt]
    assert seen[ptt][-1] == "Net"                 # children first


def test_to_and_astype_cast_the_floating_state():
    jn, tn = _twins()
    for P, net in ((pt, jn), (ptt, tn)):
        assert net.astype("bfloat16") is net
    dt = {P: [str(v.dtype).split(".")[-1] for v in net.state_dict().values()]
          for P, net in ((pt, jn), (ptt, tn))}
    assert dt[ptt] == dt[pt] == ["bfloat16"] * 13
    w = tn.fc.weight
    tn.to(dtype="float32")
    assert tn.fc.weight is w and w.dtype == torch.float32
    tn.float()
    tn.half()
    assert tn.fc.weight.dtype == torch.float16
    tn.to(torch.float32)
    tn.to(device="cpu")
    tn.to("cpu", "float32")
    assert {p.place for p in tn.parameters()} == {ptt.CPUPlace()}
    np.testing.assert_allclose(_out(tn, ptt), _out(jn.astype("float32"),
                                                    pt), rtol=1e-2,
                               atol=1e-2)


def test_set_state_dict_writes_in_place():
    """The port's set_state_dict copies into the storage it holds: the
    data_ptr of every parameter and buffer stays, the values change,
    torch's registry holds the same objects, and Tensors, torch
    tensors and arrays are all taken."""
    jn, tn = _twins()
    ptrs = {k: v._data.data_ptr() for k, v in tn.state_dict().items()}
    torch_params = list(torch.nn.Module.parameters(tn))
    rng = np.random.default_rng(3)
    new = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in _arrays(jn).items()}
    for form in ("array", "tensor", "torch"):
        vals = {k: v if form == "array" else ptt.to_tensor(v)
                if form == "tensor" else torch.as_tensor(v)
                for k, v in new.items()}
        assert tn.set_state_dict(vals) == ([], [])
        got = tn.state_dict()
        assert {k: v._data.data_ptr() for k, v in got.items()} == ptrs
        for k, v in new.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert [p is w._data for p, w in zip(torch_params, tn.parameters())] \
        == [True] * len(torch_params)
    missing, unexpected = tn.set_state_dict({"nope": np.zeros(1)})
    assert unexpected == ["nope"] and "fc.weight" in missing
    assert jn.set_state_dict({"nope": np.zeros(1)})[1] == ["nope"]


def test_torch_inputs_stay_torch_and_share_storage():
    lin = ptt.nn.Linear(4, 3)
    out = lin(torch.as_tensor(X))
    assert type(out) is torch.Tensor
    assert isinstance(lin(ptt.to_tensor(X)), ptt.Tensor)
    torch.testing.assert_close(out, lin(ptt.to_tensor(X))._data, rtol=0,
                               atol=0)
    tp = dict(torch.nn.Module.named_parameters(lin))
    assert tp["weight"] is lin.weight._data
    assert isinstance(tp["weight"], torch.nn.Parameter)
    # a torch parent's state_dict recurses into the Layer as torch's
    seq = torch.nn.Sequential(lin)
    sd = seq.state_dict()
    assert list(sd) == ["0.weight", "0.bias"]
    assert all(type(v) is torch.Tensor for v in sd.values())
    # the optimizer steps the same storage either way
    opt = ptt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    before = lin.weight.numpy().copy()
    lin(ptt.to_tensor(X)).sum().backward()
    opt.step()
    assert not np.array_equal(lin.weight.numpy(), before)
    assert tp["weight"] is lin.weight._data


def test_deep_copy_keeps_wrappers_on_the_copy():
    lin = ptt.nn.Linear(2, 2)
    w = lin.weight
    twin = copy.deepcopy(lin)
    assert twin.weight._data is twin._parameters["weight"]
    assert twin.weight._data.data_ptr() != w._data.data_ptr()
    np.testing.assert_array_equal(twin.weight.numpy(), w.numpy())


@pytest.mark.parametrize("make", [
    lambda P: P.nn.Linear(64, 48),
    lambda P: P.nn.Embedding(300, 64),
    lambda P: P.nn.LayerNorm([4, 8]),
    lambda P: P.nn.RMSNorm(16),
    lambda P: P.nn.Conv2D(4, 8, 3),
], ids=["linear", "embedding", "layer_norm", "rms_norm", "conv2d"])
def test_default_initialisers_follow_the_reference(make):
    """Built with no initializer, a layer holds what the reference's
    draws: the same constants, or draws of the same law (bound and
    moments within a few standard errors), never uninitialised memory."""
    pt.seed(0)
    ptt.seed(0)
    jl, tl = make(pt), make(ptt)
    for (n, jp), (_, tp) in zip(jl.named_parameters(),
                                tl.named_parameters()):
        j, t = np.asarray(jp.numpy()), np.asarray(tp.numpy())
        assert j.shape == t.shape and np.isfinite(t).all(), n
        if np.ptp(j) == 0:
            np.testing.assert_array_equal(t, j, err_msg=n)
            continue
        assert np.ptp(t) > 0, n
        assert np.abs(t).max() <= np.abs(j).max() * 1.5 + 1e-6, n
        if j.size >= 1000:      # moments of large enough samples
            se = j.std() / np.sqrt(j.size)
            assert abs(t.mean() - j.mean()) < 8 * se, n
            assert abs(t.std() / j.std() - 1) < 0.1, n


def test_layer_norm_over_several_axes():
    """nn.LayerNorm([3, 4]) normalises each sample over its last two
    axes (std 1, mean 0), as the reference's."""
    x = np.random.default_rng(1).standard_normal((2, 3, 4)).astype(
        np.float32) * 3 + 1
    outs = [np.asarray(P.nn.LayerNorm([3, 4])(P.to_tensor(x)).numpy())
            for P in (pt, ptt)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[1].reshape(2, -1).std(1), 1.0,
                               rtol=1e-3)
    np.testing.assert_allclose(outs[1].reshape(2, -1).mean(1), 0.0,
                               atol=1e-5)


def test_parameter_list_and_add_parameter():
    vals = [np.full((2,), i, np.float32) for i in range(3)]
    got = {}
    for P in (pt, ptt):
        lst = P.nn.ParameterList([P.to_tensor(v) for v in vals[:2]])
        lst.append(P.to_tensor(vals[2]))
        layer = P.nn.Layer()
        p = layer.add_parameter("w", P.to_tensor(vals[1]))
        assert isinstance(p, P.nn.Parameter) and layer.w is p
        got[P] = ([n for n, _ in lst.named_parameters()],
                  [np.asarray(p.numpy()) for p in lst],
                  all(isinstance(p, P.nn.Parameter) for p in lst))
    assert got[ptt][0] == got[pt][0] == ["0", "1", "2"]
    assert got[ptt][2] and got[pt][2]
    for a, b in zip(got[ptt][1], got[pt][1]):
        np.testing.assert_array_equal(a, b)


def test_a_plain_torch_child_is_walked_as_a_layer():
    """A torch module a Layer holds is walked the same way as a Layer:
    a parameter it holds twice is given once for it, and its
    parameters, buffers and sublayers come wrapped under their
    structured names."""
    inner = torch.nn.Module()
    inner.a = torch.nn.Parameter(torch.ones(2))
    inner.b = inner.a
    inner.register_buffer("s", torch.zeros(2))
    inner.register_buffer("t", torch.zeros(1), persistent=False)
    inner.lin = torch.nn.Linear(2, 2)
    outer = ptt.nn.Layer()
    outer.inner = inner
    names = [n for n, _ in outer.named_parameters()]
    assert names == ["inner.a", "inner.lin.weight", "inner.lin.bias"]
    assert all(isinstance(p, ptt.nn.Parameter) for p in outer.parameters())
    assert outer.parameters()[0]._data is inner.a
    assert [n for n, _ in outer.named_buffers()] == ["inner.s", "inner.t"]
    assert list(outer.state_dict()) == names + ["inner.s"]
    assert [n for n, _ in outer.named_sublayers(include_self=True)] == [
        "", "inner", "inner.lin"]
    assert outer.sublayers() == [inner, inner.lin]
