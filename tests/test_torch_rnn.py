"""The port's RNN layers (paddle_tpu_torch/nn/layers/rnn.py) against the
reference's on the CPU, from the same weights (the reference draws
them, the port loads its ``state_dict`` by name): LSTM, GRU and
SimpleRNN (tanh, relu) in every direction and time layout, 1 and 2
layers, with and without initial states; the cells; ``RNN`` over a
cell with and without ``sequence_length`` and reversed; ``BiRNN``. Each
compares the outputs, the final states and the gradients of the input
and of every weight through ``backward()`` of a fixed cotangent.

Tolerance: 1e-5 (rtol = atol). Both sides compute the same f32
recurrence; the port multiplies all steps' inputs by w_ihᵀ in one
product where the reference's scan multiplies one step at a time, and
XLA and torch sum the products in other orders, a few ulps apart, which
the recurrence carries over 6 steps.

Also here: the reference's own scan-body cases
(tests/test_rnn_scan_conformance.py, held to torch.nn's RNNs as there),
the arguments the reference takes and ignores (ignored alike), the
initialisation's bounds, the LSTM language model of
tests/lstm_lm_script.py for 3 SGD steps on both packages, and its
TrainStep steps (the hidden state carried in a tensor that each step
writes) against its eager steps."""
import numpy as np
import pytest
import torch

import lstm_lm_script as LM
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.nn.layers import rnn as jrnn
from paddle_tpu_torch.nn.layers import rnn as trnn
from torch_port_helpers import cpu_place
from torch_port_helpers import twin_layers as _twin

TOL = dict(rtol=1e-5, atol=1e-5)
S, B, I, H = 6, 3, 5, 4


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _np(t):
    return np.asarray(t.numpy())


def _w(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(P, layer, arrays, call, seed=7):
    """(outputs, {name: grad}) of `call(layer, *Tensors of arrays)`: the
    outputs flattened, the grads of every parameter and of the first
    input after backward() of sum(out * fixed cotangent)."""
    ts = [P.to_tensor(a, stop_gradient=(i > 0)) for i, a in
          enumerate(arrays)]
    outs = _flat(call(layer, *ts))
    rng = np.random.default_rng(seed)
    total = None
    for o in outs:
        cot = P.to_tensor(rng.standard_normal(tuple(o.shape)).astype(
            np.float32))
        term = (o * cot).sum()
        total = term if total is None else total + term
    total.backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    grads["input"] = _np(ts[0].grad)
    return [_np(o) for o in outs], grads


def _held(got, want):
    (go, gg), (wo, wg) = got, want
    assert len(go) == len(wo)
    for i, (a, b) in enumerate(zip(go, wo)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=f"output {i}", **TOL)
    assert set(gg) == set(wg)
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], err_msg=f"grad {k}", **TOL)


MODES = [("LSTM", {}), ("GRU", {}), ("SimpleRNN", {}),
         ("SimpleRNN", {"activation": "relu"})]


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("time_major", [False, True],
                         ids=["batch_major", "time_major"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode,kw", MODES,
                         ids=["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_layer_matches_reference(mode, kw, direction, time_major,
                                     layers):
    """Outputs, final states and gradients; the 2-layer cases start
    from given states, the 1-layer ones from zeros."""
    jm, tm = _twin(mode, I, H, num_layers=layers, direction=direction,
                   time_major=time_major, **kw)
    n_dir = 2 if direction == "bidirect" else 1
    x = _w((S, B, I) if time_major else (B, S, I), 1)
    arrays = [x]
    if layers == 2:
        arrays.append(_w((layers * n_dir, B, H), 2))
        if mode == "LSTM":
            arrays.append(_w((layers * n_dir, B, H), 3))

    def call(m, x, *st):
        if not st:
            return m(x)
        return m(x, tuple(st) if len(st) == 2 else st[0])

    _held(_run(ptt, tm, arrays, call), _run(pt, jm, arrays, call))


def test_rnn_layer_on_torch_tensors_equals_tensors():
    """A torch input runs the same code and gives torch tensors."""
    _, tm = _twin("LSTM", I, H, num_layers=2, direction="bidirect")
    x = _w((B, S, I), 1)
    out_t, (h_t, c_t) = tm(ptt.to_tensor(x))
    out, (h, c) = tm(torch.from_numpy(x))
    assert type(out) is torch.Tensor and type(h) is torch.Tensor
    for a, b in ((out, out_t), (h, h_t), (c, c_t)):
        assert torch.equal(a, b._data)
    assert out.shape == (B, S, 2 * H) and h.shape == (4, B, H)


def test_rnn_dropout_only_between_layers():
    """Dropout in training mode drops between stacked layers only: one
    layer gives the dropout-free output, two layers do not, and eval
    mode gives it for both."""
    x = ptt.to_tensor(_w((B, S, I), 1))
    for layers in (1, 2):
        _, plain = _twin("GRU", I, H, num_layers=layers)
        _, drop = _twin("GRU", I, H, num_layers=layers, dropout=0.5)
        want = _np(plain(x)[0])
        got = _np(drop(x)[0])
        assert np.array_equal(got, want) == (layers == 1)
        drop.eval()
        assert np.array_equal(_np(drop(x)[0]), want)


def test_rnn_reverse_writes_input_positions():
    """reverse=True leaves out[t] at input position t: the reversed scan
    of x equals the flipped forward scan of flip(x)."""
    x, h0 = torch.from_numpy(_w((S, B, I), 0)), torch.from_numpy(
        _w((B, H), 1))
    w = [torch.from_numpy(_w(s, 3 + i)) for i, s in enumerate(
        ((3 * H, I), (3 * H, H), (3 * H,), (3 * H,)))]
    rev, h_r = trnn._gru_scan(x, h0, *w, reverse=True)
    fwd, h_f = trnn._gru_scan(x.flip(0), h0, *w)
    torch.testing.assert_close(rev, fwd.flip(0), rtol=0, atol=0)
    torch.testing.assert_close(h_r, h_f, rtol=0, atol=0)


def test_reference_ignored_arguments_are_ignored():
    """As in the reference: LSTM / GRU take the weight and bias attrs
    and do not use them, _RNNBase.forward and BiRNN take
    sequence_length and do not use it."""
    attr = ptt.nn.initializer.Constant(3.0)
    for cls in (ptt.nn.LSTM, ptt.nn.GRU):
        m = cls(I, H, weight_ih_attr=attr, bias_hh_attr=attr)
        assert float(np.abs(_np(m.weight_ih_l0)).max()) <= 1 / np.sqrt(H)
        assert float(np.abs(_np(m.bias_hh_l0)).max()) <= 1 / np.sqrt(H)
    _, tm = _twin("LSTM", I, H)
    x = ptt.to_tensor(_w((B, S, I), 1))
    lens = ptt.to_tensor(np.array([2, 6, 1], np.int32))
    assert np.array_equal(_np(tm(x)[0]), _np(tm(x, None, lens)[0]))
    bi = ptt.nn.BiRNN(ptt.nn.SimpleRNNCell(I, H),
                      ptt.nn.SimpleRNNCell(I, H))
    assert np.array_equal(_np(bi(x)[0]), _np(bi(x, None, lens)[0]))


def test_rnn_initialisation_bounds():
    """Uniform(±1/√hidden) for every weight and bias, as the reference
    draws them (compared by bounds and moments, not draw for draw)."""
    hidden = 64
    m = ptt.nn.LSTM(32, hidden, num_layers=2, direction="bidirect")
    bound = 1 / np.sqrt(hidden)
    names = [n for n, _ in m.named_parameters()]
    assert names == [n for n, _ in pt.nn.LSTM(
        32, hidden, num_layers=2, direction="bidirect").named_parameters()]
    allw = np.concatenate([_np(p).ravel() for p in m.parameters()])
    assert np.abs(allw).max() <= bound
    np.testing.assert_allclose(allw.std(), bound / np.sqrt(3), rtol=0.02)
    assert abs(allw.mean()) < 0.01 * bound


@pytest.mark.parametrize("name,kw,gates", [
    ("LSTMCell", {}, 4), ("GRUCell", {}, 3), ("SimpleRNNCell", {}, 1),
    ("SimpleRNNCell", {"activation": "relu"}, 1)],
    ids=["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("with_states", [False, True])
def test_cell_matches_reference(name, kw, gates, with_states):
    jm, tm = _twin(name, I, H, **kw)
    arrays = [_w((B, I), 1)]
    if with_states:
        arrays.append(_w((B, H), 2))
        if name == "LSTMCell":
            arrays.append(_w((B, H), 3))

    def call(m, x, *st):
        if not st:
            return m(x)
        return m(x, tuple(st) if len(st) == 2 else st[0])

    _held(_run(ptt, tm, arrays, call), _run(pt, jm, arrays, call))


def test_cell_initial_states():
    jm, tm = _twin("SimpleRNNCell", I, H)
    ref = pt.to_tensor(_w((B, I), 1))
    got = tm.get_initial_states(ptt.to_tensor(_w((B, I), 1)),
                                init_value=0.5)
    want = jm.get_initial_states(ref, init_value=0.5)
    assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def _twin_rnn(cell_name, reverse=False, seed=0, **kw):
    jc, tc = _twin(cell_name, I, H, seed=seed, **kw)
    return (pt.nn.RNN(jc, is_reverse=reverse),
            ptt.nn.RNN(tc, is_reverse=reverse))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("lengths", [False, True],
                         ids=["full", "sequence_length"])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_rnn_over_cell_matches_reference(cell, lengths, reverse):
    """RNN steps the cell in Python; with sequence_length a step past a
    sequence's length outputs zeros and keeps its states."""
    jm, tm = _twin_rnn(cell, reverse)
    arrays = [_w((B, S, I), 1)]
    lens = np.array([6, 3, 1], np.int32)

    def call(m, x):
        if not lengths:
            return m(x)
        P = pt if isinstance(m, pt.nn.Layer) else ptt
        return m(x, None, P.to_tensor(lens))

    got, want = _run(ptt, tm, arrays, call), _run(pt, jm, arrays, call)
    _held(got, want)
    if lengths and not reverse:
        out = got[0][0]
        assert np.abs(out[1, 3:]).max() == 0 and np.abs(out[2, 1:]).max() \
            == 0


def test_birnn_matches_reference():
    jf, tf = _twin("GRUCell", I, H, seed=0)
    jb, tb = _twin("GRUCell", I, H, seed=1)
    jm, tm = pt.nn.BiRNN(jf, jb), ptt.nn.BiRNN(tf, tb)
    arrays = [_w((B, S, I), 1)]
    got, want = (_run(ptt, tm, arrays, lambda m, x: m(x)),
                 _run(pt, jm, arrays, lambda m, x: m(x)))
    _held(got, want)
    assert got[0][0].shape == (B, S, 2 * H)


# ---- the reference's scan-body cases (tests/test_rnn_scan_conformance.py)
def _torch_rnn(mode, x, h0, c0, w):
    m = {"LSTM": torch.nn.LSTM, "GRU": torch.nn.GRU,
         "RNN": torch.nn.RNN}[mode](I, H, 1)
    with torch.no_grad():
        for name, a in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                            "bias_hh_l0"), w):
            getattr(m, name).copy_(torch.from_numpy(a))
    st = torch.from_numpy(h0[None])
    if mode == "LSTM":
        st = (st, torch.from_numpy(c0[None]))
    out, hT = m(torch.from_numpy(x), st)
    hT = hT if mode != "LSTM" else hT
    flat = [out] + (list(hT) if mode == "LSTM" else [hT])
    return [t.detach().numpy().reshape(-1) for t in flat]


@pytest.mark.parametrize("mode,gates,fn", [
    ("LSTM", 4, "_lstm_scan"), ("GRU", 3, "_gru_scan"),
    ("RNN", 1, "_rnn_scan")])
def test_scan_body_matches_torch_rnn(mode, gates, fn):
    """Each body against torch.nn's RNN of that kind (the gate orders are
    paddle's and torch's alike), within the reference test's 1e-4 /
    1e-5, and against the reference's body."""
    x, h0, c0 = _w((7, B, I), 0, 0.3), _w((B, H), 1, 0.3), _w((B, H), 2,
                                                              0.3)
    w = [_w(s, 3 + i, 0.3) for i, s in enumerate(
        ((gates * H, I), (gates * H, H), (gates * H,), (gates * H,)))]
    args = [x, h0] + ([c0] if mode == "LSTM" else []) + w
    got = getattr(trnn, fn)(*[torch.from_numpy(a) for a in args])
    want = _torch_rnn(mode, x, h0, c0, w)
    ref = getattr(jrnn, fn)(*[pt.to_tensor(a) for a in args])
    for g, wt, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy().reshape(-1), wt, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), _np(r), **TOL)


def test_scan_bodies_differentiable_without_biases():
    """The scan ops train inside nn.LSTM: a body without biases gives a
    finite, nonzero w_ih gradient, equal to the reference's."""
    grads = []
    for P in (pt, ptt):
        x = P.to_tensor(_w((7, B, I), 0))
        z = P.to_tensor(np.zeros((B, H), np.float32))
        w_ih = P.to_tensor(_w((4 * H, I), 3))
        w_ih.stop_gradient = False
        w_hh = P.to_tensor(_w((4 * H, H), 4))
        body = (jrnn if P is pt else trnn)._lstm_scan
        out, _, _ = body(x, z, z, w_ih, w_hh, None, None)
        (out * out).mean().backward()
        grads.append(_np(w_ih.grad))
    assert np.isfinite(grads[1]).all() and np.abs(grads[1]).sum() > 0
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


# ---- the LSTM language model (tests/lstm_lm_script.py)
V, LAYERS, LM_H, LM_B, LM_S = 50, 2, 16, 4, 6


def _lm_setup():
    w = LM.lm_weights(V, LM_H, LAYERS, seed=1, init_scale=0.3)
    return w, LM.lm_batches(V, LM_B, LM_S, 3, seed=2)


def test_lstm_lm_script_matches_reference():
    """3 SGD steps (lr 1, clip_grad_norm_ 10, the states carried and
    detached) of the script's model at dropout 0 on both packages from
    the same weights and tokens: losses, parameters and final states
    within TOL."""
    weights, batches = _lm_setup()
    runs = {}
    for P in (pt, ptt):
        m = LM.lm_from_weights(P, weights, LAYERS, 0.0)
        opt = P.optimizer.SGD(learning_rate=1.0, parameters=m.parameters())
        losses, (h, c) = LM.lm_steps(
            P, m, opt, batches, LM.zero_states(P, LAYERS, LM_B, LM_H), 10.0)
        runs[P] = (losses, {k: _np(v) for k, v in m.state_dict().items()},
                   _np(h), _np(c))
    (gl, gp, gh, gc), (wl, wp, wh, wc) = runs[ptt], runs[pt]
    np.testing.assert_allclose(gl, wl, **TOL)
    assert list(gp) == list(wp) == list(weights)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], err_msg=k, **TOL)
        assert not np.array_equal(gp[k], weights[k]), k
    np.testing.assert_allclose(gh, wh, **TOL)
    np.testing.assert_allclose(gc, wc, **TOL)


def test_lstm_lm_clip_engages():
    """The clip is live at these widths: with max norm 0.1 the steps
    differ from unclipped ones."""
    weights, batches = _lm_setup()
    out = []
    for clip in (None, 0.1):
        m = LM.lm_from_weights(ptt, weights, LAYERS, 0.0)
        opt = ptt.optimizer.SGD(learning_rate=1.0,
                                parameters=m.parameters())
        out.append(LM.lm_steps(ptt, m, opt, batches, LM.zero_states(
            ptt, LAYERS, LM_B, LM_H), clip)[0])
    assert out[0][0] == out[1][0] and out[0][1:] != out[1][1:]


def test_lstm_lm_train_step_carries_states():
    """chip_smoke.py's phase 24 step: TrainStep over the model with the
    hidden state carried in tensors the loss function writes each step
    equals the eager steps without a clip (TrainStep clips nothing, as
    the reference's), bit for bit on one thread; the carried states are
    the eager run's last ones."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    weights, batches = _lm_setup()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = LM.lm_from_weights(ptt, weights, LAYERS, 0.0)
        opt = ptt.optimizer.SGD(learning_rate=1.0,
                                parameters=m.parameters())
        want, (h, c) = LM.lm_steps(ptt, m, opt, batches, LM.zero_states(
            ptt, LAYERS, LM_B, LM_H))
        g = LM.lm_from_weights(ptt, weights, LAYERS, 0.0)
        step, carry = cs.lstm_train_step(g, 1.0, LAYERS, LM_B, LM_H,
                                         device="cpu")
        got = [float(step(torch.from_numpy(i), torch.from_numpy(lb)))
               for i, lb in batches]
    finally:
        torch.set_num_threads(threads)
    assert got == want
    torch.testing.assert_close(carry[0], h._data, rtol=0, atol=0)
    torch.testing.assert_close(carry[1], c._data, rtol=0, atol=0)
    for k, v in m.state_dict().items():
        torch.testing.assert_close(g.state_dict()[k]._data, v._data,
                                   rtol=0, atol=0)
