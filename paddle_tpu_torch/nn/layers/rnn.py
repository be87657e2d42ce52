"""RNN layers (counterpart of paddle_tpu/nn/layers/rnn.py): LSTM, GRU and
SimpleRNN over the registered recurrences ``lstm_scan``, ``gru_scan``
and ``simple_rnn_scan``, their cells, ``RNN`` (any cell over the time
axis) and ``BiRNN``.

The reference runs each recurrence as one ``lax.scan``. The port writes
it in PyTorch, step for step as the scan computes it: the input
products of all T steps in one ``torch.matmul`` by ``w_ihᵀ`` first,
then per step the hidden product and the gates in paddle's order (i,
f, g, o for the LSTM; r, z, c with ``n = tanh(ic + r * hc)`` for the
GRU). ``reverse=True`` walks the steps backwards and leaves out[t] at
input position t, as ``lax.scan(reverse=True)`` does. No cuDNN RNN
(``torch.nn.LSTM``) is called.

As in the reference: the stacked layers' weights are named
``weight_ih_l{k}{_reverse}``, ``weight_hh_l…``, ``bias_ih_l…``,
``bias_hh_l…`` and drawn from Uniform(±1/√hidden) (the port's default
generator, or ``init_generator``); ``LSTM`` / ``GRU`` take the
``*_attr`` arguments and do not use them; ``_RNNBase.forward`` and
``BiRNN`` take ``sequence_length`` and do not use it (only ``RNN``
masks by length); dropout runs between stacked layers only, drawn from
the port's keyword-only ``generator``. A Tensor input gives Tensors
back (the eager API), a torch tensor torch tensors."""
from __future__ import annotations

import numpy as np
import torch

from ...core.dtype import to_dtype
from ...core.tensor import Tensor
from ... import ops  # at call time: ops imports nn first
from ...ops.registry import register_op
from .. import functional as F
from ..initializer import Uniform
from ..layer import Layer

__all__ = ["LSTM", "GRU", "SimpleRNN", "LSTMCell", "GRUCell",
           "RNNCellBase", "SimpleRNNCell", "RNN", "BiRNN"]


def _same_dtype(*ts):
    """The tensors (None kept) cast to their common dtype, as jnp
    promotes mixed operands."""
    dt = None
    for t in ts:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


def _steps(n, reverse):
    return range(n - 1, -1, -1) if reverse else range(n)


@register_op("lstm_scan")
def _lstm_scan(x, h0, c0, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """x [seq, batch, in]; weights in paddle's gate order i, f, g, o.
    Returns (out [seq, batch, hidden], h_T, c_T)."""
    x, h, c, w_ih, w_hh, b_ih, b_hh = _same_dtype(x, h0, c0, w_ih, w_hh,
                                                  b_ih, b_hh)
    xw = torch.matmul(x, w_ih.T)
    w_hh_t = w_hh.T
    outs = [None] * x.shape[0]
    for t in _steps(x.shape[0], reverse):
        gates = xw[t] + torch.matmul(h, w_hh_t)
        if b_ih is not None:
            gates = gates + b_ih + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs), h, c


@register_op("gru_scan")
def _gru_scan(x, h0, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """x [seq, batch, in]; gates r, z, c. Returns (out, h_T)."""
    x, h, w_ih, w_hh, b_ih, b_hh = _same_dtype(x, h0, w_ih, w_hh, b_ih,
                                               b_hh)
    gi_all = torch.matmul(x, w_ih.T)
    if b_ih is not None:
        gi_all = gi_all + b_ih
    w_hh_t = w_hh.T
    outs = [None] * x.shape[0]
    for t in _steps(x.shape[0], reverse):
        gh = torch.matmul(h, w_hh_t)
        if b_hh is not None:
            gh = gh + b_hh
        ir, iz, ic = gi_all[t].chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(ic + r * hc)
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs), h


@register_op("simple_rnn_scan")
def _rnn_scan(x, h0, w_ih, w_hh, b_ih, b_hh, activation="tanh",
              reverse=False):
    """h = act(x_t w_ihᵀ + h w_hhᵀ + b_ih + b_hh), act tanh or relu.
    Returns (out, h_T)."""
    x, h, w_ih, w_hh, b_ih, b_hh = _same_dtype(x, h0, w_ih, w_hh, b_ih,
                                               b_hh)
    act = torch.tanh if activation == "tanh" else torch.relu
    xw = torch.matmul(x, w_ih.T)
    w_hh_t = w_hh.T
    outs = [None] * x.shape[0]
    for t in _steps(x.shape[0], reverse):
        pre = xw[t] + torch.matmul(h, w_hh_t)
        pre = pre + (b_ih if b_ih is not None else 0.0)
        pre = pre + (b_hh if b_hh is not None else 0.0)
        h = act(pre)
        outs[t] = h
    return torch.stack(outs), h


# ---- helpers that take Tensors (the eager API) and torch tensors alike
def _is_tensor(x):
    return isinstance(x, Tensor)


def _full(like, shape, value=0.0, dtype=torch.float32):
    t = torch.full(shape, value, dtype=dtype, device=(
        like._data if _is_tensor(like) else like).device)
    return Tensor._wrap(t, stop_gradient=True) if _is_tensor(like) else t


def _stack(xs, axis):
    return ops.manipulation.stack(xs, axis) if any(map(_is_tensor, xs)) \
        else torch.stack(xs, axis)


def _concat(xs, axis):
    return ops.manipulation.concat(xs, axis) if any(map(_is_tensor, xs)) \
        else torch.cat(xs, axis)


def _swap_batch_time(x):
    return ops.manipulation.transpose(x, (1, 0, 2))


_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


class _RNNBase(Layer):
    """Stacked, optionally bidirectional recurrences (rnn.py:71). The
    port's keyword-only ``device``, ``dtype`` and ``init_generator`` make
    the weights; ``generator`` draws the dropout between layers."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, *, device=None,
                 dtype="float32", init_generator=None, generator=None):
        super().__init__(dtype=dtype)
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.generator = generator
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") \
            else 1
        rows = _GATES[mode] * hidden_size
        std = 1.0 / np.sqrt(hidden_size)
        kw = dict(default_initializer=Uniform(-std, std), device=device,
                  generator=init_generator)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_size = input_size if layer == 0 \
                    else hidden_size * self.bidirect
                sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
                names = (f"weight_ih{sfx}", f"weight_hh{sfx}",
                         f"bias_ih{sfx}", f"bias_hh{sfx}")
                for name, shape, is_bias in zip(
                        names, ((rows, in_size), (rows, hidden_size),
                                (rows,), (rows,)),
                        (False, False, True, True)):
                    self.add_parameter(name, self.create_parameter(
                        shape, is_bias=is_bias, **kw))
                self._all_weights.append(names)

    def _weights(self, layer, d):
        names = self._all_weights[layer * self.bidirect + d]
        return tuple(self._parameters[n] for n in names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else _swap_batch_time(inputs)
        batch = x.shape[1]
        shape = (self.num_layers * self.bidirect, batch, self.hidden_size)
        if self.mode == "LSTM":
            h0, c0 = (_full(x, shape), _full(x, shape)) \
                if initial_states is None else initial_states
        else:
            h0 = _full(x, shape) if initial_states is None \
                else initial_states
        h_outs, c_outs = [], []
        out = x
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(self.bidirect):
                w_ih, w_hh, b_ih, b_hh = self._weights(layer, d)
                s = layer * self.bidirect + d
                if self.mode == "LSTM":
                    o, h_t, c_t = _lstm_scan(out, h0[s], c0[s], w_ih, w_hh,
                                             b_ih, b_hh, reverse=(d == 1))
                    c_outs.append(c_t)
                elif self.mode == "GRU":
                    o, h_t = _gru_scan(out, h0[s], w_ih, w_hh, b_ih, b_hh,
                                       reverse=(d == 1))
                else:
                    o, h_t = _rnn_scan(
                        out, h0[s], w_ih, w_hh, b_ih, b_hh,
                        activation="tanh" if self.mode == "RNN_TANH"
                        else "relu", reverse=(d == 1))
                h_outs.append(h_t)
                dir_outs.append(o)
            out = dir_outs[0] if self.bidirect == 1 \
                else _concat(dir_outs, -1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training,
                                generator=self.generator)
        if not self.time_major:
            out = _swap_batch_time(out)
        h_n = _stack(h_outs, 0)
        if self.mode == "LSTM":
            return out, (h_n, _stack(c_outs, 0))
        return out, h_n


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype="float32", init_generator=None,
                 generator=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype, init_generator=init_generator,
                         generator=generator)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype="float32", init_generator=None,
                 generator=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype, init_generator=init_generator,
                         generator=generator)


class SimpleRNN(_RNNBase):
    """activation "tanh" or (any other value) "relu"; further keywords
    are taken and not used, as in the reference."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", name=None, *, device=None,
                 dtype="float32", init_generator=None, generator=None,
                 **kw):
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout, device=device, dtype=dtype,
                         init_generator=init_generator, generator=generator)


def _cell_weights(layer, gates, input_size, hidden_size, device,
                  generator):
    """weight_ih, weight_hh, bias_ih, bias_hh of a cell, all from
    Uniform(±1/√hidden)."""
    std = 1.0 / np.sqrt(hidden_size)
    kw = dict(default_initializer=Uniform(-std, std), device=device,
              generator=generator)
    rows = gates * hidden_size
    layer.weight_ih = layer.create_parameter((rows, input_size), **kw)
    layer.weight_hh = layer.create_parameter((rows, hidden_size), **kw)
    layer.bias_ih = layer.create_parameter((rows,), is_bias=True, **kw)
    layer.bias_hh = layer.create_parameter((rows,), is_bias=True, **kw)


class RNNCellBase(Layer):
    """Base of the single-step cells (rnn.py:266)."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """[batch, hidden] filled with `init_value` in `dtype`; `shape`
        is taken and not used, as in the reference."""
        return _full(batch_ref, (batch_ref.shape[batch_dim_idx],
                                 self.hidden_size), init_value,
                     to_dtype(dtype))


class LSTMCell(Layer):
    """One LSTM step through ``lstm_scan``; returns (h, (h, c))."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype="float32",
                 init_generator=None):
        super().__init__(dtype=dtype)
        self.hidden_size = hidden_size
        _cell_weights(self, 4, input_size, hidden_size, device,
                      init_generator)

    def forward(self, inputs, states=None):
        if states is None:
            shape = (inputs.shape[0], self.hidden_size)
            states = (_full(inputs, shape), _full(inputs, shape))
        h, c = states
        p = self._parameters
        _, h_t, c_t = _lstm_scan(inputs[None], h, c, p["weight_ih"],
                                 p["weight_hh"], p["bias_ih"], p["bias_hh"])
        return h_t, (h_t, c_t)


class GRUCell(Layer):
    """One GRU step through ``gru_scan``; returns (h, h). Further
    keywords are taken and not used, as in the reference."""

    def __init__(self, input_size, hidden_size, name=None, *, device=None,
                 dtype="float32", init_generator=None, **kw):
        super().__init__(dtype=dtype)
        self.hidden_size = hidden_size
        _cell_weights(self, 3, input_size, hidden_size, device,
                      init_generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = _full(inputs, (inputs.shape[0], self.hidden_size))
        p = self._parameters
        _, h_t = _gru_scan(inputs[None], states, p["weight_ih"],
                           p["weight_hh"], p["bias_ih"], p["bias_hh"])
        return h_t, h_t


class SimpleRNNCell(RNNCellBase):
    """h = act(x w_ihᵀ + b_ih + h w_hhᵀ + b_hh) through the matmul op (in
    that order, as the reference adds them); returns (h, h)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype="float32", init_generator=None):
        super().__init__(dtype=dtype)
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_weights(self, 1, input_size, hidden_size, device,
                      init_generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = _full(inputs, (inputs.shape[0], self.hidden_size))
        p = self._parameters
        pre = (F.matmul(inputs, p["weight_ih"], transpose_y=True)
               + p["bias_ih"]
               + F.matmul(states, p["weight_hh"], transpose_y=True)
               + p["bias_hh"])
        h = F.tanh(pre) if self.activation == "tanh" else F.relu(pre)
        return h, h


class RNN(Layer):
    """Any cell over the time axis, one Python step at a time (rnn.py:290).
    With `sequence_length` ([batch]), a step at or past a sequence's
    length outputs zeros and keeps that sequence's states; the outputs
    keep input order when `is_reverse` walks the steps backwards."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else _swap_batch_time(inputs)
        n = x.shape[0]
        states = initial_states
        outs = [None] * n
        for t in _steps(n, self.is_reverse):
            out, new_states = self.cell(x[t], states)
            if sequence_length is not None:
                out = out * _live(sequence_length, t, out)
                new_states = _keep_past_length(sequence_length, t,
                                               new_states, states)
            outs[t] = out
            states = new_states
        seq = _stack(outs, 0)
        return (seq if self.time_major else _swap_batch_time(seq)), states


def _live(sequence_length, t, like, dtype=None):
    """[batch, 1] of 1.0 where t < sequence_length, else 0.0, in `like`'s
    dtype (or `dtype`) and kind (Tensor or torch tensor)."""
    raw = like._data if _is_tensor(like) else like
    lens = sequence_length._data if _is_tensor(sequence_length) \
        else torch.as_tensor(sequence_length, device=raw.device)
    m = (lens > t).to(dtype or raw.dtype).unsqueeze(-1)
    return Tensor._wrap(m, stop_gradient=True) if _is_tensor(like) else m


def _keep_past_length(sequence_length, t, new, old):
    """The new states where t < sequence_length, else the old (zeros
    when there were none), as the reference's _mask_step mixes them
    with an f32 mask."""
    def mix(n, o):
        live = _live(sequence_length, t, n, torch.float32)
        return n * live if o is None else n * live + o * (1.0 - live)

    if isinstance(new, tuple):
        old = old if isinstance(old, tuple) else (None,) * len(new)
        return tuple(mix(n, o) for n, o in zip(new, old))
    return mix(new, old)


class BiRNN(Layer):
    """A forward and a backward ``RNN``, their outputs concatenated on the
    last axis; returns (out, (forward states, backward states)).
    `sequence_length` is taken and not used, as in the reference."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw0, bw0 = (None, None) if initial_states is None \
            else initial_states
        out_f, st_f = self.rnn_fw(inputs, fw0)
        out_b, st_b = self.rnn_bw(inputs, bw0)
        return _concat([out_f, out_b], -1), (st_f, st_b)
