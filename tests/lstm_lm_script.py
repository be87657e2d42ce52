"""An LSTM language model, written once against the public API both
packages share: `P` is ``paddle_tpu`` or ``paddle_tpu_torch``. It
imports neither, so the card's machine (which has no JAX) runs it from
chip_smoke.py's phase 24 as the CPU tests run it on both packages.

The model is the "large" PTB configuration of Zaremba, Sutskever and
Vinyals, "Recurrent Neural Network Regularization" (2014), which
PaddlePaddle/models' dygraph ``ptb_lm`` also uses: a 10,000-word
embedding of width 1500, dropout, a 2-layer LSTM of 1500 units
(dropout between the layers), dropout, and a linear decoder to the
vocabulary; batches of 20 sequences of 35 unrolled steps; weights
uniform in ±0.04; SGD at learning rate 1 with the gradients clipped to
a global norm of 10; dropout 0.65. The hidden state is carried from one
batch to the next and detached, as truncated backpropagation through
time does. Built from ``P.nn.Embedding``, ``P.nn.Dropout``,
``P.nn.LSTM`` and ``P.nn.Linear`` with ``P.nn.functional.cross_entropy``;
its ``state_dict()`` keys are ``embedding.weight``,
``lstm.weight_ih_l0`` ... and ``decoder.weight`` / ``decoder.bias``, so
weights go in by ``set_state_dict``. Tokens are random from a numpy
seed (no text is fetched)."""
import numpy as np

PTB_LARGE = dict(vocab_size=10000, hidden_size=1500, num_layers=2,
                 batch_size=20, num_steps=35, dropout=0.65, init_scale=0.04,
                 max_grad_norm=10.0, lr=1.0)


def lm_weights(vocab_size, hidden_size, num_layers, seed=0,
               init_scale=0.04):
    """{state_dict name: f32 array} drawn uniform in ±init_scale."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-init_scale, init_scale, shape).astype(
            np.float32)

    w = {"embedding.weight": u(vocab_size, hidden_size)}
    for k in range(num_layers):
        w[f"lstm.weight_ih_l{k}"] = u(4 * hidden_size, hidden_size)
        w[f"lstm.weight_hh_l{k}"] = u(4 * hidden_size, hidden_size)
        w[f"lstm.bias_ih_l{k}"] = u(4 * hidden_size)
        w[f"lstm.bias_hh_l{k}"] = u(4 * hidden_size)
    w["decoder.weight"] = u(hidden_size, vocab_size)
    w["decoder.bias"] = u(vocab_size)
    return w


def build_lm(P, vocab_size, hidden_size, num_layers, dropout):
    """The LSTM LM of Layers, its weights by the layers' defaults on the
    default place. ``forward(ids, h0, c0)`` -> (logits [b, s, vocab], h,
    c), the states [num_layers, b, hidden]."""
    nn = P.nn

    class LSTMLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab_size, hidden_size)
            self.drop = nn.Dropout(dropout)
            self.lstm = nn.LSTM(hidden_size, hidden_size,
                                num_layers=num_layers, dropout=dropout)
            self.decoder = nn.Linear(hidden_size, vocab_size)

        def forward(self, ids, h0, c0):
            x = self.drop(self.embedding(ids))
            out, (h, c) = self.lstm(x, (h0, c0))
            return self.decoder(self.drop(out)), h, c

    return LSTMLM()


def lm_from_weights(P, weights, num_layers, dropout):
    """``build_lm`` at the widths of `weights`, loaded with them."""
    vocab, hidden = weights["embedding.weight"].shape
    model = build_lm(P, int(vocab), int(hidden), num_layers, dropout)
    missing, unexpected = model.set_state_dict(weights)
    assert not missing and not unexpected, (missing, unexpected)
    return model


def lm_batches(vocab_size, batch_size, num_steps, n, seed=0):
    """`n` consecutive (ids, labels) int32 [batch, num_steps] windows of
    `batch_size` random token streams, labels the next tokens (PTB's
    reader cuts its stream this way)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, vocab_size, (batch_size, n * num_steps + 1)
                        ).astype(np.int32)
    return [(data[:, i * num_steps:(i + 1) * num_steps],
             data[:, i * num_steps + 1:(i + 1) * num_steps + 1])
            for i in range(n)]


def lm_loss(P, model, ids, labels, h, c):
    """(mean next-token loss, h, c) of `model` on ids / labels [b, s]
    from states h, c (Tensors, or torch tensors on the port)."""
    logits, h, c = model(ids, h, c)
    v = logits.shape[-1]
    loss = P.nn.functional.cross_entropy(logits.reshape([-1, v]),
                                         labels.reshape([-1]))
    return loss, h, c


def zero_states(P, num_layers, batch_size, hidden_size, place=None):
    shape = [num_layers, batch_size, hidden_size]
    z = np.zeros(shape, np.float32)
    return P.to_tensor(z, place=place), P.to_tensor(z, place=place)


def lm_steps(P, model, opt, batches, states, max_grad_norm=None,
             place=None, on_step=None):
    """One step of `opt` per (ids, labels) of `batches` (numpy arrays):
    loss, ``backward()``, ``P.nn.utils.clip_grad_norm_`` to
    `max_grad_norm` (None: no clip), ``opt.step()``,
    ``opt.clear_grad()``, the states carried to the next batch and
    detached. `on_step(i)` runs before step i. Returns (losses as
    floats, the last states)."""
    h, c = states
    losses = []
    for i, (ids, labels) in enumerate(batches):
        if on_step is not None:
            on_step(i)
        loss, h, c = lm_loss(P, model, P.to_tensor(ids, place=place),
                             P.to_tensor(labels, place=place), h, c)
        loss.backward()
        if max_grad_norm is not None:
            P.nn.utils.clip_grad_norm_(model.parameters(), max_grad_norm)
        opt.step()
        opt.clear_grad()
        h, c = h.detach(), c.detach()
        losses.append(float(loss))
    return losses, (h, c)
