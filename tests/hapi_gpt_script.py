"""The nn.Layer GPT of tests/eager_gpt_layer_script.py trained through
``hapi.Model``, written once against the public API both packages share:
`P` is ``paddle_tpu`` or ``paddle_tpu_torch`` and `S` the layer script
module. It imports neither package, so the card's machine (which has no
JAX) runs it from chip_smoke.py as the CPU tests run it on both
packages.

``hapi_fit`` builds the GPT from `weights`, then
``Model(net).prepare(AdamW(parameters=net.parameters()), loss,
metric.Accuracy())`` and ``fit`` over a ``DataLoader`` of an
``io.Dataset`` holding the batches' rows, in order, one batch a step.
The loss is ``layer_gpt_loss``'s (``cross_entropy(reduction="none")
.mean()``), so a step runs the ops of ``S.train_steps`` in the same
order; under ``amp`` the whole ``fit`` runs inside the same bf16 O1
``auto_cast``."""
import numpy as np


def rows_dataset(P, batches):
    """An ``io.Dataset`` whose item i is row i of the batches' (ids,
    labels), int32."""
    ids = np.concatenate([np.asarray(b[0], np.int32) for b in batches])
    labels = np.concatenate([np.asarray(b[1], np.int32) for b in batches])

    class Rows(P.io.Dataset):
        def __getitem__(self, i):
            return ids[i], labels[i]

        def __len__(self):
            return len(ids)

    return Rows()


def batch_loader(P, batches):
    """The batches again, from a DataLoader over their rows."""
    return P.io.DataLoader(rows_dataset(P, batches),
                           batch_size=len(batches[0][0]), shuffle=False)


def gpt_loss(P):
    def loss(logits, labels):
        return P.nn.functional.cross_entropy(logits, labels,
                                             reduction="none").mean()
    return loss


def prepared(P, S, weights, num_layers, num_heads, lr=1e-3,
             weight_decay=0.01, names=None):
    """``Model`` over the Layer GPT built from `weights`, prepared with
    AdamW, ``gpt_loss`` and ``Accuracy``. `names`, if given, are the
    parameters' names (in ``parameters()`` order), set before the
    optimizer is made."""
    net = S.gpt_from_weights(P, weights, num_layers, num_heads)
    for p, n in zip(net.parameters(), names or ()):
        p.name = n
    model = P.Model(net)
    opt = P.optimizer.AdamW(learning_rate=lr, parameters=net.parameters(),
                            weight_decay=weight_decay)
    model.prepare(opt, gpt_loss(P), P.metric.Accuracy())
    return model


def step_recorder(P):
    """A callback that keeps every train batch's logs."""
    class Recorder(P.callbacks.Callback):
        def __init__(self):
            self.logs = []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs or {}))

    return Recorder()


def hapi_fit(P, S, weights, batches, num_layers, num_heads, lr=1e-3,
             weight_decay=0.01, amp=False, callbacks=(), eval_batches=None,
             on_step=None):
    """``fit`` for one epoch over `batches` (numpy int arrays); the
    losses and accuracies a step as ``fit`` logged them, and the Model.
    `on_step(i)` runs before ``fit`` (i = 0) and after step i - 1 (a
    callback's ``on_train_batch_end``: ``fit`` calls no
    ``on_train_batch_begin`` in either package)."""
    model = prepared(P, S, weights, num_layers, num_heads, lr, weight_decay)
    rec = step_recorder(P)
    extra = list(callbacks)
    if on_step is not None:
        class Marks(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                on_step(step + 1)
        extra.append(Marks())
        on_step(0)
    evals = None if eval_batches is None else batch_loader(P, eval_batches)
    with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        model.fit(batch_loader(P, batches), eval_data=evals, epochs=1,
                  verbose=0, callbacks=[rec] + extra)
    return ([r["loss"] for r in rec.logs], [r["acc"] for r in rec.logs],
            model)


def round_trip(P, S, model, path, batch, weights, num_layers, num_heads,
               lr=1e-3, weight_decay=0.01, amp=False):
    """``Model.save(path)`` (.pdparams and .pdopt), a fresh Model (over a
    GPT built from `weights`, with a fresh AdamW) ``load``s it, then one
    ``train_batch`` on each from `batch`. Returns (the fresh Model, its
    loss, the original's). The optimizer's state is keyed by parameter
    name, so the fresh GPT's parameters take the original's names, as
    the same script run again in a new process gives them."""
    model.save(path)
    fresh = prepared(P, S, weights, num_layers, num_heads, lr, weight_decay,
                     names=[p.name for p in model.network.parameters()])
    fresh.load(path)
    losses = []
    for m in (fresh, model):
        ids, labels = (P.to_tensor(np.asarray(a, np.int32)) for a in batch)
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            losses.append(m.train_batch([ids], labels))
    return fresh, losses[0], losses[1]
