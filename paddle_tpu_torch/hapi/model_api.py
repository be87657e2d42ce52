"""High-level Model API (counterpart of paddle_tpu/hapi/model_api.py;
ref: python/paddle/hapi/model.py:1054 — fit:1676, callbacks.py).

``Model`` trains, evaluates and predicts eagerly over a network (a
``Layer``, or any ``torch.nn.Module`` whose forward takes the batch's
Tensors): ``train_batch`` is ``loss.backward()``, ``optimizer.step()``,
``clear_grad()`` and one host read of the loss, as the reference's.
Batches from a ``DataLoader`` come as Tensors on its place. Under an
``amp.auto_cast`` around ``fit`` the forward runs in that precision, as
an eager loop's does. ``summary`` counts parameters and, given an input
size, the forward's FLOPs (``utils.flops``' formulas)."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..autograd import no_grad
from ..nn.layer import Layer, _named_parameters

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRSchedulerCallback", "Model", "summary"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"epoch {epoch} done in {time.time() - self.t0:.1f}s")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped = False
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        better = (self.best is None or
                  (cur < self.best - self.min_delta if self.mode == "min"
                   else cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
                self.model.stop_training = True


class LRSchedulerCallback(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler
        opt = self.model._optimizer
        if opt is not None and isinstance(opt._lr, LRScheduler):
            return opt._lr
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class Model:
    """Keras-like train/eval facade over a Layer (ref: hapi/model.py)."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics or []
        if self._metrics and not isinstance(self._metrics, (list, tuple)):
            self._metrics = [self._metrics]
        return self

    def _compute_loss(self, outputs, labels):
        if callable(self._loss):
            return self._loss(outputs, labels)
        raise RuntimeError("call prepare(loss=...) first")

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = [float(loss.item())]
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
        return metrics if len(metrics) > 1 else metrics[0]

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        for m in self._metrics:
            m.update(m.compute(outputs, labels))
        return float(loss.item())

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self.network(*inputs)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader, Dataset
        if isinstance(train_data, Dataset):
            train_data = DataLoader(train_data, batch_size=batch_size,
                                    shuffle=shuffle, drop_last=drop_last)
        if isinstance(eval_data, Dataset):
            eval_data = DataLoader(eval_data, batch_size=batch_size)
        cbs = [ProgBarLogger(log_freq, verbose), LRSchedulerCallback()]
        cbs += list(callbacks or [])
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        for cb in cbs:
            cb.set_model(self)
        logs = {}
        for cb in cbs:
            cb.on_train_begin(logs)
        it = 0
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            for cb in cbs:
                cb.on_epoch_begin(epoch, logs)
            for step, batch in enumerate(train_data):
                *inputs, label = batch if isinstance(batch, (list, tuple)) \
                    else (batch,)
                loss = self.train_batch(inputs, label)
                logs = {"loss": loss}
                for m in self._metrics:
                    res = m.accumulate()
                    names = m.name()
                    if isinstance(names, str):
                        logs[names] = res
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, callbacks=cbs)
                for cb in cbs:
                    cb.on_eval_end(eval_logs)
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        from ..io import DataLoader, Dataset
        if isinstance(eval_data, Dataset):
            eval_data = DataLoader(eval_data, batch_size=batch_size)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(eval_data):
            *inputs, label = batch if isinstance(batch, (list, tuple)) \
                else (batch,)
            losses.append(self.eval_batch(inputs, label))
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            names = m.name()
            if isinstance(names, str):
                logs[names] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset
        if isinstance(test_data, Dataset):
            test_data = DataLoader(test_data, batch_size=batch_size)
        outs = []
        for batch in test_data:
            inputs = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(inputs))
        return outs

    def save(self, path, training=True):
        from ..framework_io import save
        net = self.network
        save(net.state_dict() if isinstance(net, Layer)
             else torch.nn.Module.state_dict(net), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load
        sd = load(path + ".pdparams")
        if isinstance(self.network, Layer):
            self.network.set_state_dict(sd)
        else:
            torch.nn.Module.load_state_dict(
                self.network, {k: v._data for k, v in sd.items()})
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)


def summary(net, input_size=None, dtypes=None, input=None):
    """(ref: python/paddle/hapi/model_summary.py; total FLOPs row via
    utils.flops' formulas when input_size or input is given, the
    dynamic_flops wiring). The forward runs on `input` (a Tensor or a
    list of them) if given, else on zeros of `input_size` in `dtypes`
    (a dtype name, default float32; the reference takes `dtypes` and
    `input` and reads neither, so its FLOPs row needs a float input)."""
    lines = []
    total_params = 0
    trainable = 0
    for name, p in _named_parameters(net, ""):
        n = p.size
        total_params += n
        if not p.stop_gradient:
            trainable += n
        lines.append(f"{name:<60} {str(tuple(p.shape)):<20} {n:>12,}")
    header = f"{'Layer (param)':<60} {'Shape':<20} {'Param #':>12}"
    sep = "-" * 94
    tail = [
        sep,
        f"Total params: {total_params:,}",
        f"Trainable params: {trainable:,}",
        f"Non-trainable params: {total_params - trainable:,}",
    ]
    total_flops = None
    if input_size is not None or input is not None:
        from ..ops import zeros
        from ..utils import _count_flops
        try:
            inputs = input if isinstance(input, (list, tuple)) else \
                [input] if input is not None else \
                [zeros(input_size, dtype=dtypes or "float32")]
            total_flops = _count_flops(net, inputs)
            tail.append(f"Total FLOPs (fwd): {total_flops:,}")
        except Exception:
            pass
    tail.append(sep)
    out = "\n".join([sep, header, sep] + lines + tail)
    print(out)
    res = {"total_params": total_params, "trainable_params": trainable}
    if total_flops is not None:
        res["total_flops"] = total_flops
    return res
