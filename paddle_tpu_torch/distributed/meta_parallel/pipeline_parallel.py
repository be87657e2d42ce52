"""The pipeline-parallel runtime: the micro-batch schedule over a
PipelineLayer (counterpart of
paddle_tpu/distributed/meta_parallel/pipeline_parallel.py).

Two paths, as in the reference. Without a ``schedule_mode`` (the legacy
loop) each micro-batch runs every stage forward and its backward at
once. With one ("1F1B", "FThenB", "Interleaved1F1B"; the last is the
default for a layer with virtual stages) `pipeline_schedules` orders the
F and B units and `ScheduleExecutor` runs them. Gradients accumulate
over the micro-batches and the optimizer steps once a ``train_batch``.
"""
from __future__ import annotations

from ...core.tensor import Tensor
from .parallel_wrappers import MetaParallelBase
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "PipelineParallel requires a PipelineLayer model")
        self.accumulate_steps = 1
        self.micro_batch_size = None
        self.schedule_mode = None   # None: the legacy micro-batch loop
        if strategy is not None:
            cfg = getattr(strategy, "pipeline_configs", {}) or {}
            self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
            self.micro_batch_size = cfg.get("micro_batch_size")
            self.schedule_mode = cfg.get("schedule_mode")
        if self.schedule_mode is None and layers.num_chunks > 1:
            self.schedule_mode = "Interleaved1F1B"
        super().__init__(layers, hcg, strategy)
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = 0
        self.total_loss = None
        self.last_schedule = None   # the last run's Unit list
        self.last_executed = None   # its (kind, part, micro) log

    def _prepare_for_model(self):
        # PipelineLayer placed every parameter on its stage already
        pass

    # ---- the schedule ----
    def _split_micro(self, data):
        """The [global_batch, ...] inputs cut into accumulate_steps
        micro-batches."""
        if isinstance(data, (tuple, list)):
            splits = [self._split_micro(d) for d in data]
            return list(zip(*splits))
        t = data if isinstance(data, Tensor) else Tensor(data)
        n = self.accumulate_steps
        b = t.shape[0]
        assert b % n == 0, (
            f"global batch {b} not divisible by accumulate_steps {n}")
        mb = b // n
        return [t[i * mb:(i + 1) * mb] for i in range(n)]

    def _scheduled_forward_backward(self, data, scaler=None,
                                    forward_only=False):
        """The explicit schedule path (1F1B, Interleaved1F1B, FThenB)."""
        from .pipeline_schedules import ScheduleExecutor, build_schedule

        micros = self._split_micro(data)
        n = len(micros)
        xs, labels = [], []
        for m in micros:
            if isinstance(m, (tuple, list)) and len(m) == 2:
                xs.append(m[0])
                labels.append(m[1])
            else:
                xs.append(m)
                labels.append(None)
        # the stage count is the layer's (its parts are what run); the
        # hybrid group's pp size only places them
        order = build_schedule(self.schedule_mode,
                               self._layers._num_stages, n,
                               self._layers.num_chunks)
        ex = ScheduleExecutor(self._layers, self._layers._loss_fn, scaler)
        total = ex.run(order, xs, labels, forward_only=forward_only)
        self.last_schedule = order
        self.last_executed = ex.executed
        self.total_loss = total
        return total

    def forward_backward_pipeline(self, data, scaler=None,
                                  forward_only=False):
        if self.schedule_mode is not None:
            return self._scheduled_forward_backward(
                data, scaler, forward_only=forward_only)
        micros = self._split_micro(data)
        n = len(micros)
        total = None
        for m in range(n):
            inp = micros[m]
            if isinstance(inp, (tuple, list)) and len(inp) == 2:
                x, label = inp
            else:
                x, label = inp, None
            out = self._layers.forward(x)
            if self._layers._loss_fn is not None and label is not None:
                loss = self._layers._loss_fn(out, label)
            else:
                loss = out
            loss = loss / n
            scaled = scaler.scale(loss) if scaler is not None else loss
            if not forward_only:
                scaled.backward()
            d = loss.detach()
            total = d if total is None else total + d
        self.total_loss = total
        return total

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        from ...autograd import no_grad
        self._layers.eval()
        with no_grad():
            return self.forward_backward_pipeline(data, forward_only=True)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
