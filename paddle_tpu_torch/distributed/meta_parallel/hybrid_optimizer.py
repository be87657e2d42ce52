"""HybridParallelOptimizer and HybridParallelGradScaler (counterpart of
paddle_tpu/distributed/meta_parallel/hybrid_optimizer.py).

The reference keeps ZeRO as placement: with a sharding degree above 1
its optimizer commits the accumulators split over the "sharding" axis
(stage 1), commits each gradient split as the tape produces it (stage
2, a hook per parameter) and stores the parameters split (stage 3),
then re-commits each parameter to its own placement after the update
(the all-gather leg). The port records the same specs (`_fsdp_spec`):
the accumulators' in `state_shardings` ({id(param): {name:
NamedSharding}}), the gradients' in `grad_shardings` (by the stage-2
hooks, through ``Tensor.register_hook``), the parameters' on the
parameters; and it notes the reshards as the reference does. Nothing
moves: the update is the inner optimizer's, on the whole arrays (on
the card, the multi-tensor update kernel).
"""
from __future__ import annotations

from ...nn.layer import Parameter
from ...observability import comms as _comms
from ...observability import metrics as _om
from ..topology import NamedSharding
from ..topology import PartitionSpec as P
from ..topology import place, placement

__all__ = ["HybridParallelOptimizer", "HybridParallelGradScaler"]


def _fsdp_spec(shape, axis: str, mesh) -> P:
    """Split the largest axis divisible by the axis size; else
    replicate."""
    if not shape:
        return P()
    size = mesh.shape[axis]
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for d in dims:
        if shape[d] % size == 0 and shape[d] >= size:
            spec = [None] * len(shape)
            spec[d] = axis
            return P(*spec)
    return P()


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


class HybridParallelOptimizer:
    """sharding_configs["stage"] selects the ZeRO level (the reference's
    group_sharded_stage2.py / group_sharded_stage3.py):
      1: the optimizer states split over the sharding axis
      2: + the gradients reduce-scattered onto it as they are produced
      3: + the parameters themselves stored split
    (module docstring: recorded, not moved)."""

    def __init__(self, optimizer, hcg, strategy=None, stage=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._shard_states = hcg.get_sharding_parallel_world_size() > 1
        self._sharding_axis = "sharding"
        if stage is None:
            cfg = getattr(strategy, "sharding_configs", None) or {}
            stage = int(cfg.get("stage", 1))
        if stage not in (1, 2, 3):
            raise ValueError(f"sharding stage must be 1, 2 or 3: {stage}")
        self.sharding_stage = stage
        self.state_shardings = {}
        self.grad_shardings = {}
        if self._shard_states and stage >= 2:
            self._install_grad_shard_hooks()
        if self._shard_states and stage == 3:
            self._commit_params_sharded()

    def _param_mesh(self, p):
        pl = placement(p)
        return pl.mesh if pl is not None else self._hcg.mesh

    def _commit_params_sharded(self):
        """Stage 3: the parameter's placement is the split itself."""
        for p in self._inner_opt._all_params():
            mesh = self._param_mesh(p)
            if self._sharding_axis not in mesh.shape:
                continue
            place(p, mesh, _fsdp_spec(tuple(p.shape), self._sharding_axis,
                                      mesh))

    def _install_grad_shard_hooks(self):
        """Stage >= 2: the reduce-scatter at gradient production, a hook
        on each parameter (the reference's bucketed reduce-scatter during
        the backward)."""
        for p in self._inner_opt._all_params():
            if not p.requires_grad:
                continue
            mesh = self._param_mesh(p)
            if self._sharding_axis not in mesh.shape:
                continue
            sh = NamedSharding(mesh, _fsdp_spec(
                tuple(p.shape), self._sharding_axis, mesh))

            def _shard_grad(g, _sh=sh, _key=id(p)):
                if _om._ENABLED:
                    _comms.note_reshard("reduce_scatter",
                                        self._sharding_axis,
                                        _nbytes(g._data))
                self.grad_shardings[_key] = _sh
                return None

            Parameter._of(p).register_hook(_shard_grad)

    def _commit_grads_sharded(self):
        """The same record for gradients that arrived outside the
        backward (assigned by hand)."""
        for p in self._inner_opt._all_params():
            g = p.grad
            if g is None:
                continue
            mesh = self._param_mesh(p)
            if self._sharding_axis not in mesh.shape:
                continue
            self.grad_shardings[id(p)] = NamedSharding(mesh, _fsdp_spec(
                tuple(g.shape), self._sharding_axis, mesh))

    # ---- delegation ----
    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _commit_states(self):
        # each parameter's accumulators live on the parameter's own mesh
        # (a pipeline stage's sub-mesh with pp > 1)
        for p in self._inner_opt._all_params():
            st = self._inner_opt._accumulators.get(id(p))
            if not st:
                continue
            mesh = self._param_mesh(p)
            if self._sharding_axis not in mesh.shape:
                continue
            specs = self.state_shardings.setdefault(id(p), {})
            for k, v in st.items():
                if getattr(v, "ndim", 0) == 0:
                    continue
                specs[k] = NamedSharding(mesh, _fsdp_spec(
                    tuple(v.shape), self._sharding_axis, mesh))

    def step(self):
        # materialise the accumulators, then record their split (stage 1)
        if self._shard_states:
            if self.sharding_stage >= 2:
                self._commit_grads_sharded()
            for p in self._inner_opt._all_params():
                if p.requires_grad and p.grad is not None:
                    self._inner_opt._get_state(p)
            self._commit_states()
        self._inner_opt.step()
        if _om._ENABLED and self._shard_states:
            # the gather leg of the shard-update-gather cycle
            for p in self._inner_opt._all_params():
                if placement(p) is not None:
                    _comms.note_reshard("all_gather", self._sharding_axis,
                                        _nbytes(p))

    def clear_grad(self, *a, **kw):
        return self._inner_opt.clear_grad(*a, **kw)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None


class HybridParallelGradScaler:
    """The reference's hybrid_parallel_gradscaler.py: wraps the AMP
    GradScaler (one device holds every gradient, so its found-inf check
    is already global)."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self._scaler, item)
