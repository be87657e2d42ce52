"""The parallel environment and DataParallel (counterpart of
paddle_tpu/distributed/parallel.py).

``init_parallel_env`` reads the launcher's environment
(``PADDLE_TRAINERS_NUM`` > 1, ``PADDLE_MASTER``, ``PADDLE_TRAINER_ID``;
the reference's :28-61) and, in a job of several processes, makes the
``torch.distributed`` default process group (NCCL for CUDA tensors,
gloo for CPU ones, at ``tcp://PADDLE_MASTER``) where the reference calls
``jax.distributed.initialize``; then it returns the world group. The
collectives then work on each process's local tensors
(communication.py's process-group mode).

Without a process group the collectives are eager rank-major, and the
world has one rank a device, as the reference's single controller has:
``torch.cuda.device_count()`` cards when the default place is the card;
on the CPU the host-platform device count JAX gives the reference in the
same environment, ``--xla_force_host_platform_device_count`` of
``XLA_FLAGS`` (8 under the tests' conftest), else 1. That rule reads an
existing variable and adds none (a departure: the port never runs JAX).

``DataParallel.apply_collective_grads`` is a no-op in the reference,
because GSPMD already averages the gradients of a sharded batch. In the
port's process-group mode nothing does: there it averages every
gradient over the group (one all-reduce of their flat concatenation per
dtype and device), or each process would train on its own shard alone.
At one rank, and in rank-major mode, it stays a no-op.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..nn.layer import Layer
from .communication import Group, all_reduce, init_default_group

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel", "spawn", "process_count"]


def _env_world() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def _env_rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def _pg_active() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _maybe_init_process_group() -> bool:
    """Make torch.distributed's default group from the launcher's
    environment when it names more than one process; idempotent. False
    for a job of one process."""
    if _pg_active():
        return True
    world = _env_world()
    master = os.environ.get("PADDLE_MASTER")
    if world <= 1 or not master:
        return False
    import torch.distributed as dist
    rank = _env_rank()
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{master}",
                            world_size=world, rank=rank)
    return True


def _host_platform_devices() -> int:
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def _rank_major_world() -> int:
    """Ranks of the rank-major world: the module docstring's rule."""
    from ..core import device as _device
    place = _device._current_place
    on_card = place.device_type != "cpu" if place is not None \
        else torch.cuda.is_available()
    return torch.cuda.device_count() if on_card \
        else _host_platform_devices()


def process_count() -> int:
    """Processes in this job: the process group's size, else the
    launcher's ``PADDLE_TRAINERS_NUM``, else 1 (the reference's
    ``jax.process_count()``)."""
    if _pg_active():
        import torch.distributed as dist
        return dist.get_world_size()
    return max(_env_world(), 1)


class ParallelEnv:
    """The reference's parallel.py ParallelEnv."""

    def __init__(self):
        init_parallel_env()

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if _pg_active() \
            and torch.cuda.is_available() else 0

    @property
    def dev_id(self):
        return self.device_id

    local_rank = rank
    nranks = world_size


def init_parallel_env() -> Group:
    """Make the process group a launcher's environment asks for (module
    docstring) and return the world group."""
    _maybe_init_process_group()
    return init_default_group()


def get_rank(group=None) -> int:
    """This process's rank: the process group's, else the launcher's
    ``PADDLE_TRAINER_ID`` in a job of several processes, else 0 (one
    process drives every rank)."""
    if _pg_active():
        import torch.distributed as dist
        return dist.get_rank()
    if _env_world() > 1:
        return _env_rank()
    return 0


def get_world_size(group=None) -> int:
    """`group`'s size; without one, the processes of a process group (or
    of the launcher's environment), else the rank-major world (module
    docstring)."""
    if group is not None:
        return group.nranks
    if _pg_active():
        import torch.distributed as dist
        return dist.get_world_size()
    if _env_world() > 1:
        return _env_world()
    return _rank_major_world()


class DataParallel(Layer):
    """Wraps a layer (the reference's :202). After ``loss.backward()``
    call ``apply_collective_grads()`` to average the gradients over the
    group (module docstring)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group: Optional[Group] = None):
        super().__init__()
        self._layers = layers
        self.group = group or init_default_group()
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # paddle exposes the inner layer's API on the wrapper
    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)

    def parameters(self, *a, **kw):
        return self._layers.parameters(*a, **kw)

    def named_parameters(self, *a, **kw):
        return self._layers.named_parameters(*a, **kw)

    def apply_collective_grads(self):
        """Average every gradient over the group in process-group mode
        with more than one rank; a no-op otherwise (module docstring)."""
        if self.group._torch_group is None or self.group.nranks == 1:
            return None
        buckets = {}
        for p in torch.nn.Module.parameters(self._layers):
            if p.grad is not None:
                buckets.setdefault((p.grad.dtype, p.grad.device),
                                   []).append(p.grad)
        for grads in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce(flat, group=self.group)
            flat.div_(self.group.nranks)
            at = 0
            for g in grads:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
        return None

    def scale_loss(self, loss):
        return loss

    @property
    def _layers_attr(self):
        return self._layers


def spawn(func, args=(), nprocs=-1, **options):
    """Runs `func(*args)` once in this process, as the reference's does
    (one controller drives every rank); a multi-process job is started
    by its launcher, which sets the environment init_parallel_env
    reads."""
    return func(*args)
