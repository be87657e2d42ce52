"""Activation recompute (counterpart of
paddle_tpu/distributed/meta_parallel/recompute.py).

A recomputed block keeps only its inputs across the forward (or, under a
save policy, also the outputs of its matrix products) and runs its
forward again inside the backward. paddle_tpu renders this with
``jax.checkpoint``; the port with PyTorch's non-reentrant checkpoint
(``torch.utils.checkpoint.checkpoint(use_reentrant=False)``).

The recomputation runs later, during the backward (on CUDA from
autograd's own thread), so what the forward ran under is put back around
it:

* the port's AMP state (``amp.amp_state()``: enabled, level, dtype, the
  custom lists). It is per thread and read by the port's own ops, not
  ``torch.autocast``, so torch's checkpoint does not carry it; the
  reference traces the block under the state of its forward.
* with ``preserve_rng_state``, the state of every ``torch.Generator``
  that the block's modules carry (their ``generator`` attributes, where
  GPT keeps its dropout generator) and of torch's default generators
  (the CPU's, and those of the CUDA devices the tensor arguments lie
  on): taken before the forward, set before the recomputation, so that
  it draws the forward's dropout masks, and put back after it, so that
  later draws are those of a run without recompute. torch's own
  ``preserve_rng_state`` knows only the default generators and is off.
  Under a CUDA-graph capture (TrainStep's graph) the same calls serve:
  on torch 2.11+cu128 ``get_state()``/``set_state()`` of a generator
  registered with the graph rewind its draws inside the capture, and
  each replay draws new masks, the same in the forward and in the
  recomputation; ``graphsafe_get_state()`` returns the live state, so
  setting it back rewinds nothing, and ``clone_state()`` raises during
  a capture (tests/test_torch_recompute_cuda.py checks all three on the
  card). Without ``preserve_rng_state`` nothing is stashed and the
  recomputation draws new masks, as the reference's ``PRNGKey(0)``
  branch does not carry the caller's key.

The recomputation runs inside a profiler range "recompute", so a
torch.profiler trace of a step can tell it from the rest of the backward
(tools/torch_train_profile.py).

Kernels launched through ctypes (flash attention's B1 inside
``_FlashCore``) are no operator the dispatcher sees, so no policy saves
their outputs: B1 runs again in every recomputation, as ``jax.checkpoint``
re-runs a ``pallas_call``, which is no ``dot_general``.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp.state import amp_state

__all__ = ["recompute", "recompute_sequential"]

#: Named save policies (the reference's ``_POLICIES``, there rendered as
#: ``jax.checkpoint`` policies): the aten products whose outputs are kept
#: across the forward. "full" keeps none, only the block's inputs;
#: "dots" keeps every matrix product (jax's ``dots_saveable``);
#: "dots_no_batch" keeps the plain ones and recomputes the batched
#: (``dots_with_no_batch_dims_saveable``).
_POLICIES = {
    "full": (),
    "dots": ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _saving(names):
    """A selective-checkpoint policy that saves the outputs of the aten
    operators `names` (every overload) and recomputes the rest."""
    packets = {getattr(torch.ops.aten, n) for n in names
               if hasattr(torch.ops.aten, n)}

    def policy(ctx, op, *args, **kwargs):
        if getattr(op, "overloadpacket", None) in packets:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _resolve_policy(policy):
    """None (save only the inputs) or a selective-checkpoint policy."""
    if policy is None or callable(policy):
        return policy
    names = _POLICIES.get(policy) if isinstance(policy, str) else None
    if names is None:
        raise ValueError(
            f"unknown recompute policy {policy!r}; expected one of "
            f"{sorted(_POLICIES)} or a torch selective-checkpoint policy "
            f"callable")
    return _saving(names) if names else None


def _generators(function, args):
    """The generators a recomputation must draw from as its forward did:
    those of the block's modules, torch's CPU default, and the CUDA
    default of each device a tensor argument (or an eager Tensor's)
    lies on."""
    owner = function if isinstance(function, nn.Module) \
        else getattr(function, "__self__", None)
    gens = {}
    if isinstance(owner, nn.Module):
        for m in owner.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator):
                gens[id(g)] = g
    gens[id(torch.default_generator)] = torch.default_generator
    for a in args:
        a = getattr(a, "_data", a)      # an eager Tensor's torch tensor
        if isinstance(a, torch.Tensor) and a.is_cuda:
            g = torch.cuda.default_generators[a.device.index]
            gens[id(g)] = g
    return list(gens.values())


class _AsInForward:
    """The recomputation's context: the forward's AMP state and generator
    states while it runs (inside `inner`, the selective checkpoint's
    recompute mode or nothing, and the profiler range), this thread's
    own back after it."""

    def __init__(self, amp_snap, gens, states, inner):
        self.amp_snap, self.gens, self.states = amp_snap, gens, states
        self.inner = inner

    def __enter__(self):
        st = amp_state()
        self._prev = (st.snapshot(), [g.get_state() for g in self.gens])
        st.restore(self.amp_snap)
        for g, s in zip(self.gens, self.states):
            g.set_state(s)
        self._range = record_function("recompute")
        self._range.__enter__()
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)
            amp_snap, states = self._prev
            for g, s in zip(self.gens, states):
                g.set_state(s)
            amp_state().restore(amp_snap)


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, **kwargs):
    """paddle_tpu's ``recompute(function, *args)``: run `function` (an
    ``nn.Module`` or a function of tensors) so that the backward
    recomputes its forward instead of keeping its activations.

    Always PyTorch's non-reentrant checkpoint: the reentrant form does
    not support ``torch.autograd.grad``, which TrainStep takes gradients
    with. `use_reentrant` is accepted for the signature and ignored, as
    the reference ignores it. `policy` selects what is kept across the
    forward: None or "full" only the inputs, "dots" / "dots_no_batch"
    the outputs of matrix products as well (see ``_POLICIES``), or a
    PyTorch selective-checkpoint policy function in place of the
    reference's jax policy callable. Without gradients (eval,
    ``torch.no_grad``) the call is a plain call."""
    sac = _resolve_policy(policy)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    gens = _generators(function, args) if preserve_rng_state else []
    states = [g.get_state() for g in gens]
    if sac is None:
        fwd, inner = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        fwd, inner = create_selective_checkpoint_contexts(sac)
    again = _AsInForward(amp_state().snapshot(), gens, states, inner)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (fwd, again), **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """paddle_tpu's ``recompute_sequential``: cut `functions` (a sequence
    of modules, or a module's children) into ``ctx["segments"]`` chunks
    of ``len // segments`` modules and recompute each chunk; `kwargs`
    go to ``recompute``."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    mods = list(functions) if isinstance(functions, (list, tuple)) \
        else list(functions.children())
    per = max(1, len(mods) // segments)
    x = args[0] if len(args) == 1 else args
    for i in range(0, len(mods), per):
        x = recompute(nn.Sequential(*mods[i:i + per]), x, **kwargs)
    return x
