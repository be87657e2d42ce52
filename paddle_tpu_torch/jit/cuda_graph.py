"""CUDA graphs of the port's decode steps (the counterpart of the
reference's jitted, donated-buffer executables and of the
``observability/perf.py::CompileTimed`` wrapper that counts their
compiles).

A captured graph replays the kernels one call of a step function
launched, on the same device addresses. So the function reads and
writes only static tensors (inputs copied in before a replay, outputs
read after it) and takes nothing from the host: no ``.item()``, no copy
from host memory, no shape that depends on data. A capture that meets
such an operation raises; nothing falls back to an eager run.

The decode graphs are captured into one memory pool shared by all of
them (``torch.cuda.graph_pool_handle``), a TrainStep's graphs into a
pool of its own: they run one at a time on one stream, and their
callers keep nothing a graph allocated beyond the next replay, so one
graph's scratch may reuse another's.

``captures``, ``capture_seconds`` and ``replays`` count by the name each
caller gives its graphs ("engine_decode", "generate_prefill",
"generate_decode", "train_step"), as the kernels count their launches.
"""
from __future__ import annotations

import collections
import gc
import time

import torch

__all__ = ["CapturedStep", "captures", "capture_seconds", "replays",
           "reset_counters"]

captures: collections.Counter = collections.Counter()
capture_seconds: collections.Counter = collections.Counter()
replays: collections.Counter = collections.Counter()
_pool = None


def reset_counters():
    captures.clear()
    capture_seconds.clear()
    replays.clear()


def _graph_pool():
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    return _pool


class CapturedStep:
    """``fn()`` captured once as a CUDA graph; ``replay()`` runs it again
    and returns what the captured call returned (static tensors of the
    pool, valid until the next replay of any graph).

    The capture first runs ``fn`` once eagerly on a side stream, which
    loads its kernels and sets up the libraries' workspaces, as PyTorch
    requires before a capture. That call changes whatever ``fn`` writes:
    the caller copies its inputs in again before the first replay. The
    states of the ``generators`` fn draws from are put back after it and
    registered with the graph, so each replay advances them as an eager
    call would. With ``warmup_counts`` the warm-up is the caller's first
    real call instead (``warmup_output`` holds what it returned), and
    nothing is put back. The default CUDA generator needs no entry in
    ``generators``: PyTorch registers it with every graph.

    ``pool`` gives the graph an owner's own memory pool in place of the
    shared one: a pool whose graphs have all been freed cannot take a
    new capture while any block of it is still allocated (a library's
    workspace made during a capture stays), so an owner that is freed
    and made again (a TrainStep) brings a pool of its own.

    The cyclic garbage collector is off while the graph is captured: a
    dead cycle holding an older graph, freed then, would release that
    graph's memory in the middle of the capture, which CUDA refuses
    (the capture is invalidated)."""

    def __init__(self, name: str, fn, generators=(), warmup_counts=False,
                 pool=None):
        t0 = time.perf_counter()
        self.name = name
        states = [g.get_state() for g in generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_output = out if warmup_counts else None
        if not warmup_counts:
            for g, s in zip(generators, states):
                g.set_state(s)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool or _graph_pool()):
                self.output = fn()
        finally:
            if collecting:
                gc.enable()
        captures[name] += 1
        capture_seconds[name] += time.perf_counter() - t0

    def replay(self):
        self.graph.replay()
        replays[self.name] += 1
        return self.output
