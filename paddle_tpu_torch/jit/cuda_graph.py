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

Each owner of graphs (an LLMEngine, a generate loop, a TrainStep)
captures them into a memory pool of its own
(``torch.cuda.graph_pool_handle``): its graphs run one at a time on one
stream, and it keeps nothing a graph allocated beyond the next replay,
so one graph's scratch may reuse another's. A pool is never shared
between owners: once every graph of a pool is freed, the pool cannot
take a new capture while any block of it is still allocated, and a
library's workspace made during a capture (cuBLAS keeps one for the
capture stream) stays allocated for the life of the process. An owner
made after another was freed brings a fresh pool.

``captures``, ``capture_seconds`` and ``replays`` count by the name each
caller gives its graphs ("engine_decode", "generate_prefill",
"generate_decode", "train_step"), as the kernels count their launches.
A capture is the port's counterpart of the reference's compile: with
observability enabled each one also reports into
``observability.metrics.compile_metrics()`` under its name as the
family (outcome "compile", its wall time in the histogram), and the
family's expected cost (``expected``, a ``perf.CostModel`` counted from
the shapes) is published through ``perf.record_compile`` and kept on
the step's ``expected``, as the reference's ``CompileTimed`` shim keeps
the executable's. All of it happens after the capture has ended: a
recorder must not touch the card while a capture is under way.

Every capture holds ``capture_lock``. CUDA refuses many calls (an
allocation, an event wait) from any thread of the process while a
capture is under way, and the refusal invalidates the capture; a thread
that makes such calls beside a capturing consumer (a DataLoader's
prefetch thread issuing a batch's copy to the card) takes the lock
around them.
"""
from __future__ import annotations

import collections
import gc
import threading
import time

import torch

from ..observability import metrics as _om
from ..observability import perf as _pf

__all__ = ["CapturedStep", "GraphCache", "captures", "capture_seconds",
           "replays", "reset_counters", "capture_lock"]

capture_lock = threading.Lock()

captures: collections.Counter = collections.Counter()
capture_seconds: collections.Counter = collections.Counter()
replays: collections.Counter = collections.Counter()


def reset_counters():
    captures.clear()
    capture_seconds.clear()
    replays.clear()


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

    ``expected``: the family's ``perf.CostModel`` for one replay (the
    module docstring says where it goes).

    ``pool`` is the owner's memory pool (``torch.cuda.graph_pool_handle()``,
    made once by the owner and given to each of its graphs; the module
    docstring says why no two owners share one).

    The cyclic garbage collector is off while the graph is captured: a
    dead cycle holding an older graph, freed then, would release that
    graph's memory in the middle of the capture, which CUDA refuses
    (the capture is invalidated)."""

    def __init__(self, name: str, fn, *, pool, generators=(),
                 warmup_counts=False, expected=None):
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
            with capture_lock, torch.cuda.graph(self.graph, pool=pool):
                self.output = fn()
        finally:
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        captures[name] += 1
        capture_seconds[name] += seconds
        self.expected = _pf.record_compile(name, expected)
        if _om._ENABLED:
            c, h = _om.compile_metrics()
            c.labels(family=name, outcome="compile").inc()
            h.labels(family=name).observe(seconds)

    def replay(self):
        self.graph.replay()
        replays[self.name] += 1
        return self.output


class GraphCache:
    """One owner's graphs keyed by input signature: the last ``size``
    used are kept (the least recently used is dropped first, its memory
    left to the pool), all captured into the owner's one pool, made at
    the first capture (the module docstring says why owners do not
    share one). An entry is whatever the owner keeps beside its graph,
    typically (CapturedStep, static inputs)."""

    def __init__(self, size: int = 8):
        self.size = size
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key):
        """The entry of `key`, now the most recently used, or None."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry):
        """Keep `entry` for `key`, dropping the least recently used past
        ``size``; returns `entry`."""
        self._entries[key] = entry
        if len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return entry

    def values(self):
        """The entries, least recently used first."""
        return self._entries.values()

    def __len__(self):
        return len(self._entries)
