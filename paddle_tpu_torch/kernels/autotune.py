"""The block-config cache of the Hopper kernels (counterpart of
paddle_tpu/kernels/pallas/autotune.py:47-267; the port has no
``kernels/pallas`` package, so the module lives here).

The reference times a small set of {block_q, block_k} pairs at the first
call of a (kernel, shape class, device kind) and keeps the winner in
memory and on disk. On Hopper the tile widths and ring depths are
compile-time constants of the CUDA sources (``FA90_*`` in
``csrc/flash_fwd_sm90.cu``, ``FB90_*`` in ``flash_bwd_sm90.cu``,
``RPA90_*`` in ``ragged_paged_attention_sm90.cu``), so a candidate is a
**build variant**: a tuple of ``-D`` values, built once into ``build/``
(or taken from a library store handed to the kernel's loader) and
loaded beside the default build. `BuildVariants` is one source's table
of them; its `select` is the reference's use-site logic
(``_autotuned_blocks``, flash_attention.py:208-262).

The contract is the reference's:

  - the hand-set defaults are the first candidate, always, so a tuned
    config can only tie or beat them (up to noise); candidates that
    collapse to one build are timed once (`dedup_candidates`);
  - candidates are timed round-robin over two rounds with a min-reduce,
    each time with CUDA events after a warm-up call (`_time_call`);
  - the winner is kept in memory and in ``$PADDLE_TPU_CACHE_DIR``
    (default ``~/.cache/paddle_tpu``) with a locked read-merge-write,
    so a later process pays one dict lookup and no timing;
  - ``PADDLE_TPU_PALLAS_AUTOTUNE=0`` restores the defaults even when a
    winner is cached (`incubate.autotune.set_config` sets it);
  - a reentrant call returns the first candidate; a candidate that fails
    to build or launch scores inf; if all fail, or the bandwidth probes
    (`measure_effective_bw`, before and after the rounds) fall outside
    ``observability.perf.VALIDATED_BW_WINDOW``, the defaults are used
    and nothing is persisted; every sweep is logged (`drain_sweeps`);
  - a multi-process job (`distributed.parallel.process_count() > 1`,
    the reference's ``process_count() > 1``) uses the defaults unless a
    winner is already on disk.

Departures: inside a CUDA-graph capture `tune` and `select` never time
or build (the cached winner whose library is loaded, else the defaults),
so the first call of a shape class must come outside a capture, as the
eager warm-up step of every graph owner is; candidates are timed on the
call's own operands (the kernels are pure: they write only their
outputs, which the real launch then writes again), where the reference
draws fresh arrays to stay tracer-safe; the cache file is
``kernel_tune_<device kind>.json`` and the device kind is
``torch.cuda.get_device_name`` with spaces replaced. CPU tensors take
the plain versions and tune nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["enabled", "lookup", "dedup_candidates", "measure_effective_bw",
           "drain_sweeps", "tune", "clear", "time_launch", "BuildVariants"]

_MEM: dict = {}
_LOCK = threading.Lock()
_LOADED_FILES: set = set()
_TUNING = threading.local()     # reentrancy guard
_SWEEPS: list = []              # sweep records since the last drain
_VARIANT_TABLES: list = []      # every BuildVariants, cleared by clear()


def enabled() -> bool:
    return os.environ.get("PADDLE_TPU_PALLAS_AUTOTUNE", "1") != "0"


def _device_kind() -> str:
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(
        torch.cuda.current_device()).replace(" ", "_")


def _cache_path(kind: str) -> str:
    d = os.path.expanduser(os.environ.get("PADDLE_TPU_CACHE_DIR",
                                          "~/.cache/paddle_tpu"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"kernel_tune_{kind}.json")


def _load_disk(dev: str) -> None:
    path = _cache_path(dev)
    if path in _LOADED_FILES:
        return
    _LOADED_FILES.add(path)
    try:
        with open(path) as f:
            for k, v in json.load(f).items():
                _MEM.setdefault(k, tuple(v))
    except (OSError, json.JSONDecodeError):
        pass


def _save_disk(dev: str) -> None:
    path = _cache_path(dev)
    try:
        import fcntl
        # a cross-process exclusive section around the read-merge-write,
        # so two jobs tuning at once keep each other's entries
        with open(path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            on_disk = {}
            try:
                with open(path) as f:
                    on_disk = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
            on_disk.update({k: list(v) for k, v in _MEM.items()})
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(on_disk, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
    except OSError:
        pass


def _key(key_parts, dev) -> str:
    return "|".join(str(p) for p in key_parts) + "|" + dev


def lookup(key_parts) -> tuple | None:
    dev = _device_kind()
    with _LOCK:
        _load_disk(dev)
        hit = _MEM.get(_key(key_parts, dev))
    return tuple(hit) if hit else None


def dedup_candidates(cands, normalize, keep_original=False):
    """Candidates that `normalize(*c)` maps to one effective config are
    measured once: the effective configs in first-seen order, or with
    keep_original=True the first raw candidate of each class."""
    seen, keep = set(), []
    for c in cands:
        e = normalize(*c)
        if e not in seen:
            seen.add(e)
            keep.append(tuple(c) if keep_original else tuple(e))
    return keep


def _capturing() -> bool:
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def measure_effective_bw(nbytes=1 << 26, iters=4):
    """The card's effective bandwidth (bytes/s) right now: `iters`
    passes of ``a + 1.0`` over `nbytes` of f32 on the current CUDA
    device into one preallocated output (read and write: 2 × nbytes a
    pass), timed with CUDA events. Two warm-up passes are queued first
    and left running while the timed ones are queued, so the host's
    launch time does not enter (a pass is ~50 µs on an H100). None
    without a card, or when a pass fails (the caller cannot validate
    then)."""
    import torch
    if not torch.cuda.is_available() or _capturing():
        return None
    try:
        x = torch.zeros(nbytes // 4, dtype=torch.float32, device="cuda")
        y = torch.empty_like(x)
        for _ in range(2):
            torch.add(x, 1.0, out=y)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            torch.add(x, 1.0, out=y)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        del x, y
        return (2.0 * nbytes) / dt if dt > 0 else None
    except RuntimeError:
        return None


def drain_sweeps() -> list:
    """Return and clear the sweep records since the last drain."""
    out = list(_SWEEPS)
    _SWEEPS.clear()
    return out


def tune(key_parts, candidates, run_candidate, rounds=2, bw_window=None):
    """Time `candidates` with run_candidate(c) -> seconds; keep and
    persist the fastest and return it. A reentrant call, or one inside a
    CUDA-graph capture, times nothing: the cached winner, else the first
    candidate.

    bw_window=(lo, hi) bytes/s: unless the bandwidth probes before and
    after the rounds both land inside it, the sweep is discarded (the
    first candidate returned, nothing persisted). Every sweep is logged
    for `drain_sweeps`."""
    if getattr(_TUNING, "active", False):
        return tuple(candidates[0])
    hit = lookup(key_parts)
    if hit is not None:
        return hit
    if _capturing():
        return tuple(candidates[0])
    dev = _device_kind()
    key = _key(key_parts, dev)
    probes = []
    window_ok = True
    if bw_window is not None:
        lo, hi = bw_window
        for _ in range(3):      # a transient dip should not kill the sweep
            bw = measure_effective_bw()
            probes.append(bw)
            if bw is not None and lo <= bw <= hi:
                break
        else:
            window_ok = False
    best = {c: float("inf") for c in candidates}
    _TUNING.active = True
    try:
        if window_ok:
            for _ in range(rounds):
                for c in candidates:
                    try:
                        t = run_candidate(c)
                    except Exception:
                        t = float("inf")
                    if t < best[c]:
                        best[c] = t
    finally:
        _TUNING.active = False
    if bw_window is not None and window_ok:
        lo, hi = bw_window
        bw = measure_effective_bw()
        probes.append(bw)
        window_ok = bw is not None and lo <= bw <= hi
    winner = min(candidates, key=lambda c: best[c])
    measured = best[winner] != float("inf")
    # all failed, or the window never validated: no persisting, so a
    # later process retries instead of freezing a glitch
    persisted = window_ok and measured
    _SWEEPS.append({
        "key": list(key_parts), "device": dev,
        "candidates": {str(tuple(c)): (None if best[c] == float("inf")
                                       else round(best[c], 9))
                       for c in candidates},
        "winner": list(winner) if persisted else list(candidates[0]),
        "bw_probes_bytes_per_s": [None if p is None else round(p, 1)
                                  for p in probes],
        "bw_window": list(bw_window) if bw_window is not None else None,
        "window_validated": window_ok if bw_window is not None else None,
        "persisted": persisted,
        "rounds": rounds,
    })
    if not persisted:
        return tuple(candidates[0])
    with _LOCK:
        _MEM[key] = tuple(winner)
        _save_disk(dev)
    return tuple(winner)


def clear() -> None:
    with _LOCK:
        _MEM.clear()
        _LOADED_FILES.clear()
        for table in _VARIANT_TABLES:
            table._chosen.clear()


def _time_call(fn, iters=20) -> float:
    """Mean seconds a call of `fn` over `iters` calls, after one warm-up
    call: CUDA events on the current stream on the card, the host clock
    without one."""
    import torch
    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def time_launch(launch, args) -> float:
    """Seconds a ctypes launch ``launch(*args)`` takes (`_time_call`); a
    launch that returns an error raises, so its candidate scores inf."""

    def call():
        rc = launch(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")

    return _time_call(call)


def _validated_bw_window():
    """The card's validated bandwidth window
    (``observability.perf.VALIDATED_BW_WINDOW``), or None for a card the
    table does not know: the sweep then runs unvalidated."""
    from ..observability import perf
    return perf.lookup(None, perf.VALIDATED_BW_WINDOW)


def _process_count() -> int:
    from ..distributed import parallel
    return parallel.process_count()


class BuildVariants:
    """The build variants of one CUDA source that a sweep may time.

    `knobs`: {head_dim: (macro, ...)}, the source's -D tile macros at
    that head_dim. `variants`: a list of {head_dim: (value, ...)}, the
    source's own defaults first; one build of variant i sets every
    head_dim's macros, so it serves as a candidate at each head_dim.
    `load(flags)` builds and loads the source with those -D flags (the
    default build for no flags)."""

    def __init__(self, knobs, variants, load):
        self.knobs = dict(knobs)
        self.variants = list(variants)
        self._load = load
        self._libs: dict = {}           # flags -> loaded library
        self._chosen: dict = {}         # key -> library of its winner
        self._lock = threading.Lock()
        self._sweep_lock = threading.Lock()
        _VARIANT_TABLES.append(self)

    def defaults(self, d) -> tuple:
        return tuple(self.variants[0][d])

    def candidates(self, d) -> list:
        """The candidates at head_dim `d`, the defaults first, deduped."""
        return dedup_candidates([v[d] for v in self.variants],
                                lambda *c: tuple(c))

    def flags(self, d, cand) -> tuple:
        """The -D flags of the build that runs `cand` at head_dim `d`:
        none for the defaults, a table variant's (every head_dim's
        macros) when one holds it, else `cand`'s own macros."""
        cand = tuple(cand)
        if cand == self.defaults(d):
            return ()
        for v in self.variants[1:]:
            if tuple(v[d]) == cand:
                return tuple(f"-D{m}={x}" for dd in sorted(v)
                             for m, x in zip(self.knobs[dd], v[dd]))
        return tuple(f"-D{m}={x}" for m, x in zip(self.knobs[d], cand))

    def library(self, d, cand):
        """The loaded library that runs `cand` at head_dim `d` (built at
        first use)."""
        flags = self.flags(d, cand)
        if not flags:
            # the default build as the kernel's loader holds it now
            return self._load(())
        with self._lock:
            lib = self._libs.get(flags)
        if lib is None:
            lib = self._load(flags)
            with self._lock:
                self._libs.setdefault(flags, lib)
        return lib

    def chosen_flags(self, key):
        """The -D flags of the library this process chose for shape class
        `key` (() for the defaults, None before its first launch)."""
        lib = self._chosen.get(key)
        if lib is None:
            return None
        with self._lock:
            return next((f for f, x in self._libs.items() if x is lib), ())

    def loaded(self, d, cand) -> bool:
        flags = self.flags(d, cand)
        with self._lock:
            return not flags or flags in self._libs

    def select(self, key, d, time_library):
        """The library a launch of shape class `key` at head_dim `d`
        runs: the defaults with the kill switch off; else the winner
        held in memory or on disk; else, outside a capture and in a job
        of one process, the winner of a sweep in which
        time_library(lib) -> seconds times each candidate's library
        (built in parallel first; a build that fails scores inf). The
        choice is kept for the process: a sweep that persisted nothing
        is not repeated, and a shape class first met inside a capture
        keeps the defaults."""
        if not enabled():
            return self.library(d, self.defaults(d))
        lib = self._chosen.get(key)
        if lib is not None:
            return lib
        if getattr(_TUNING, "active", False):
            return self.library(d, self.defaults(d))
        with self._sweep_lock:
            lib = self._chosen.get(key)
            if lib is None:
                lib = self._chosen[key] = self._resolve(key, d,
                                                        time_library)
        return lib

    def _resolve(self, key, d, time_library):
        capturing = _capturing()
        hit = lookup(key)
        if capturing and (hit is None or not self.loaded(d, hit)):
            # nothing is timed, built or first loaded inside a capture:
            # the shape class keeps the defaults in this process, so its
            # eager calls match its captured ones
            return self.library(d, self.defaults(d))
        if hit is not None:
            return self.library(d, hit)
        cands = self.candidates(d)
        if _process_count() > 1 or len(cands) == 1:
            return self.library(d, self.defaults(d))
        return self.library(d, self._sweep(key, d, cands, time_library))

    def load_all(self):
        """Build (or fetch) and load every variant, in parallel."""
        flags = {self.flags(d, v[d]): (d, v[d]) for v in self.variants
                 for d in v}
        with ThreadPoolExecutor(max_workers=len(flags)) as pool:
            list(pool.map(lambda dc: self.library(*dc), flags.values()))

    def _sweep(self, key, d, cands, time_library):
        def build(c):
            try:
                return self.library(d, c)
            except Exception:
                return None

        with ThreadPoolExecutor(max_workers=len(cands)) as pool:
            libs = dict(zip(cands, pool.map(build, cands)))

        def run(c):
            if libs[c] is None:
                raise RuntimeError(f"variant {c} did not build")
            return time_library(libs[c])

        return tune(key, cands, run, bw_window=_validated_bw_window())
