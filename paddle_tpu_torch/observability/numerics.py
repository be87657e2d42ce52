"""Training numerics & model-health plane (counterpart of
paddle_tpu/observability/numerics.py: the same series, labels, record
keys, sentinel rules, flight reason and trace event, so a dashboard or a
supervisor written for the reference reads this package unchanged).

All of it is one module-flag check while the plane is off (the default):
the train loop pays one flag read a step, no allocation and no host
sync. `enable()` turns on three sub-surfaces:

* **In-step statistics.** On a sampled step (`want_stats()`, every
  `interval`-th training step) the optimizer and `TrainStep` hand over
  ONE packed f32 bundle in `pack_stats`'s layout: per-parameter gradient
  square-norms and nonfinite element counts, the pre-update parameter
  square-norm, the update's square-norm and the new parameters'
  nonfinite count. On the card the multi-tensor update kernel sums them
  from the values it holds in registers while it updates
  (`kernels/multi_tensor_adam.py`, the statistics variant); the
  per-tensor rule and the CPU take them from the arrays the update
  touches (`pack_stats` over each tensor), before the in-place copy. A `TrainStep` on the
  card captures a statistics variant of its graph (the numerics flag is
  in the graph key); its packed buffer is a static output of the graph.
  The reverse pass (`autograd.tape.run_backward`, dispatch mode
  "whole_graph") adds a `[grad_sq, nonfinite]` tap over the cotangents
  it adds to the leaves. The port runs one torch backward where the
  reference runs segments, so a backward is one tap and a record's
  `backward.segments` counts the backwards of the step.
  Published series: ``paddle_tpu_train_grad_norm{group=all|g<i>}``,
  ``paddle_tpu_train_param_norm``, ``paddle_tpu_train_update_ratio``
  and ``paddle_tpu_train_nonfinite_total{where=grad|param|loss}``.

* **The pull is asynchronous, one a published step.** `submit()`
  publishes the PREVIOUS step's bundle, then parks this one: on the card
  it copies the bundle (with the step's backward taps and loss) into a
  pinned host buffer without blocking, on the producing stream, and
  records an event; the next `submit()` or `flush()` waits on that
  event, which has long completed, and parses. `pulls()` counts exactly
  one pull a published step; the step itself calls no `.item()` and no
  `synchronize()`. The copy is ordered before whatever the stream runs
  next, so a bundle that lives in a buffer the next step overwrites (a
  captured graph's static output) needs no clone. On the CPU the bundle
  is copied at submit.

* **NaN/Inf sentinel and forensics.** Every publish runs the divergence
  check under a ``numerics.check`` span: nonfinite grads, params or loss,
  a grad-norm spike against the window median (× `spike_factor` once
  `min_window` samples exist), or a dynamic loss scale decreased to
  `loss_scale_floor` (`GradScaler.update` reports it) fires ONE
  ``numerics_divergence`` flight bundle (when `flight.arm()`ed) and a
  ``numerics.divergence`` trace event, latched so an episode yields one
  bundle; a clean publish re-arms it (`rearm()` does so explicitly). The
  ``numerics.check`` fault point (top of `Optimizer.step`, ctx
  ``where="step"``; `GradScaler.step` before its unscale, ctx
  ``where="amp"``) armed with ``exc=PoisonGradient(param=...)`` fills
  that parameter's gradient with NaN in place, so the real detection
  path sees the poison. A skipped AMP step counts once onto the grad
  nonfinite counter (`note_found_inf`) and drops its backward taps,
  without latching: that is dynamic loss scaling working.

The gauges are ordinary registry series, so they ride the fleet
bundles (`fleet.worker_farewell`) like every other series.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flight as _fl
from . import metrics as _m
from . import tracing as _t
from ..resilience import faults as _faults

__all__ = [
    "enable", "disable", "enabled", "config", "NumericsConfig",
    "PoisonGradient", "pack_stats", "submit", "note_backward_tap",
    "note_loss_scale", "note_found_inf", "check_fault", "flush",
    "last", "pulls", "want_stats", "tick", "reset_window",
]

# single-check hot-path flag (the metrics._ENABLED idiom): the train
# loop's instrumented sites read `numerics._ENABLED` directly
_ENABLED = False
_CFG: Optional["NumericsConfig"] = None


class NumericsConfig:
    __slots__ = ("window", "spike_factor", "min_window",
                 "loss_scale_floor", "history", "interval")

    def __init__(self, window=32, spike_factor=10.0, min_window=8,
                 loss_scale_floor=2.0, history=64, interval=64):
        self.window = max(2, int(window))
        self.spike_factor = float(spike_factor)
        self.min_window = max(2, int(min_window))
        self.loss_scale_floor = float(loss_scale_floor)
        self.history = max(4, int(history))
        self.interval = max(1, int(interval))


def enable(window: int = 32, spike_factor: float = 10.0,
           min_window: int = 8, loss_scale_floor: float = 2.0,
           history: int = 64, interval: int = 64) -> NumericsConfig:
    """Turn the numerics plane on, process-wide. A TrainStep on the card
    captures its statistics variant at its next call of each batch
    signature; the sentinel knobs: a grad norm over `spike_factor` × the running
    window median (once `min_window` samples exist), any nonfinite
    grad/param/loss count, or a dynamic loss scale decreased to
    `loss_scale_floor` or below fires a `numerics_divergence` flight
    bundle (when `flight.arm()`ed).

    `interval` is the sampling cadence: the bundle (and its pull) is
    made every `interval`-th training step — `interval=1` is every-step
    fidelity (what the chaos/correctness tests pin); the default 64 is
    the reference's. Divergence detection latency is bounded by the cadence
    and real divergence is ABSORBING — a NaN'd parameter stays NaN —
    so a diverged run is still caught at the next sampled step, with
    the same first-nonfinite attribution; only a transient
    single-step grad spike can fall between samples. AMP loss-scale
    telemetry and the scale-floor sentinel are per-step regardless
    (they ride GradScaler work that already happens)."""
    global _ENABLED, _CFG
    cfg = NumericsConfig(window, spike_factor, min_window,
                         loss_scale_floor, history, interval)
    _CFG = cfg
    _resize_windows(cfg)
    _ENABLED = True
    return cfg


def disable() -> None:
    """Turn the plane off (pending un-pulled stats are dropped; use
    flush() first to publish them)."""
    global _ENABLED, _PENDING
    _ENABLED = False
    _PENDING = None
    _STEP_TAPS.clear()


def enabled() -> bool:
    return _ENABLED


def config() -> Optional[NumericsConfig]:
    return _CFG


# ---------------------------------------------------------------------------
# state: the pending (not yet pulled) step bundle, this step's backward
# taps, the sentinel windows/histories, and the last published record
# ---------------------------------------------------------------------------
_PENDING: Optional[dict] = None
_STEP_TAPS: List = []           # device f32[2] arrays from the backward
_TAP_CAP = 512                  # bound: a pathological loop can't grow it
_STEP = 0
_TICK = 0                       # training-step counter for the cadence
_PULLS = 0
_DIVERGED = False
_GRAD_WINDOW: deque = deque(maxlen=32)
_LOSS_HISTORY: deque = deque(maxlen=64)
_LR_HISTORY: deque = deque(maxlen=64)
_SCALE_HISTORY: deque = deque(maxlen=64)
_LAST: Optional[dict] = None
_METRICS = None


def _resize_windows(cfg: NumericsConfig) -> None:
    global _GRAD_WINDOW, _LOSS_HISTORY, _LR_HISTORY, _SCALE_HISTORY
    _GRAD_WINDOW = deque(_GRAD_WINDOW, maxlen=cfg.window)
    _LOSS_HISTORY = deque(_LOSS_HISTORY, maxlen=cfg.history)
    _LR_HISTORY = deque(_LR_HISTORY, maxlen=cfg.history)
    _SCALE_HISTORY = deque(_SCALE_HISTORY, maxlen=cfg.history)


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _m.registry()
        _METRICS = {
            "grad_norm": r.gauge(
                "paddle_tpu_train_grad_norm",
                "global (group=all) and per-parameter-group (group="
                "g<i>) L2 gradient norm of the most recent published "
                "training step, computed device-side inside the fused "
                "optimizer / TrainStep stats variant and pulled "
                "asynchronously one step later",
                ("group",)),
            "param_norm": r.gauge(
                "paddle_tpu_train_param_norm",
                "L2 norm of the trainable parameters at the most "
                "recent published step (pre-update values)"),
            "update_ratio": r.gauge(
                "paddle_tpu_train_update_ratio",
                "update-to-weight ratio of the most recent published "
                "step: L2 norm of the applied parameter delta over "
                "the pre-update parameter norm"),
            "nonfinite": r.counter(
                "paddle_tpu_train_nonfinite_total",
                "nonfinite (NaN/Inf) training values detected by the "
                "numerics plane: where=grad / where=param count "
                "elements (an AMP-skipped step, whose grads never "
                "reach the optimizer bundle, counts 1), where=loss "
                "counts nonfinite loss steps",
                ("where",)),
        }
    return _METRICS


def want_stats() -> bool:
    """True when THIS training step is a sampled step: the bundle sites
    (the backward tap, the optimizer's statistics, their submits) all
    read the same decision, which holds until
    `tick()` advances the step counter at the end of the optimizer
    step. With the plane off this is one flag read."""
    if not _ENABLED:
        return False
    cfg = _CFG
    return _TICK % (cfg.interval if cfg is not None else 1) == 0


def tick() -> None:
    """Advance the training-step counter (called at the end of
    `Optimizer.step` and for an AMP-skipped step — one counter
    increment; call sites guard on the enabled flag)."""
    global _TICK
    _TICK += 1


def reset_window() -> None:
    """Drop the pending bundle, accumulated backward taps, sentinel
    windows/histories, the step/cadence counters and the divergence
    latch — the numerics half of `obs.reset()`'s fresh-measurement-
    window contract. The enabled flag, config and cumulative pull
    count survive."""
    global _PENDING, _STEP, _TICK, _DIVERGED, _LAST
    _PENDING = None
    _STEP_TAPS.clear()
    _STEP = 0
    _TICK = 0
    _DIVERGED = False
    _LAST = None
    _GRAD_WINDOW.clear()
    _LOSS_HISTORY.clear()
    _LR_HISTORY.clear()
    _SCALE_HISTORY.clear()


def rearm() -> None:
    """Clear the divergence latch WITHOUT touching windows/histories —
    a remediation (the autopilot's rollback + loss-scale re-raise)
    ended the episode, so the next collapse must count as a NEW
    episode even when no clean publish happened in between (every step
    of a floored AMP run is a skipped step: nothing publishes, so the
    clean-step re-arm never runs)."""
    global _DIVERGED
    _DIVERGED = False


def pulls() -> int:
    """Cumulative host pulls performed by the plane (exactly one per
    published step bundle — the ≤1-async-pull-per-step contract is
    test-pinned against this counter)."""
    return _PULLS


def last() -> Optional[dict]:
    """The most recently published step record (host-side plain data:
    grad_norm, per-group norms, per_param stats, param_norm,
    update_ratio, nonfinite counts, loss/lr, backward tap summary) —
    readable with metrics disabled."""
    return _LAST


# ---------------------------------------------------------------------------
# chaos: the numerics.check fault point + the PoisonGradient payload
# ---------------------------------------------------------------------------
class PoisonGradient(Exception):
    """Chaos payload for the `numerics.check` fault point: when an
    armed fault raises this, `check_fault` swallows it and overwrites
    the named parameter's gradient (or the first parameter with a
    gradient) with `value` (default NaN) — so chaos tests poison a
    REAL gradient and the genuine detection path, not a mock, produces
    the divergence bundle."""

    def __init__(self, param: Optional[str] = None,
                 value: float = float("nan")):
        super().__init__(f"poison gradient {param or '<first>'}")
        self.param = param
        self.value = value


def check_fault(where: str, pairs: Sequence[Tuple]) -> None:
    """Fire the `numerics.check` fault point (ctx: `where` — "step"
    from `Optimizer.step`, "amp" from `GradScaler.step`). Call sites
    guard on `faults._ACTIVE`, so the disarmed train loop never builds
    the `pairs` list: (parameter name, gradient tensor or None). A raised
    PoisonGradient fills the matching gradient with its value in place
    (`fill_`); any other injected effect (delay, exit_code, foreign exc)
    behaves like every other fault point."""
    try:
        _faults.fault_point("numerics.check", where=where)
    except PoisonGradient as pg:
        for name, g in pairs:
            if g is None:
                continue
            if pg.param is None or name == pg.param:
                g.fill_(pg.value)
                return
        raise RuntimeError(
            f"numerics.check poison: no parameter named {pg.param!r} "
            "with a live gradient") from pg


# ---------------------------------------------------------------------------
# the packed bundle's layout (plain torch: the tests, and every path that
# takes no kernel statistics, build it with this one definition)
# ---------------------------------------------------------------------------
@torch.no_grad()
def pack_stats(olds, grads, news):
    """Stats bundle over aligned (pre-update param, grad, post-update
    param) tensor lists. Layout (all f32, one 1-D tensor on their
    device):

        [0 : P]        per-parameter grad square-norms
        [P : 2P]       per-parameter grad nonfinite element counts
        [2P : 2P+3]    pre-update param square-norm, update (Δw)
                       square-norm, post-update param nonfinite count"""
    gsq, gnf = [], []
    dev = olds[0].device if olds else None
    psq = torch.zeros((), dtype=torch.float32, device=dev)
    dsq = torch.zeros((), dtype=torch.float32, device=dev)
    pnf = torch.zeros((), dtype=torch.float32, device=dev)
    for w, g, nw in zip(olds, grads, news):
        gf = g.float()
        gsq.append(torch.sum(gf * gf))
        gnf.append(torch.sum(~torch.isfinite(gf)).float())
        wf = w.float()
        nwf = nw.float()
        psq = psq + torch.sum(wf * wf)
        dsq = dsq + torch.sum((nwf - wf) * (nwf - wf))
        pnf = pnf + torch.sum(~torch.isfinite(nwf)).float()
    parts = [torch.stack(gsq), torch.stack(gnf)] if gsq else []
    return torch.cat(parts + [torch.stack([psq, dsq, pnf])])


def note_backward_tap(tap) -> None:
    """One backward's `[grad_sq, nonfinite]` tap over the cotangents it
    added to the leaves (a device f32[2] tensor — nothing is read here).
    Taps accumulate per step and ride the next `submit()`'s bundle; a
    backward-only loop publishes them via `flush()`."""
    if not _ENABLED:
        return
    if len(_STEP_TAPS) < _TAP_CAP:
        _STEP_TAPS.append(tap)


class _Pull:
    """One parked bundle's host copy: on the card a pinned buffer filled
    by non-blocking copies on the producing stream and an event recorded
    after them; on the CPU a plain copy made at once. `host()` waits on
    the event (finished by then) and returns the values as numpy."""

    __slots__ = ("buf", "event", "sizes")

    def __init__(self, parts):
        parts = [t.detach().reshape(-1) for t in parts]
        self.sizes = [t.numel() for t in parts]
        self.event = None
        if not parts:
            self.buf = torch.zeros(0)
        elif parts[0].device.type == "cuda":
            dev = parts[0].device
            self.buf = _pinned(sum(self.sizes))
            at = 0
            for t, n in zip(parts, self.sizes):
                self.buf[at:at + n].copy_(t, non_blocking=True)
                at += n
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))
        else:
            self.buf = torch.cat([t.float() for t in parts])

    def host(self):
        if self.event is not None:
            self.event.synchronize()
        flat = self.buf[:sum(self.sizes)].numpy().copy()
        out, at = [], 0
        for n in self.sizes:
            out.append(flat[at:at + n])
            at += n
        return out


# pinned host buffers by size: at most one bundle is parked at a time and
# it is parsed before the next one is copied, so one buffer a size serves
_PINNED: Dict[int, "torch.Tensor"] = {}


def _pinned(n: int):
    buf = _PINNED.get(n)
    if buf is None:
        buf = _PINNED[n] = torch.empty(n, dtype=torch.float32,
                                       pin_memory=True)
    return buf


def submit(packed, names: Sequence[str], groups: Sequence[str],
           loss=None, lr: Optional[float] = None,
           source: str = "optimizer") -> None:
    """Hand over one step's packed stats bundle (a tensor in the
    pack_stats layout, on the device that made it). Publishes the
    PREVIOUS step's pending bundle first, then parks this step's bundle
    (plus any accumulated backward taps and the loss scalar) until the
    next submit/flush: its host copy is started here without blocking
    (see `_Pull`), and nothing waits on the device."""
    global _PENDING, _STEP
    if not _ENABLED:
        return
    prev, _PENDING = _PENDING, None
    if prev is not None:
        _publish(prev)
    taps = _STEP_TAPS[:]
    _STEP_TAPS.clear()
    if loss is not None and hasattr(loss, "_data"):
        loss = loss._data
    _STEP += 1
    _PENDING = {
        "pull": _Pull(([] if packed is None else [packed]) + taps
                      + ([loss] if loss is not None else [])),
        "has_packed": packed is not None, "n_taps": len(taps),
        "has_loss": loss is not None,
        "names": tuple(names), "groups": tuple(groups), "lr": lr,
        "step": _STEP, "source": source,
    }


def flush() -> Optional[dict]:
    """Publish the pending bundle (and any backward taps that no
    optimizer submit has claimed) NOW — the explicit completion edge
    for the end of training and for tests. Returns the last published
    record."""
    global _PENDING, _STEP
    if _PENDING is not None:
        pending, _PENDING = _PENDING, None
        _publish(pending)
    if _STEP_TAPS and _ENABLED:
        taps = _STEP_TAPS[:]
        _STEP_TAPS.clear()
        _STEP += 1
        _publish({
            "pull": _Pull(taps), "has_packed": False,
            "n_taps": len(taps), "has_loss": False,
            "names": (), "groups": (), "lr": None, "step": _STEP,
            "source": "backward",
        })
    return _LAST


# ---------------------------------------------------------------------------
# publish: the one host pull, gauge/counter recording, and the sentinel
# ---------------------------------------------------------------------------
def _publish(p: dict) -> dict:
    global _PULLS, _LAST
    sp = _t.span("numerics.check", step=p["step"], source=p["source"])
    with sp:
        # THE pull: one wait on the bundle's copy event (complete a step
        # after it was recorded), one parse, per published step
        parts = p["pull"].host()
        _PULLS += 1
        host = parts[0] if p["has_packed"] else None
        rest = parts[1:] if p["has_packed"] else parts
        taps = rest[:p["n_taps"]] or None
        loss_val = (float(rest[p["n_taps"]][0]) if p["has_loss"]
                    else None)
        rec = _parse(p, host, taps, loss_val)
        _record(rec)
        reasons = _sentinel(rec)
    if reasons:
        _fire(reasons, rec,
              trace_id=getattr(sp, "trace_id", None),
              span_id=getattr(sp, "span_id", None))
    _LAST = rec
    return rec


def _parse(p: dict, host, taps, loss_val) -> dict:
    P = len(p["names"]) if host is not None else 0
    gsq = host[:P] if host is not None else ()
    gnf = host[P:2 * P] if host is not None else ()
    param_sq = delta_sq = param_nf = None
    if P:
        param_sq, delta_sq, param_nf = (float(host[2 * P]),
                                        float(host[2 * P + 1]),
                                        float(host[2 * P + 2]))

    per_param = [(name, float(math.sqrt(s)) if s >= 0.0 else float("nan"),
                  int(n))
                 for name, s, n in zip(p["names"], gsq, gnf)]
    grad_nf = int(np.sum(gnf)) if P else 0
    if P:
        total_sq = float(np.sum(gsq))
        grad_norm = (math.sqrt(total_sq) if total_sq >= 0.0
                     and math.isfinite(total_sq) else float("nan"))
    else:
        grad_norm = None
    by_group: Dict[str, float] = {}
    for g, s in zip(p["groups"], gsq):
        by_group[g] = by_group.get(g, 0.0) + float(s)
    group_norms = {g: (math.sqrt(s) if s >= 0.0 and math.isfinite(s)
                       else float("nan"))
                   for g, s in by_group.items()}
    backward = None
    if taps:
        bsq = float(sum(t[0] for t in taps))
        backward = {
            "grad_norm": (math.sqrt(bsq) if bsq >= 0.0
                          and math.isfinite(bsq) else float("nan")),
            "nonfinite": int(sum(t[1] for t in taps)),
            "segments": len(taps),
        }
        if grad_norm is None:
            grad_norm = backward["grad_norm"]
            grad_nf = backward["nonfinite"]
    first_nf = next((name for name, _n, c in per_param if c), None)
    param_norm = (math.sqrt(param_sq) if param_sq is not None
                  and param_sq >= 0.0 and math.isfinite(param_sq)
                  else None)
    update_ratio = None
    if (param_norm and delta_sq is not None and delta_sq >= 0.0
            and math.isfinite(delta_sq)):
        update_ratio = math.sqrt(delta_sq) / param_norm
    return {
        "step": p["step"], "source": p["source"],
        "grad_norm": grad_norm, "group_norms": group_norms,
        "per_param": per_param, "first_nonfinite_param": first_nf,
        "param_norm": param_norm, "update_ratio": update_ratio,
        "nonfinite": {
            "grad": grad_nf,
            "param": int(param_nf) if param_nf is not None else 0,
            "loss": int(loss_val is not None
                        and not math.isfinite(loss_val)),
        },
        "loss": loss_val, "lr": p["lr"], "backward": backward,
    }


def _record(rec: dict) -> None:
    if not _m._ENABLED:
        return
    m = _metrics()
    if rec["grad_norm"] is not None:
        m["grad_norm"].labels(group="all").set(rec["grad_norm"])
    for g, v in rec["group_norms"].items():
        m["grad_norm"].labels(group=g).set(v)
    if rec["param_norm"] is not None:
        m["param_norm"].set(rec["param_norm"])
    if rec["update_ratio"] is not None:
        m["update_ratio"].set(rec["update_ratio"])
    nf = rec["nonfinite"]
    for where in ("grad", "param", "loss"):
        if nf[where]:
            m["nonfinite"].labels(where=where).inc(nf[where])


def _sentinel(rec: dict) -> List[str]:
    """Divergence decision for one published record; returns the
    (possibly empty) reason list and maintains the windows, histories
    and the one-bundle-per-episode latch."""
    global _DIVERGED
    cfg = _CFG or NumericsConfig()
    reasons = []
    nf = rec["nonfinite"]
    if nf["grad"] or nf["param"] or nf["loss"]:
        reasons.append("nonfinite")
    gn = rec["grad_norm"]
    clean_norm = gn is not None and math.isfinite(gn)
    if (clean_norm and not reasons
            and len(_GRAD_WINDOW) >= cfg.min_window):
        med = sorted(_GRAD_WINDOW)[len(_GRAD_WINDOW) // 2]
        if med > 0.0 and gn > cfg.spike_factor * med:
            reasons.append("grad_spike")
    if clean_norm:
        # every FINITE norm enters the window — including a spiking
        # one. A sustained legitimate regime change (lr/schedule jump)
        # then raises the median within one window length, the spike
        # stops firing, and the next clean publish re-arms the latch;
        # were spiked norms excluded, the stale median would hold
        # grad_spike (and the latch) forever and a later REAL NaN
        # event could never fire its bundle (review finding, pinned
        # by test_sustained_regime_change_releases_latch). A single
        # transient spike barely moves a maxlen-window median.
        _GRAD_WINDOW.append(gn)
    if rec["loss"] is not None:
        _LOSS_HISTORY.append(rec["loss"])
    if rec["lr"] is not None:
        _LR_HISTORY.append(rec["lr"])
    if reasons:
        if _DIVERGED:
            return []           # same episode: already reported
        _DIVERGED = True
        return reasons
    _DIVERGED = False           # clean step re-arms the latch
    return []


def _fire(reasons: List[str], rec: dict, trace_id=None,
          span_id=None) -> None:
    offenders = sorted(rec.get("per_param") or [],
                       key=lambda t: (-t[2], -(t[1] if math.isfinite(t[1])
                                               else float("inf"))))
    detail = {
        "step": rec["step"], "source": rec["source"],
        "reasons": reasons,
        "first_nonfinite_param": rec.get("first_nonfinite_param"),
        "grad_norm": rec.get("grad_norm"),
        "grad_norm_window": [round(v, 6) for v in _GRAD_WINDOW],
        "per_param": offenders[:16],
        "nonfinite": rec.get("nonfinite"),
        "loss": rec.get("loss"), "lr": rec.get("lr"),
        "loss_history": list(_LOSS_HISTORY),
        "lr_history": list(_LR_HISTORY),
        "loss_scale_history": list(_SCALE_HISTORY),
        "backward": rec.get("backward"),
    }
    if trace_id is not None:
        detail["trace_id"] = trace_id
        detail["span_id"] = span_id
    _fl.trigger("numerics_divergence", detail=detail)
    if _t.enabled():
        # structured divergence event INTO the trace ring: the fleet
        # bundles ship ring events, so this is how a divergence leaves
        # the process with enough attribution to pick a remediation —
        # the flight bundle above stays on the diverging process's disk
        import time as _time
        _t.add_event("numerics.divergence",
                     _time.perf_counter() * 1e6, 0.0, args={
            "step": rec["step"], "source": rec["source"],
            "reasons": list(reasons),
            "first_nonfinite_param": rec.get("first_nonfinite_param"),
            "grad_norm": rec.get("grad_norm"),
            "loss_scale": (rec.get("nonfinite") or {}).get("loss_scale"),
        })


# ---------------------------------------------------------------------------
# AMP hooks (called by amp.GradScaler)
# ---------------------------------------------------------------------------
def note_loss_scale(scale: float, decreased: bool = False) -> None:
    """One dynamic-loss-scale reading from `GradScaler.update` — feeds
    the scale history that rides divergence bundles, and a DECREASE
    down to the configured floor fires the sentinel (a collapsed scale
    means the run cannot find a finite scale: divergence, not routine
    adjustment)."""
    global _DIVERGED
    if not _ENABLED:
        return
    cfg = _CFG or NumericsConfig()
    _SCALE_HISTORY.append(float(scale))
    if decreased and scale <= cfg.loss_scale_floor and not _DIVERGED:
        _DIVERGED = True
        _fire(["loss_scale_floor"], {
            "step": _STEP, "source": "amp", "per_param": [],
            "first_nonfinite_param": None, "grad_norm": None,
            "nonfinite": {"grad": 0, "param": 0, "loss": 0,
                          "loss_scale": float(scale)},
            "loss": None, "lr": None, "backward": None,
        })


def note_found_inf() -> None:
    """An AMP step skipped on found_inf: the optimizer never ran, so
    no packed bundle carries these grads — count the event (1, not an
    element count) onto the grad nonfinite counter. Deliberately NOT
    latched as divergence: a skipped step is dynamic loss scaling
    doing its job; the sentinel fires on the scale FLOOR instead.
    The skipped step's backward taps are DISCARDED for the same
    reason — left in place, the next clean step's submit would bundle
    their nonfinite counts and fire a false divergence."""
    if not _ENABLED:
        return
    _STEP_TAPS.clear()
    if _m._ENABLED:
        _metrics()["nonfinite"].labels(where="grad").inc()
