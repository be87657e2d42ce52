"""The local part of the fleet observability plane (counterpart of
paddle_tpu/observability/fleet.py:98-262): a process's fleet identity,
the snapshot-delta encoding, the wire bundle and its local merge, and
the one-shot farewell a spawned DataLoader worker ships when it
finishes. The worker farewell ships this bundle format and the parent
folds it in with `merge_bundle_local`: one wire shape and one merge
path, as in the reference.

The standing plane (the reference's ``FleetAgent``, ``FleetAggregator``
and ``serve_aggregator`` over its HMAC RPC layer, with the capacity
ledger) is not ported yet: it goes with ROADMAP Queue A item 24."""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import metrics as _m
from . import tracing as _t

__all__ = [
    "BUNDLE_VERSION", "delta_snapshot", "make_bundle",
    "merge_bundle_local", "worker_farewell", "set_identity",
    "suggest_role", "identity",
]

BUNDLE_VERSION = 1


# ---------------------------------------------------------------------------
# process identity: the `process` label value and `process_role` every
# shipped series is attributed to. Explicit set_identity wins; absent
# that, the first subsystem suggestion (Router suggests "router",
# LLMEngine "engine") names the role, and the process name defaults to
# "<role>-<pid>".
# ---------------------------------------------------------------------------
_IDENT_LOCK = threading.Lock()
_PROCESS: Optional[str] = None
_ROLE: Optional[str] = None
_ROLE_EXPLICIT = False


def set_identity(process: Optional[str] = None,
                 role: Optional[str] = None) -> None:
    """Pin this process's fleet identity explicitly (launch CLIs and
    tests call this; it beats any suggest_role)."""
    global _PROCESS, _ROLE, _ROLE_EXPLICIT
    with _IDENT_LOCK:
        if process is not None:
            _PROCESS = str(process)
        if role is not None:
            _ROLE = str(role)
            _ROLE_EXPLICIT = True


def suggest_role(role: str) -> None:
    """Weak role hint from an instantiated subsystem — first suggestion
    wins, an explicit set_identity always wins. Router/LLMEngine call
    this on construction so an unconfigured replica process still ships
    a meaningful process_role."""
    global _ROLE
    with _IDENT_LOCK:
        if _ROLE is None and not _ROLE_EXPLICIT:
            _ROLE = str(role)


def identity() -> Tuple[str, str]:
    """(process, role) this process ships under."""
    with _IDENT_LOCK:
        role = _ROLE or "proc"
        proc = _PROCESS or f"{role}-{os.getpid()}"
        return proc, role


# ---------------------------------------------------------------------------
# snapshot-delta encoding (the one wire format)
# ---------------------------------------------------------------------------
def delta_snapshot(cur: dict, base: Optional[dict]) -> dict:
    """Mergeable snapshot of `cur - base`: feeding every delta through
    `MetricsRegistry.merge` reconstructs `cur` exactly (sequence-
    numbered redelivery is deduped by the aggregator, so sums never
    double-count). Zero-delta series are pruned — an idle process ships
    bytes proportional to what changed, not to what is registered.

    Per kind: counters and histograms subtract (bucket-wise for
    histograms; the delta's min/max are the CUMULATIVE extrema — the
    window's own extrema are unknowable from two cumulative snapshots,
    and merge() only widens, so the merged extrema stay correct);
    gauges subtract, so the additive merge telescopes to the current
    reading. A counter or histogram that went BACKWARDS (the peer reset
    its registry mid-run) ships its full current value — a restart
    re-contributes, it never subtracts."""
    out: Dict[str, dict] = {}
    base = base or {}
    for name, rec in cur.items():
        brec = base.get(name)
        bseries = brec["series"] if brec else {}
        series = {}
        for key, val in rec["series"].items():
            bval = bseries.get(key)
            if rec["kind"] == "histogram":
                d = None
                if (bval is not None
                        and bval["count"] <= val["count"]
                        and len(bval["buckets"]) == len(val["buckets"])):
                    d = {
                        "buckets": [c - b for c, b in
                                    zip(val["buckets"], bval["buckets"])],
                        "sum": val["sum"] - bval["sum"],
                        "count": val["count"] - bval["count"],
                        "min": val["min"], "max": val["max"],
                    }
                    # a reset can hide behind a total count that grew
                    # back past the baseline; any individual bucket
                    # going backwards unmasks it, as does a shrinking
                    # sum (sound for the non-negative quantities every
                    # histogram here records). A reset whose new
                    # distribution dominates every bucket AND the sum
                    # is the epoch-free residual: it under-ships by
                    # the lost pre-reset counts, it never corrupts.
                    if any(b < 0 for b in d["buckets"]) or d["sum"] < 0:
                        d = None
                if d is None:       # no base, or reset: ship in full
                    d = dict(val)
                if d["count"] == 0:
                    continue
                series[key] = d
            else:
                dv = val - bval if bval is not None else val
                if rec["kind"] == "counter" and dv < 0:
                    dv = val        # reset: re-contribute in full
                if dv == 0.0:
                    continue
                series[key] = dv
        if series:
            drec = {"kind": rec["kind"], "help": rec["help"],
                    "labelnames": rec["labelnames"], "series": series}
            if rec["kind"] == "histogram":
                drec["buckets"] = rec["buckets"]
            out[name] = drec
    return out


def _relabel(snap: dict, labelname: str, labelvalue: str) -> dict:
    """Append one label dimension (`process=<value>`) to every series
    of a snapshot, so per-process series merge side-by-side in the
    aggregator's registry instead of summing into one anonymous blob.
    A metric that already carries the dimension (a re-aggregated
    bundle) passes through unchanged."""
    out = {}
    for name, rec in snap.items():
        if labelname in rec["labelnames"]:
            out[name] = rec
            continue
        rrec = {"kind": rec["kind"], "help": rec["help"],
                "labelnames": tuple(rec["labelnames"]) + (labelname,),
                "series": {tuple(k) + (str(labelvalue),): v
                           for k, v in rec["series"].items()}}
        if rec["kind"] == "histogram":
            rrec["buckets"] = rec["buckets"]
        out[name] = rrec
    return out


def make_bundle(process: str, role: str, seq: int,
                metrics_delta: Optional[dict] = None,
                trace: Optional[list] = None,
                heartbeat_extra: Optional[dict] = None) -> dict:
    """One fleet wire bundle (picklable plain data; `v` gates decoding
    so a future format bump fails loudly, not quietly wrong)."""
    hb = {"pid": os.getpid(), "time_unix": time.time()}
    if heartbeat_extra:
        hb.update(heartbeat_extra)
    return {"v": BUNDLE_VERSION, "process": str(process),
            "role": str(role), "seq": int(seq),
            "metrics": metrics_delta, "trace": trace, "heartbeat": hb}


def merge_bundle_local(payload: Optional[dict]) -> None:
    """Fold a bundle from the SAME logical process tree (the DataLoader
    worker farewell) into the process-global stores WITHOUT a process
    label: worker series are the parent's own work, shipped from a
    helper pid. Accepts the v1 bundle and the legacy
    ``{"metrics", "trace"}`` farewell shape alike — one merge path."""
    if not payload:
        return
    _m.registry().merge(payload.get("metrics") or {})
    _t.ingest(payload.get("trace") or ())


def worker_farewell(metrics: bool = True, trace: bool = True) -> dict:
    """The one-shot farewell a spawn worker ships when it finishes:
    a seq-1 bundle holding this process's full recorded history (a
    delta against the empty base — same pruning, same merge path as
    the standing agent)."""
    proc, role = identity()
    md = delta_snapshot(_m.registry().snapshot(), None) if metrics \
        else None
    tr = _t.events() if trace else None
    return make_bundle(proc, role, 1, metrics_delta=md, trace=tr)
