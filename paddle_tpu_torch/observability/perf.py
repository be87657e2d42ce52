"""Performance observability: cost-model telemetry and roofline
accounting (counterpart of paddle_tpu/observability/perf.py).

* **Cost-model telemetry.** The reference reads each compiled
  executable's expectation from XLA's ``cost_analysis()``. The port has
  no such compiler, so every expectation is counted from the shapes by
  `count_cost`, whose docstring states each formula. `record_compile`
  remembers a family's expectation and publishes it as the reference's
  gauges, ``paddle_tpu_executable_flops{family=}`` and
  ``paddle_tpu_executable_bytes{family=,kind=accessed|output|temp|
  argument}``; the fields a shape count cannot know (output, argument
  and temp buffer sizes) stay 0.0, the reference's own convention for
  "the backend reports nothing".

* **Roofline accounting.** `observe_roofline(family, seconds, cost)`
  turns a measured launch or step latency plus its expectation into
  achieved FLOP/s and bytes/s against the device peaks, published as
  ``paddle_tpu_roofline_utilization{family=, bound=hbm|flops}``. The
  peaks come from the card tables below, keyed by
  ``torch.cuda.get_device_name()``; a device that matches no entry (the
  CPU) gets NO roofline series, as in the reference.
  `set_device_peaks()` pins the denominators explicitly.
  `interconnect_peaks()` / `set_interconnect_peaks()` are the same for
  the links that `observability.comms` reads.

* **The dispatch-engine series.** The reference's eager backward engine
  and its whole-graph backward cache report host dispatch gaps, batch
  sizes and cache outcomes (``paddle_tpu_dispatch_gap_seconds``,
  ``paddle_tpu_dispatch_gap_op_seconds_total``,
  ``paddle_tpu_dispatch_batch_size``,
  ``paddle_tpu_backward_graph_cache_total``). Those describe JAX's
  dispatch queue; torch.autograd has none, so the series are
  registered (the exports carry the reference's names) and their
  recorders are not ported.

Per-family run accumulators (`family_records()`) and `reset_window()`
are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from . import metrics as _m

__all__ = [
    "CostModel", "count_cost", "record_compile", "note_build",
    "observe_roofline",
    "family_records", "reset_window", "device_peaks",
    "set_device_peaks", "interconnect_peaks", "set_interconnect_peaks",
    "lookup", "PEAK_BF16_FLOPS", "HBM_BYTES_PER_SEC", "VALIDATED_BW_WINDOW",
    "ICI_BYTES_PER_SEC",
    "DCN_BYTES_PER_SEC", "DISPATCH_GAP_BUCKETS",
]

# ---------------------------------------------------------------------------
# device peaks: the card's published dense peaks (NVIDIA H100 SXM5 data
# sheet), keyed by a substring of torch.cuda.get_device_name(). The
# card this package is measured on reports "NVIDIA H100 80GB HBM3" with
# a 700.00 W power limit (nvidia-smi); a card set below 700 W runs
# slower under load, so its utilization reads low against these peaks.
# No TPU entry: the roofline gauges of an unmatched device publish
# nothing.
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = {
    # dense bf16 tensor-core FLOP/s
    "h100": 989e12,
}

HBM_BYTES_PER_SEC = {
    # HBM3 bandwidth (spec)
    "h100": 3.35e12,
}

# the card's measured effective bandwidth window (bytes/s): the range
# in which kernels/autotune.py accepts a sweep's timings. Its probe is
# autotune.measure_effective_bw (4 passes of a + 1.0 over 64 MiB of f32
# into one output, read and write counted). On "NVIDIA H100 80GB HBM3"
# at 700.00 W it read 2.49-2.82 TB/s (median 2.78) in a fresh process
# and 2.22-2.41 TB/s in chip_smoke.py's, after its training phases
# (phase 38); the window takes 1.8 TB/s (~19 % below the lowest
# reading) up to the card's 3.35 TB/s data-sheet rate. A card without
# an entry tunes unvalidated, as in the reference.
VALIDATED_BW_WINDOW: Dict[str, Tuple[float, float]] = {
    "h100": (1.8e12, 3.35e12),
}

# the card's aggregate ONE-WAY interconnect bandwidth (spec), under the
# reference's link labels: "ici" is the card's NVLink to the other cards
# of its host (H100 SXM, NVLink 4: 18 links x 25 GB/s = 450 GB/s each way,
# NVIDIA's data sheet), "dcn" the network between hosts, which no table
# here knows. observability.comms reads these strictly: a link without a
# known peak publishes no link-utilization series.
ICI_BYTES_PER_SEC = {
    "h100": 450e9,
}

DCN_BYTES_PER_SEC: Dict[str, float] = {}


def _device_name(device) -> str:
    """The card's name for a device given as a name, an index, a
    torch.device or None (the current CUDA device); "" without one."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return ""
        device = device.index
    name = _NAMES.get(device)
    if name is None:
        if not torch.cuda.is_available():
            return ""
        name = _NAMES[device] = torch.cuda.get_device_name(device)
    return name


_NAMES: Dict[Optional[int], str] = {}


def lookup(device, table: dict, default=None):
    """Substring match of the device's name (lower-cased, spaces taken
    out) against a peak table, the reference's convention."""
    kind = _device_name(device).lower().replace(" ", "")
    for key, val in table.items():
        if key in kind:
            return val
    return default


# operator/test override: (peak_flops, peak_bytes_per_sec) or None
_PEAK_OVERRIDE: Optional[Tuple[float, float]] = None


def set_device_peaks(flops: Optional[float] = None,
                     bytes_per_sec: Optional[float] = None) -> None:
    """Pin the roofline denominators explicitly (tests on the CPU, which
    otherwise publishes no roofline series; a session that measured its
    card's own rates). Call with no arguments to clear the override."""
    global _PEAK_OVERRIDE
    if flops is None and bytes_per_sec is None:
        _PEAK_OVERRIDE = None
    else:
        _PEAK_OVERRIDE = (float(flops or 0.0), float(bytes_per_sec or 0.0))


# operator/test override for the interconnect denominators:
# {"ici": x, "dcn": y} or None
_INTERCONNECT_OVERRIDE: Optional[dict] = None


def set_interconnect_peaks(ici: Optional[float] = None,
                           dcn: Optional[float] = None) -> None:
    """Pin the interconnect peak denominators explicitly (tests on the
    CPU, sessions that measured their fabric). Call with no arguments to
    clear the override."""
    global _INTERCONNECT_OVERRIDE
    if ici is None and dcn is None:
        _INTERCONNECT_OVERRIDE = None
    else:
        _INTERCONNECT_OVERRIDE = {"ici": float(ici or 0.0),
                                  "dcn": float(dcn or 0.0)}


def interconnect_peaks(device=None) -> Optional[dict]:
    """{"ici": bytes/s, "dcn": bytes/s} of the card (the current CUDA
    device by default; 0.0 for a link no table knows), or None when its
    name matches neither table or there is no card: the collective
    link-utilization gauges then publish NOTHING, the device_peaks()
    convention."""
    if _INTERCONNECT_OVERRIDE is not None:
        return _INTERCONNECT_OVERRIDE
    ici = lookup(device, ICI_BYTES_PER_SEC)
    dcn = lookup(device, DCN_BYTES_PER_SEC)
    if ici is None and dcn is None:
        return None
    return {"ici": ici or 0.0, "dcn": dcn or 0.0}


def device_peaks(device=None) -> Optional[Tuple[float, float]]:
    """(peak_flops, peak_bytes_per_sec) of the card (the current CUDA
    device by default), or None when its name matches no table entry or
    there is no card: the roofline gauges then publish NOTHING rather
    than a utilization against a made-up denominator."""
    if _PEAK_OVERRIDE is not None:
        return _PEAK_OVERRIDE
    flops = lookup(device, PEAK_BF16_FLOPS)
    bw = lookup(device, HBM_BYTES_PER_SEC)
    if flops is None or bw is None:
        return None
    return (flops, bw)


# ---------------------------------------------------------------------------
# expectations
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostModel:
    """The expected work of one launch or step: total FLOPs and HBM
    bytes accessed, and the buffer-class byte sizes (0.0 where nothing
    reports them)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_output: float = 0.0
    bytes_argument: float = 0.0
    bytes_temp: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def count_cost(family: str, **shape) -> CostModel:
    """A family's expectation counted from its shapes: the work the
    function must do on this call's data (live tokens and the context
    each row really attends; padding rows and dead slots are left out),
    so a utilization read is a lower bound. Every FLOP is a multiply or
    an add of a matrix product; the elementwise work is left out.

    ``engine_decode`` (one decode chunk: `steps` steps over `rows`
    batch rows, every row computing a token a step):
        flops = 2 * params * rows * steps + 4 * layers * heads * head_dim
                * attended
        bytes = steps * (param_bytes + logits_bytes)
                + (attended + steps * rows) * kv_token_bytes
      `attended` is the sum over steps and rows of the positions a
      row's token attends, `kv_token_bytes` the bytes of one token's k
      and v in every layer's pool, `logits_bytes` one step's logits.

    ``engine_ragged`` (one packed wave of `tokens` live tokens, the lm
    head applied to `head_rows` of them):
        flops = 2 * (params - head_params) * tokens
                + 2 * head_params * head_rows
                + 4 * layers * heads * head_dim * attended
        bytes = param_bytes + (cached + tokens) * kv_token_bytes
                + logits_bytes
      the weights read once, the rows' cached pages read once and the
      new tokens' k and v written once; `attended` sums, over the live
      tokens, the positions each attends (its cached context and the
      causal part of its own row).

    ``train_step`` (bench.py's 6 N D, plus attention):
        flops = 6 * params * tokens
                + (6 if causal else 12) * layers * heads * head_dim
                * seq * tokens
        bytes = 2 * param_bytes + update_bytes
      the weights read by the forward and by the backward, and the
      update's bytes as ``optimizer_fused`` counts them.

    ``optimizer_fused`` (the multi-tensor update over `elements` f32
    work elements):
        flops = 17 * elements
        bytes = update_bytes
      `update_bytes` is what PERF.md's bound of the update counts: each
      element's w read and written, its gradient read, both moments
      read and written, and a master's cast written."""
    s = shape.get
    if family == "engine_decode":
        flops = (2.0 * s("params") * s("rows") * s("steps")
                 + 4.0 * s("layers") * s("heads") * s("head_dim")
                 * s("attended"))
        nbytes = (s("steps") * (s("param_bytes") + s("logits_bytes"))
                  + (s("attended") + s("steps") * s("rows"))
                  * s("kv_token_bytes"))
    elif family == "engine_ragged":
        flops = (2.0 * (s("params") - s("head_params")) * s("tokens")
                 + 2.0 * s("head_params") * s("head_rows")
                 + 4.0 * s("layers") * s("heads") * s("head_dim")
                 * s("attended"))
        nbytes = (s("param_bytes") + (s("cached") + s("tokens"))
                  * s("kv_token_bytes") + s("logits_bytes"))
    elif family == "train_step":
        flops = (6.0 * s("params") * s("tokens")
                 + (6.0 if s("causal") else 12.0) * s("layers")
                 * s("heads") * s("head_dim") * s("seq") * s("tokens"))
        nbytes = 2.0 * s("param_bytes") + s("update_bytes")
    elif family == "optimizer_fused":
        flops = 17.0 * s("elements")
        nbytes = s("update_bytes")
    else:
        raise ValueError(f"no shape count for family {family!r}")
    return CostModel(flops=float(flops), bytes_accessed=float(nbytes))


# ---------------------------------------------------------------------------
# metric handles (created once; the disabled path through every
# recorder below is a single module-flag check)
# ---------------------------------------------------------------------------
# the reference's dispatch-gap buckets (host-side tens-of-µs to low-ms
# events), kept so the registered series has the reference's schema
DISPATCH_GAP_BUCKETS = (
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3,
)

_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        r = _m.registry()
        _METRICS = {
            "flops": r.gauge(
                "paddle_tpu_executable_flops",
                "expected FLOPs of the family's most recently built "
                "executable (in this package: counted from its shapes "
                "at a CUDA graph's capture or a family's first call)",
                ("family",)),
            "bytes": r.gauge(
                "paddle_tpu_executable_bytes",
                "byte expectations of the family's most recently built "
                "executable: accessed = expected HBM traffic (counted "
                "from the shapes in this package), output/temp/"
                "argument = buffer-class sizes (0 here: nothing "
                "reports them)",
                ("family", "kind")),
            "roofline": r.gauge(
                "paddle_tpu_roofline_utilization",
                "achieved fraction of the device peak over the last "
                "measured launch/step of the family: bound=hbm is "
                "expected-bytes/latency over peak HBM bandwidth, "
                "bound=flops is expected-flops/latency over peak "
                "bf16 FLOP/s (spec peaks; unknown devices publish "
                "no series)",
                ("family", "bound")),
            "gap": r.histogram(
                "paddle_tpu_dispatch_gap_seconds",
                "host-side gap between consecutive grad-node "
                "dispatches in the reference's eager backward engine "
                "(not recorded by this package: torch.autograd "
                "dispatches its own nodes)",
                buckets=DISPATCH_GAP_BUCKETS),
            "gap_op": r.counter(
                "paddle_tpu_dispatch_gap_op_seconds_total",
                "cumulative dispatch-gap seconds attributed to the "
                "grad-node op type about to be dispatched (not recorded "
                "by this package)",
                ("op",)),
            "batch": r.histogram(
                "paddle_tpu_dispatch_batch_size",
                "grad nodes per backward dispatch call in the "
                "reference's fused dispatch engine (not recorded by "
                "this package)",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)),
            "graph_cache": r.counter(
                "paddle_tpu_backward_graph_cache_total",
                "the reference's whole-graph backward trace cache "
                "outcomes (not recorded by this package)",
                ("outcome",)),
        }
    return _METRICS


# ---------------------------------------------------------------------------
# per-family window accumulators. Keyed by family; reset per
# measurement window via reset_window() (obs.reset() calls it).
# ---------------------------------------------------------------------------
_FAMILY_COST: Dict[str, CostModel] = {}     # last build's expectation
_FAMILY_RUNS: Dict[str, dict] = {}          # this window's executions


def _family_slot(family: str) -> dict:
    slot = _FAMILY_RUNS.get(family)
    if slot is None:
        slot = _FAMILY_RUNS[family] = {
            "runs": 0, "seconds": 0.0, "flops": 0.0, "bytes": 0.0,
            "compiles": 0}
    return slot


def reset_window() -> None:
    """Drop this window's per-family run/compile accumulators (the
    recorded per-family cost models survive)."""
    _FAMILY_RUNS.clear()


def record_compile(family: str, compiled) -> Optional[CostModel]:
    """Remember a family's expectation and (when observability is
    enabled) publish the executable gauges. `compiled` is the
    `CostModel` of what was built (a CUDA graph's capture, a family's
    first call): the port has no compiled executable to read one from.
    None records nothing."""
    cm = compiled
    if cm is None:
        return None
    _FAMILY_COST[family] = cm
    if _m._ENABLED:
        m = _metrics()
        m["flops"].labels(family=family).set(cm.flops)
        b = m["bytes"]
        b.labels(family=family, kind="accessed").set(cm.bytes_accessed)
        b.labels(family=family, kind="output").set(cm.bytes_output)
        b.labels(family=family, kind="argument").set(cm.bytes_argument)
        b.labels(family=family, kind="temp").set(cm.bytes_temp)
        _family_slot(family)["compiles"] += 1
    return cm


def note_build(family: str, outcome: str, seconds: float) -> None:
    """Account one kernel library obtained through a persistent store
    (`inference.exec_cache.LibraryStore`): outcome "disk_hit" (loaded from the store, no
    compiler run) or "compile" (built, then saved), on
    `paddle_tpu_compile_total{family,outcome}` and the compile-seconds
    histogram, family = the library's name. No-op while observability
    is disabled."""
    if not _m._ENABLED:
        return
    c, h = _m.compile_metrics()
    c.labels(family=family, outcome=outcome).inc()
    h.labels(family=family).observe(seconds)


def observe_roofline(family: str, seconds: float,
                     cost: Optional[CostModel]) -> None:
    """Publish achieved-vs-peak utilization for one measured execution
    and accumulate the window's per-family achieved record. No-op while
    observability is disabled; the roofline gauges additionally demand
    a KNOWN device peak (see device_peaks)."""
    if not _m._ENABLED or cost is None or seconds <= 0.0:
        return
    slot = _family_slot(family)
    slot["runs"] += 1
    slot["seconds"] += seconds
    slot["flops"] += cost.flops
    slot["bytes"] += cost.bytes_accessed
    peaks = device_peaks()
    if peaks is None:
        return
    peak_flops, peak_bw = peaks
    m = _metrics()["roofline"]
    if peak_bw > 0:
        m.labels(family=family, bound="hbm").set(
            cost.bytes_accessed / seconds / peak_bw)
    if peak_flops > 0:
        m.labels(family=family, bound="flops").set(
            cost.flops / seconds / peak_flops)


def family_records() -> Dict[str, dict]:
    """This window's per-family expected/achieved summary. Families
    appear once they were built or executed in the window; achieved
    rates need at least one timed run (expected-only families, such as
    the optimizer's update, report null achieved)."""
    out = {}
    peaks = device_peaks()
    for family, slot in sorted(_FAMILY_RUNS.items()):
        cm = _FAMILY_COST.get(family)
        rec = {
            "runs": slot["runs"],
            "compiles": slot["compiles"],
            "seconds": round(slot["seconds"], 6),
            "expected": cm.as_dict() if cm is not None else None,
            "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None,
            "utilization_hbm": None,
            "utilization_flops": None,
        }
        if slot["runs"] and slot["seconds"] > 0:
            fps = slot["flops"] / slot["seconds"]
            bps = slot["bytes"] / slot["seconds"]
            rec["achieved_flops_per_s"] = round(fps, 1)
            rec["achieved_bytes_per_s"] = round(bps, 1)
            if peaks is not None:
                peak_flops, peak_bw = peaks
                if peak_flops > 0:
                    rec["utilization_flops"] = round(fps / peak_flops, 6)
                if peak_bw > 0:
                    rec["utilization_hbm"] = round(bps / peak_bw, 6)
        out[family] = rec
    return out
