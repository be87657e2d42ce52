"""paddle_tpu_torch.distributed.rpc and the fleet observability plane's
agent and aggregator (observability/fleet.py), on the cases of the
reference's tests/test_rpc.py (the single-worker group, serve /
call_endpoint, the stitched trace ids, the latency series, counted
rejections) and tests/test_fleet_obs.py (the aggregator's process label,
seq dedupe, quarantine, poison bundles, staleness, respawns; the agent's
rollback and redelivery, counted drops, the farewell; the capacity
records), the reference's spawn-process cases aside. Then the port's and
the reference's aggregators ingest the same bundles and hold equal
registries, and a port agent ships to a reference aggregator over the
shared HMAC frames."""
import time

import pytest

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _double(x):
    return 2 * x


def _boom():
    return 1 // 0


def test_single_worker_rpc_roundtrip():
    from paddle_tpu_torch.distributed import rpc
    port = _free_port()
    rpc.init_rpc("solo", rank=0, world_size=1,
                 master_endpoint=f"127.0.0.1:{port}")
    try:
        assert rpc.rpc_sync("solo", _double, args=(21,)) == 42
        fut = rpc.rpc_async("solo", _double, args=(5,))
        assert fut.wait(timeout=30) == 10
        info = rpc.get_worker_info("solo")
        assert info.name == "solo" and info.rank == 0
        assert rpc.get_current_worker_info() == info
        assert [w.name for w in rpc.get_all_worker_infos()] == ["solo"]
        # remote exceptions propagate
        with pytest.raises(ZeroDivisionError):
            rpc.rpc_sync("solo", _boom)
    finally:
        rpc.shutdown()


class TestRpcObservability:
    """RPC reports itself: client/server latency + request counters,
    trace-context stitching across the call frame, and counted (never
    silent) frame rejections."""

    @pytest.fixture(autouse=True)
    def _clean(self):
        from paddle_tpu_torch import observability as obs
        obs.disable()
        obs.reset()
        yield
        obs.disable()
        obs.reset()

    def test_serve_and_call_endpoint_no_rendezvous(self):
        from paddle_tpu_torch.distributed import rpc
        srv, endpoint = rpc.serve()
        try:
            assert rpc.call_endpoint(endpoint, _double,
                                     args=(21,)) == 42
            with pytest.raises(ZeroDivisionError):
                rpc.call_endpoint(endpoint, _boom)
        finally:
            srv.shutdown()
            srv.server_close()

    def test_client_server_spans_share_trace(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.distributed import rpc
        from paddle_tpu_torch.observability import tracing
        obs.enable()
        srv, endpoint = rpc.serve()
        try:
            with tracing.span("t.rpc_root"):
                assert rpc.call_endpoint(endpoint, _double,
                                         args=(4,)) == 8
        finally:
            srv.shutdown()
            srv.server_close()
        evs = tracing.events()
        client = [e for e in evs if e["name"] == "rpc.client"]
        server = [e for e in evs if e["name"] == "rpc.server"]
        root = [e for e in evs if e["name"] == "t.rpc_root"]
        assert len(client) == 1 and len(server) == 1
        # one connected tree: root -> rpc.client -> rpc.server
        assert client[0]["trace_id"] == root[0]["trace_id"]
        assert server[0]["trace_id"] == client[0]["trace_id"]
        assert server[0]["parent_id"] == client[0]["span_id"]
        assert client[0]["parent_id"] == root[0]["span_id"]
        assert client[0]["args"]["fn"] == "_double"

    def test_async_call_joins_callers_trace(self):
        """rpc_async runs on an executor thread; the caller's
        contextvars snapshot must ride along or the async client span
        starts a fresh, disconnected trace."""
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.distributed import rpc
        from paddle_tpu_torch.observability import tracing
        obs.enable()
        port = _free_port()
        rpc.init_rpc("solo_t", rank=0, world_size=1,
                     master_endpoint=f"127.0.0.1:{port}")
        try:
            with tracing.span("t.rpc_async_root"):
                fut = rpc.rpc_async("solo_t", _double, args=(3,))
                assert fut.wait(timeout=30) == 6
        finally:
            rpc.shutdown()
        evs = tracing.events()
        root = [e for e in evs if e["name"] == "t.rpc_async_root"][0]
        client = [e for e in evs if e["name"] == "rpc.client"]
        assert len(client) == 1
        assert client[0]["trace_id"] == root["trace_id"]
        assert client[0]["parent_id"] == root["span_id"]

    def test_latency_histograms_and_request_counters(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.distributed import rpc
        obs.enable()
        srv, endpoint = rpc.serve()
        try:
            rpc.call_endpoint(endpoint, _double, args=(1,))
            with pytest.raises(ZeroDivisionError):
                rpc.call_endpoint(endpoint, _boom)
        finally:
            srv.shutdown()
            srv.server_close()
        snap = obs.snapshot()
        req = snap["paddle_tpu_rpc_requests_total"]["series"]
        assert req[("client", "ok")] == 1
        assert req[("client", "err")] == 1
        assert req[("server", "ok")] == 1
        assert req[("server", "err")] == 1
        assert snap["paddle_tpu_rpc_client_seconds"]["series"][()][
            "count"] == 2
        assert snap["paddle_tpu_rpc_server_seconds"]["series"][()][
            "count"] == 2

    def _rejected(self):
        from paddle_tpu_torch import observability as obs
        snap = obs.snapshot().get(
            "paddle_tpu_rpc_rejected_frames_total", {"series": {}})
        return {k: v for k, v in snap["series"].items()}

    def test_bad_mac_frame_counted_and_logged(self, caplog):
        import logging
        import socket
        import struct
        from paddle_tpu_torch.distributed import rpc
        srv, endpoint = rpc.serve()
        ip, port = endpoint.rsplit(":", 1)
        payload = b"not-a-real-pickle"
        frame = struct.pack("!Q", len(payload)) + b"\x00" * 32 + payload
        try:
            with caplog.at_level(
                    logging.WARNING, "paddle_tpu_torch.distributed.rpc"):
                with socket.create_connection((ip, int(port)),
                                              timeout=10) as s:
                    s.sendall(frame)
                    # server drops the frame without replying: recv
                    # sees a clean close, never a pickle of our bytes
                    assert s.recv(1) == b""
        finally:
            srv.shutdown()
            srv.server_close()
        # counted regardless of the recording flag (obs is disabled
        # here), with the peer address in the log — auth misconfig is
        # distinguishable from network flake
        assert self._rejected().get(("bad_mac",)) == 1
        assert any("bad_mac" in r.message and "127.0.0.1" in r.message
                   for r in caplog.records)

    def test_keyed_server_answers_its_own_key_only(self):
        """A server given its own key (a spawned replica's) refuses a
        frame signed with the environment's key before unpickling it,
        counts it, and answers a caller that holds the key."""
        import secrets
        from paddle_tpu_torch.distributed import rpc
        key = secrets.token_bytes(32)
        srv, endpoint = rpc._serve(token=key)
        ip, port = endpoint.rsplit(":", 1)
        try:
            with pytest.raises(ConnectionError):
                rpc.call_endpoint(endpoint, _double, args=(2,), timeout=10)
            assert self._rejected().get(("bad_mac",)) == 1
            assert rpc._call_endpoint(ip, int(port), _double, (21,), {},
                                      10, token=key) == 42
            # a keyed caller is refused by a server on the default key
            plain, plain_ep = rpc.serve()
            try:
                pip, pport = plain_ep.rsplit(":", 1)
                with pytest.raises(ConnectionError):
                    rpc._call_endpoint(pip, int(pport), _double, (1,), {},
                                       10, token=key)
            finally:
                plain.shutdown()
                plain.server_close()
            assert self._rejected().get(("bad_mac",)) == 2
        finally:
            srv.shutdown()
            srv.server_close()

    def test_short_frame_counted(self):
        import socket
        import struct
        import time as _time
        from paddle_tpu_torch.distributed import rpc
        srv, endpoint = rpc.serve()
        ip, port = endpoint.rsplit(":", 1)
        try:
            with socket.create_connection((ip, int(port)),
                                          timeout=10) as s:
                s.sendall(struct.pack("!Q", 1 << 10))  # then hang up
            # the handler thread observes the close on its own
            # schedule — poll with a deadline, no fixed sleep
            deadline = _time.time() + 30.0
            while _time.time() < deadline and \
                    not self._rejected().get(("short_frame",)):
                _time.sleep(0.05)
        finally:
            srv.shutdown()
            srv.server_close()
        assert self._rejected().get(("short_frame",)) == 1




@pytest.fixture(autouse=True)
def _fleet_clean():
    """Every test starts disabled with empty stores, a neutral fleet
    identity, and no aggregator serving in this process."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import fleet, tracing
    obs.disable()
    obs.reset()
    tracing.clear()
    cap = tracing.capacity()
    saved = (fleet._PROCESS, fleet._ROLE, fleet._ROLE_EXPLICIT)
    fleet._PROCESS, fleet._ROLE, fleet._ROLE_EXPLICIT = None, None, False
    yield
    if fleet._AGGREGATOR is not None:
        fleet._AGGREGATOR.close()
    fleet._PROCESS, fleet._ROLE, fleet._ROLE_EXPLICIT = saved
    obs.disable()
    obs.reset()
    tracing.set_capacity(cap)


def _snap_series(reg, name):
    return reg.snapshot()[name]["series"]


class TestAggregator:
    def _agg(self, stale_after_s=10.0):
        from paddle_tpu_torch.observability.fleet import FleetAggregator
        return FleetAggregator(stale_after_s=stale_after_s)

    def _bundle(self, proc, seq, series=None, role="replica"):
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        md = None
        if series is not None:
            src = MetricsRegistry()
            from paddle_tpu_torch.observability import metrics as _m
            _m.enable()
            for name, v in series.items():
                src.counter(name, "test").inc(v)
            md = fleet.delta_snapshot(src.snapshot(), None)
        return fleet.make_bundle(proc, role, seq, metrics_delta=md)

    def test_process_label_dimension(self):
        agg = self._agg()
        agg.ingest(self._bundle("pa", 1, {"t_fa_total": 3}))
        agg.ingest(self._bundle("pb", 1, {"t_fa_total": 5}))
        s = _snap_series(agg.registry, "t_fa_total")
        assert s[("pa",)] == 3 and s[("pb",)] == 5
        expo = agg.to_prometheus()
        assert 'process="pa"' in expo and 'process="pb"' in expo

    def test_seq_dedupe_no_double_count(self):
        agg = self._agg()
        b = self._bundle("pa", 1, {"t_fs_total": 4})
        assert agg.ingest(b)["ok"]
        ack = agg.ingest(b)          # redelivery after a lost ack
        assert ack["duplicate"] and ack["last_seq"] == 1
        stale = self._bundle("pa", 1, {"t_fs_total": 100})
        assert agg.ingest(stale)["duplicate"]
        assert _snap_series(agg.registry, "t_fs_total")[("pa",)] == 4
        assert _snap_series(
            agg.registry,
            "paddle_tpu_fleet_duplicate_bundles_total")[("pa",)] == 2

    def test_schema_skew_quarantined_not_poisoning(self):
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        from paddle_tpu_torch.observability import metrics as _m
        _m.enable()
        agg = self._agg()
        a = MetricsRegistry()
        a.histogram("t_fq_seconds", "", buckets=(0.1,)).observe(0.05)
        agg.ingest(fleet.make_bundle(
            "pa", "r", 1,
            metrics_delta=fleet.delta_snapshot(a.snapshot(), None)))
        b = MetricsRegistry()
        b.histogram("t_fq_seconds", "", buckets=(9.0,)).observe(1.0)
        agg.ingest(fleet.make_bundle(
            "pb", "r", 1,
            metrics_delta=fleet.delta_snapshot(b.snapshot(), None)))
        snap = agg.registry.snapshot()
        assert snap["t_fq_seconds"]["series"][("pa",)]["count"] == 1
        assert snap["t_fq_skew_seconds"]["series"][("pb",)]["count"] == 1
        assert snap["paddle_tpu_fleet_quarantined_series_total"][
            "series"][("pb",)] == 1

    def test_poison_bundle_rejected_with_accounting_seq_advances(self):
        """Three peers, three schemas for one name: the third cannot
        merge even under quarantine (slot taken by the second). Its
        metric delta is dropped WITH accounting and the seq still
        advances — the agent must not be wedged into redelivering a
        poison bundle forever, and a redelivery must dedupe instead of
        partially re-merging."""
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        from paddle_tpu_torch.observability import metrics as _m
        _m.enable()
        agg = self._agg()

        def hist_bundle(proc, bucket):
            r = MetricsRegistry()
            r.histogram("t_fp_seconds", "", buckets=(bucket,)) \
                .observe(bucket / 2)
            return fleet.make_bundle(
                proc, "r", 1,
                metrics_delta=fleet.delta_snapshot(r.snapshot(), None))

        assert not agg.ingest(hist_bundle("pa", 0.1))["rejected_metrics"]
        assert not agg.ingest(hist_bundle("pb", 1.0))["rejected_metrics"]
        poison = hist_bundle("pc", 5.0)
        ack = agg.ingest(poison)
        assert ack["ok"] and ack["rejected_metrics"]
        assert agg.processes()["pc"]["last_seq"] == 1
        assert agg.ingest(poison)["duplicate"]   # redelivery dedupes
        snap = agg.registry.snapshot()
        assert snap["t_fp_seconds"]["series"][("pa",)]["count"] == 1
        assert snap["t_fp_skew_seconds"]["series"][("pb",)]["count"] == 1
        assert ("pc",) not in snap["t_fp_seconds"]["series"]
        assert snap["paddle_tpu_fleet_rejected_bundles_total"][
            "series"][("pc",)] == 1

    def test_heartbeat_staleness(self):
        agg = self._agg(stale_after_s=2.0)
        agg.ingest(self._bundle("pa", 1))
        h = agg.health()
        assert h["pa"]["up"] and h["pa"]["age_s"] < 2.0
        h = agg.health(now=time.time() + 5.0)
        assert not h["pa"]["up"]
        assert _snap_series(
            agg.registry,
            "paddle_tpu_fleet_process_up")[("pa",)] == 0.0
        assert _snap_series(
            agg.registry,
            "paddle_tpu_fleet_heartbeat_age_seconds")[("pa",)] > 2.0

    def test_respawned_process_resets_seq_epoch(self):
        """Crash-restart under a reused process name: the new
        incarnation's agent restarts seq at 1 with a new pid — the
        aggregator must open a new epoch instead of deduping the live
        process into staleness. Merged totals keep both lives'
        history; capacity re-baselines."""
        from paddle_tpu_torch.observability import fleet
        agg = self._agg(stale_after_s=60.0)

        def bundle(seq, pid, n):
            b = self._bundle("pr", seq, {"t_rs_total": n})
            b["heartbeat"]["pid"] = pid
            return b

        agg.ingest(bundle(1, 100, 4))
        agg.ingest(bundle(2, 100, 3))
        assert agg.ingest(bundle(2, 100, 9))["duplicate"]  # same life
        # respawn: same name, new pid, seq restarts at 1
        ack = agg.ingest(bundle(1, 200, 5))
        assert ack["ok"] and not ack.get("duplicate")
        assert agg.processes()["pr"]["last_seq"] == 1
        assert agg.processes()["pr"]["pid"] == 200
        assert _snap_series(agg.registry, "t_rs_total")[("pr",)] == 12
        assert _snap_series(
            agg.registry,
            "paddle_tpu_fleet_process_restarts_total")[("pr",)] == 1
        assert agg.health()["pr"]["up"]

    def test_merge_unknown_kind_and_malformed_value_are_skew(self):
        """A newer-revision peer's unknown metric kind, and a
        non-numeric series value, must surface as MergeSkewError (the
        aggregator's rejected-bundle path), never as a bare
        KeyError/TypeError mid-mutation."""
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        from paddle_tpu_torch.observability import metrics as _m
        _m.enable()
        dst = MetricsRegistry()
        snap = {"t_uk_things": {
            "kind": "summary", "help": "", "labelnames": (),
            "series": {(): 1.0}}}
        with pytest.raises(obs.MergeSkewError, match="unknown metric"):
            dst.merge(snap, on_skew="quarantine")
        bad_val = {"t_bv_total": {
            "kind": "counter", "help": "", "labelnames": (),
            "series": {(): {"not": "a number"}}}}
        with pytest.raises(obs.MergeSkewError, match="not numeric"):
            dst.merge(bad_val)
        # the aggregator converts either into a counted rejection, not
        # a wedge: the seq advances and the agent moves on
        agg = self._agg()
        b = fleet.make_bundle("pu", "r", 1, metrics_delta=snap)
        assert agg.ingest(b)["rejected_metrics"]
        assert agg.processes()["pu"]["last_seq"] == 1

    def test_unknown_bundle_version_rejected(self):
        agg = self._agg()
        with pytest.raises(ValueError, match="fleet bundle"):
            agg.ingest({"v": 99, "process": "pa", "seq": 1})


# ---------------------------------------------------------------------------
# agent shipping over real sockets (agent + aggregator co-located:
# asserts go against the fleet registry, which is feedback-free)
# ---------------------------------------------------------------------------
class TestAgentShipping:
    def test_ship_rollback_and_redelivery(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet
        obs.enable()
        agg = fleet.serve_aggregator()
        c = obs.registry().counter("t_as_total", "")
        agent = fleet.FleetAgent(agg.endpoint, process="p1",
                                 role="replica", interval_s=60.0,
                                 timeout_s=5.0)
        c.inc(5)
        assert agent.ship()
        assert _snap_series(agg.registry, "t_as_total")[("p1",)] == 5
        port = int(agg.endpoint.rsplit(":", 1)[1])
        agg.close()
        c.inc(7)
        assert not agent.ship()     # aggregator gone: rolled back
        assert agent._seq == 1
        fails = obs.snapshot()[
            "paddle_tpu_fleet_agent_ship_failures_total"]["series"][()]
        assert fails == 1
        agg2 = fleet.serve_aggregator(port=port)
        assert agent.ship()         # accumulated delta redelivers
        assert agent._seq == 2
        # the new aggregator sees exactly the un-acknowledged delta
        assert _snap_series(agg2.registry, "t_as_total")[("p1",)] == 7
        agg2.close()

    def test_heartbeat_only_when_disabled(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet
        assert not obs.enabled()
        agg = fleet.serve_aggregator()
        agent = fleet.FleetAgent(agg.endpoint, process="poff",
                                 role="replica", interval_s=60.0)
        assert agent.ship()
        procs = agg.processes()
        assert procs["poff"]["last_seq"] == 1
        # no series shipped: the fleet registry holds only the
        # aggregator's own bookkeeping (fleet health + the cross-rank
        # collective attribution gauges it publishes itself)
        names = set(agg.registry.snapshot())
        assert all(n.startswith("paddle_tpu_fleet_")
                   or n.startswith("paddle_tpu_collective_")
                   for n in names)
        agg.close()

    def test_ring_rotation_drops_are_counted(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet, tracing
        obs.enable()
        tracing.set_capacity(8)
        agg = fleet.serve_aggregator()
        agent = fleet.FleetAgent(agg.endpoint, process="pr",
                                 role="replica", interval_s=60.0)
        for i in range(30):
            tracing.add_event("t.ring_spam", float(i), 1.0)
        assert agent.ship()
        dropped = obs.snapshot()[
            "paddle_tpu_fleet_agent_dropped_events_total"]["series"]
        assert dropped[("ring",)] == 22      # 30 recorded, ring kept 8
        agg.close()

    def test_outbound_buffer_overflow_counted(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet, tracing
        obs.enable()
        agent = fleet.FleetAgent("127.0.0.1:1", process="pb",
                                 role="replica", interval_s=60.0,
                                 buffer_events=4, timeout_s=0.2)
        for i in range(6):
            tracing.add_event("t.buf_spam", float(i), 1.0)
        assert not agent.ship()      # nothing listens on port 1
        dropped = obs.snapshot()[
            "paddle_tpu_fleet_agent_dropped_events_total"]["series"]
        assert dropped[("buffer",)] == 2
        # the surviving 4 moved into the frozen pending bundle; the
        # buffer now accumulates toward the NEXT bundle
        assert len(agent._buffer) == 0
        assert len(agent._pending[0]["trace"]) == 4

    def test_lost_ack_redelivery_commits_without_double_or_loss(self):
        """Merged-but-ack-lost: the retry redelivers the FROZEN bundle
        verbatim, the aggregator dedupes it, and the agent commits on
        the duplicate-ack — nothing double-merges and nothing grown
        between attempts is lost."""
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet
        obs.enable()
        agg = fleet.serve_aggregator()
        c = obs.registry().counter("t_ack_total", "")
        agent = fleet.FleetAgent(agg.endpoint, process="pl",
                                 role="replica", interval_s=60.0,
                                 timeout_s=5.0)
        c.inc(5)
        # attempt 1: the send "fails" after the aggregator merged it
        # (lost ack) — simulated by freezing the bundle via a dead
        # transport, then delivering that exact bundle out of band
        real_rpc = fleet._rpc
        fleet._rpc = lambda: (_ for _ in ()).throw(
            ConnectionError("chaos"))
        try:
            assert not agent.ship()
        finally:
            fleet._rpc = real_rpc
        fleet._ingest_bundle(agent._pending[0])
        c.inc(7)                     # grows between attempts
        assert agent.ship()          # redelivery -> duplicate-ack
        assert agent._seq == 1 and agent._pending is None
        assert _snap_series(agg.registry, "t_ack_total")[("pl",)] == 5
        assert agent.ship()          # next bundle carries the growth
        assert _snap_series(agg.registry, "t_ack_total")[("pl",)] == 12
        assert _snap_series(
            agg.registry,
            "paddle_tpu_fleet_duplicate_bundles_total")[("pl",)] == 1
        agg.close()

    def test_custom_registry_agent_self_accounts_in_it(self):
        """An agent shipping a custom registry keeps its own
        shipped/failures/dropped counters THERE — the plane observes
        itself in whichever store it ships."""
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        obs.enable()
        reg = MetricsRegistry()
        agent = fleet.FleetAgent("127.0.0.1:1", process="pc", role="r",
                                 interval_s=60.0, timeout_s=0.2,
                                 registry=reg)
        assert not agent.ship()
        assert _snap_series(
            reg, "paddle_tpu_fleet_agent_ship_failures_total")[()] == 1
        assert "paddle_tpu_fleet_agent_ship_failures_total" not in \
            obs.snapshot() or obs.snapshot()[
                "paddle_tpu_fleet_agent_ship_failures_total"][
                    "series"].get((), 0) == 0

    def test_background_thread_and_farewell(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import fleet
        obs.enable()
        agg = fleet.serve_aggregator()
        c = obs.registry().counter("t_bg_total", "")
        agent = fleet.FleetAgent(agg.endpoint, process="pt",
                                 role="replica", interval_s=0.1)
        agent.start()
        c.inc(2)
        deadline = time.time() + 10.0
        while time.time() < deadline:
            s = agg.registry.snapshot().get("t_bg_total")
            if s and s["series"].get(("pt",)) == 2:
                break
            time.sleep(0.05)
        c.inc(4)                    # lands via the stop() farewell
        agent.stop()
        assert _snap_series(agg.registry, "t_bg_total")[("pt",)] == 6
        agg.close()


# ---------------------------------------------------------------------------
# capacity ledger + obs_top fleet panel
# ---------------------------------------------------------------------------
def _capacity_agg(tok_pa=500.0, tok_pb=250.0):
    """Aggregator with two replica processes' worth of engine counters
    over a ~10s reporting window. Rates measure growth past the FIRST
    bundle, so a heartbeat-only bundle establishes the zero baseline
    and a second bundle carries the work."""
    from paddle_tpu_torch.observability import MetricsRegistry, fleet
    from paddle_tpu_torch.observability import metrics as _m
    from paddle_tpu_torch.observability.fleet import FleetAggregator
    _m.enable()
    agg = FleetAggregator(stale_after_s=60.0)
    for proc, tok in (("pa", tok_pa), ("pb", tok_pb)):
        agg.ingest(fleet.make_bundle(proc, "replica", 1))
        src = MetricsRegistry()
        src.counter("paddle_tpu_engine_events_total", "t",
                    ("event",)).labels(event="decode_tokens").inc(tok)
        src.counter("paddle_tpu_request_finished_total", "t",
                    ("reason",)).labels(reason="eos").inc(tok / 50)
        src.gauge("paddle_tpu_roofline_utilization", "t",
                  ("family", "bound")).labels(
            family="engine_ragged", bound="hbm").set(0.42)
        src.gauge("paddle_tpu_engine_queue_depth", "t",
                  ("queue",)).labels(queue="running").set(3)
        agg.ingest(fleet.make_bundle(
            proc, "replica", 2,
            metrics_delta=fleet.delta_snapshot(src.snapshot(), None)))
        agg._procs[proc]["first_seen"] -= 10.0   # give rates a window
    return agg


class TestCapacityLedger:
    def test_capacity_records(self):
        agg = _capacity_agg()
        recs = {r["process"]: r for r in agg.capacity_records()}
        pa = recs["pa"]
        assert pa["process_role"] == "replica"
        assert pa["tokens_total"] == 500.0
        assert pa["tok_per_s"] == pytest.approx(50.0, rel=0.2)
        assert pa["req_per_s"] == pytest.approx(1.0, rel=0.2)
        assert pa["utilization_hbm"] == 0.42
        assert recs["pb"]["tok_per_s"] == pytest.approx(25.0, rel=0.2)

    def test_first_bundle_history_excluded_from_rates(self):
        """A process whose first bundle carries a long pre-agent
        history must not have that history rated over the inter-bundle
        window (it would inflate req/s / tok/s by orders of magnitude
        — the exact number the elastic scaler sizes fleets from)."""
        from paddle_tpu_torch.observability import MetricsRegistry, fleet
        from paddle_tpu_torch.observability import metrics as _m
        from paddle_tpu_torch.observability.fleet import FleetAggregator
        _m.enable()
        agg = FleetAggregator(stale_after_s=60.0)
        src = MetricsRegistry()
        tokc = src.counter("paddle_tpu_engine_events_total", "t",
                           ("event",)).labels(event="decode_tokens")
        tokc.inc(10000)             # pre-agent history
        base = src.snapshot()
        agg.ingest(fleet.make_bundle(
            "ph", "replica", 1,
            metrics_delta=fleet.delta_snapshot(base, None)))
        tokc.inc(100)               # actual in-window work
        agg.ingest(fleet.make_bundle(
            "ph", "replica", 2,
            metrics_delta=fleet.delta_snapshot(src.snapshot(), base)))
        agg._procs["ph"]["first_seen"] -= 10.0
        rec = agg.capacity_records()[0]
        assert rec["tokens_total"] == 10100.0    # totals keep history
        assert rec["tok_per_s"] == pytest.approx(10.0, rel=0.2)



def test_aggregators_merge_the_same_bundles_equally():
    """The same bundle sequence (two processes, a redelivery, a respawn,
    a histogram) into the reference's aggregator and the port's: equal
    merged series and equal process records (timestamps aside)."""
    import paddle_tpu.observability.fleet as jfleet
    import paddle_tpu.observability.metrics as jm
    from paddle_tpu_torch.observability import fleet as tfleet
    from paddle_tpu_torch.observability import metrics as tm
    jm.enable()
    tm.enable()
    try:
        src = jm.MetricsRegistry()
        c = src.counter("t_tw_total", "t", ("event",))
        h = src.histogram("t_tw_seconds", "t", buckets=(0.1, 1.0))
        bundles, base = [], None
        for seq, (n, obs_) in enumerate(((3, 0.05), (4, 0.5), (0, 2.0)), 1):
            c.labels(event="a").inc(n)
            h.observe(obs_)
            cur = src.snapshot()
            bundles.append(jfleet.make_bundle(
                "pa", "engine", seq,
                metrics_delta=jfleet.delta_snapshot(cur, base)))
            base = cur
        bundles.append(dict(bundles[1]))            # redelivery
        bundles.append(jfleet.make_bundle("pb", "router", 1))
        respawn = jfleet.make_bundle("pa", "engine", 1, metrics_delta=(
            jfleet.delta_snapshot(src.snapshot(), None)))
        respawn["heartbeat"]["pid"] = -1
        bundles.append(respawn)
        out = {}
        for name, mod in (("ref", jfleet), ("port", tfleet)):
            agg = mod.FleetAggregator(stale_after_s=60.0)
            acks = [agg.ingest(b) for b in bundles]
            procs = {p: {k: v for k, v in st.items()
                         if k not in ("first_seen", "last_seen")}
                     for p, st in agg.processes().items()}
            out[name] = (acks, procs, agg.registry.snapshot())
        assert out["port"] == out["ref"]
    finally:
        jm.disable()
        tm.disable()


def test_port_agent_ships_to_a_reference_aggregator():
    """One wire format: a port FleetAgent's bundle lands in the
    reference's aggregator (served by the reference's RPC layer)."""
    import paddle_tpu.observability.fleet as jfleet
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import fleet
    obs.enable()
    agg = jfleet.serve_aggregator()
    try:
        obs.registry().counter("t_xp_total", "").inc(9)
        agent = fleet.FleetAgent(agg.endpoint, process="port-1",
                                 role="engine", interval_s=60.0,
                                 timeout_s=10.0)
        # the frame names the port's _ingest_bundle, which looks for an
        # aggregator in the serving process: the reference's serves
        # there, so the port's ingest target is pointed at it
        fleet._AGGREGATOR = agg
        try:
            assert agent.ship()
        finally:
            fleet._AGGREGATOR = None
        assert agg.registry.snapshot()["t_xp_total"]["series"][
            ("port-1",)] == 9
        assert agg.processes()["port-1"]["role"] == "engine"
    finally:
        agg.close()
