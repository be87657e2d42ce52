"""paddle.distributed.rpc (counterpart of paddle_tpu/distributed/rpc/,
the same frames and the same surface).

RPC is a host-side control-plane feature (parameter queries,
coordination, light-weight remote calls); device data never moves over
it. The transport is plain TCP sockets + pickle on the host NIC, with a
master-endpoint rendezvous. The frames (8-byte length, HMAC-SHA256 tag,
pickled body) and the token rule (``PADDLE_RPC_TOKEN``, else one derived
from ``PADDLE_MASTER``) are the reference's, so a port process and a
reference process that share a token can call each other.

Surface: init_rpc / rpc_sync / rpc_async / get_worker_info /
get_all_worker_infos / get_current_worker_info / shutdown.

Beyond parity (the fleet observability plane rides this layer):

* **Rendezvous-free serving.** `serve()` starts a standalone call
  server (same HMAC frames, same handler) and `call_endpoint()` talks
  straight to an ``ip:port`` — no world_size, no master. The fleet
  obs aggregator serves this way so fleet membership stays elastic.
* **Trace stitching.** Call frames carry the caller's ambient trace
  context; the server handler adopts it, so a request crossing
  processes renders as ONE connected chrome-trace tree — the client's
  `rpc.client` span and the server's `rpc.server` span share a
  trace_id (stitched once the server's events ship to an aggregator
  or exporter). RPC also reports itself: client/server latency
  histograms and request counters (see README series table).
* **Counted rejections.** Frames failing HMAC auth (or truncated
  mid-frame) increment `paddle_tpu_rpc_rejected_frames_total{reason=
  bad_mac|short_frame}` and log the peer address — auth misconfig and
  network flake are distinguishable instead of silently dropped.
"""
from __future__ import annotations

import logging
import os
import pickle
import socket
import socketserver
import struct
import threading
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = 120.0

_log = logging.getLogger("paddle_tpu_torch.distributed.rpc")


class RpcAuthError(ConnectionError):
    """Frame failed HMAC authentication (wrong/missing token)."""


class RpcShortFrame(ConnectionError):
    """Peer closed mid-frame (truncated length/mac/payload)."""


# lazy observability handles: rpc must stay importable without pulling
# the observability package at module import (and the disabled-mode
# path through every recorder below is a flag check on these handles)
_OBS = None


def _obs():
    global _OBS
    if _OBS is None:
        from ...observability import metrics as _m
        from ...observability import tracing as _t
        r = _m.registry()
        _OBS = {
            "m": _m, "t": _t,
            "client": r.histogram(
                "paddle_tpu_rpc_client_seconds",
                "caller-side wall time of one RPC round trip "
                "(connect + send + remote execution + receive)"),
            "server": r.histogram(
                "paddle_tpu_rpc_server_seconds",
                "server-side wall time of one remote call's handler "
                "execution"),
            "requests": r.counter(
                "paddle_tpu_rpc_requests_total",
                "RPC calls by side (client|server) and terminal "
                "status: ok, err (remote exception shipped back), "
                "net_error (transport failed before a reply)",
                ("side", "status")),
            "rejected": r.counter(
                "paddle_tpu_rpc_rejected_frames_total",
                "inbound frames dropped before unpickling: bad_mac = "
                "HMAC authentication failure (token misconfig or a "
                "hostile peer), short_frame = peer closed mid-frame "
                "(network flake, port scan); peer address is logged "
                "at warning level",
                ("reason",)),
            "retries": r.counter(
                "paddle_tpu_rpc_retries_total",
                "call_endpoint transport-failure retry accounting: "
                "retried = one re-attempt after a ConnectionError/"
                "timeout (backoff applied first), gave_up = retry "
                "budget exhausted and the last transport error "
                "propagated to the caller. Remote exceptions (status "
                "err) are a successful round trip and are never "
                "retried",
                ("outcome",)),
        }
    return _OBS


def _rpc_token() -> bytes:
    """Shared HMAC key authenticating every RPC frame before unpickling
    (plain pickle over TCP is remote code execution for any peer that can
    reach the port). A launcher generates a random token
    and injects PADDLE_RPC_TOKEN into every rank's env; standalone jobs
    without one fall back to a master-endpoint-derived key, which only
    keeps out stray traffic — set PADDLE_RPC_TOKEN for real isolation.
    A spawned serving replica (`inference.replica_proc`) does not rely
    on it: without PADDLE_RPC_TOKEN its parent draws a random key for
    it (`_serve(token=)`)."""
    tok = os.environ.get("PADDLE_RPC_TOKEN", "")
    if tok:
        return tok.encode()
    seed = os.environ.get("PADDLE_MASTER", "127.0.0.1:29431")
    return ("paddle-tpu-rpc:" + seed).encode()

_server = None
_server_thread = None
_executor = None
_workers: dict = {}
_current: WorkerInfo = None
_master_sock = None


def _send_msg(sock, obj, token=None):
    """One frame signed with `token` (bytes; None = `_rpc_token()`)."""
    import hmac as _hmac
    import hashlib
    payload = pickle.dumps(obj)
    mac = _hmac.new(token or _rpc_token(), payload, hashlib.sha256).digest()
    sock.sendall(struct.pack("!Q", len(payload)) + mac + payload)


def _recv_msg(sock, token=None):
    import hmac as _hmac
    import hashlib

    def read_exact(n, what):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                raise RpcShortFrame(f"rpc peer closed {what}")
            buf += chunk
        return buf

    (n,) = struct.unpack("!Q", read_exact(8, ""))
    mac = read_exact(32, "mid-mac")
    buf = read_exact(n, "mid-message")
    want = _hmac.new(token or _rpc_token(), buf, hashlib.sha256).digest()
    if not _hmac.compare_digest(mac, want):
        # authenticate BEFORE unpickling: reject unauthenticated peers
        # without ever deserializing their payload
        raise RpcAuthError("rpc frame failed HMAC authentication")
    return pickle.loads(buf)


def _count_rejected(exc: ConnectionError, peer) -> None:
    """Account an inbound frame the handler refused: counted metric +
    peer-address log instead of a silent drop, so fleet debugging can
    tell auth misconfig from network flake. Counting bypasses the
    enabled flag (SLO-breach precedent): security accounting must not
    depend on hot-path recording being on."""
    reason = "bad_mac" if isinstance(exc, RpcAuthError) else "short_frame"
    try:
        _obs()["rejected"].labels(reason=reason)._value += 1
    except Exception:
        pass
    addr = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) \
        and len(peer) >= 2 else repr(peer)
    _log.warning("rpc frame rejected (%s) from %s: %s",
                 reason, addr, exc)


class _RpcHandler(socketserver.BaseRequestHandler):
    def handle(self):
        # a server made by `_serve(token=)` answers only frames signed
        # with its own key, and signs its replies with it
        token = getattr(self.server, "token", None)
        try:
            kind, body = _recv_msg(self.request, token)
        except (RpcAuthError, RpcShortFrame) as e:
            _count_rejected(e, self.client_address)
            return
        except ConnectionError:
            return
        if kind == "call":
            # frames are (fn, args, kwargs) pre-trace-context peers or
            # (fn, args, kwargs, ctx) — ctx is the caller's
            # (trace_id, span_id), adopted here so the server-side
            # span joins the caller's tree (one connected cross-process
            # trace once these events reach a common exporter)
            fn, args, kwargs = body[0], body[1], body[2]
            ctx = body[3] if len(body) > 3 else None
            o = _obs()
            t0 = time.perf_counter()
            adopt = sp = None
            if ctx is not None and o["t"].enabled():
                adopt = o["t"].trace_context(ctx[0], ctx[1])
                adopt.__enter__()
                sp = o["t"].span("rpc.server",
                                 fn=getattr(fn, "__name__", "?"))
                sp.__enter__()
            try:
                result = ("ok", fn(*args, **kwargs))
            except Exception as e:  # ship the exception back
                result = ("err", e)
            finally:
                if sp is not None:
                    sp.end()
                if adopt is not None:
                    adopt.__exit__(None, None, None)
            if o["m"]._ENABLED:
                o["server"].observe(time.perf_counter() - t0)
                o["requests"].labels(side="server",
                                     status=result[0]).inc()
            try:
                _send_msg(self.request, result, token)
            except Exception:
                # unpicklable payload/exception: degrade to a summary so
                # the caller sees the real failure, not a ConnectionError
                import traceback
                if result[0] == "err":
                    summary = RuntimeError(
                        f"remote {type(result[1]).__name__}: {result[1]}\n"
                        + "".join(traceback.format_exception(result[1])))
                else:
                    summary = RuntimeError(
                        "rpc result is not picklable: "
                        f"{type(result[1]).__name__}")
                _send_msg(self.request, ("err", summary), token)
        elif kind == "ping":
            _send_msg(self.request, ("ok", None), token)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


# ---------------- master-side rendezvous (rank 0) ----------------

class _MasterHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        kind, body = _recv_msg(self.request)
        if kind == "register":
            with srv.lock:
                srv.infos[body.rank] = body
                srv.cond.notify_all()
        elif kind == "wait_all":
            world = body
            with srv.lock:
                while len(srv.infos) < world:
                    srv.cond.wait(timeout=1.0)
            _send_msg(self.request, ("ok", dict(srv.infos)))
            return
        elif kind == "barrier":
            # rank-keyed set, NOT a counter: _master_call retries after a
            # socket timeout, and a re-sent arrival must be idempotent
            key, world, rank = body
            with srv.lock:
                srv.barriers.setdefault(key, set()).add(rank)
                srv.cond.notify_all()
                while len(srv.barriers[key]) < world:
                    srv.cond.wait(timeout=1.0)
            _send_msg(self.request, ("ok", None))
            return
        _send_msg(self.request, ("ok", None))


def _master_call(endpoint, kind, body, retries=60):
    ip, port = endpoint.rsplit(":", 1)
    last = None
    for _ in range(retries):
        try:
            with socket.create_connection((ip, int(port)), timeout=30) as s:
                _send_msg(s, (kind, body))
                status, payload = _recv_msg(s)
                if status != "ok":
                    raise payload
                return payload
        except (ConnectionError, OSError) as e:
            last = e
            time.sleep(0.5)
    raise ConnectionError(f"cannot reach rpc master at {endpoint}: {last}")


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Start this worker's RPC server and rendezvous with the group
    (ref: rpc.py:73). Defaults come from the launch CLI's env
    (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER)."""
    global _server, _server_thread, _executor, _workers, _current, \
        _master_sock
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else world_size
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER", "127.0.0.1:29431")

    if rank == 0:
        ip, port = master_endpoint.rsplit(":", 1)
        master = _Server((ip, int(port)), _MasterHandler)
        master.infos = {}
        master.barriers = {}
        master.lock = threading.Lock()
        master.cond = threading.Condition(master.lock)
        t = threading.Thread(target=master.serve_forever, daemon=True)
        t.start()
        _master_sock = master

    # bind to the interface peers actually use (loopback for single-host
    # jobs) instead of 0.0.0.0: the RPC port is not exposed on every
    # interface, and a one-worker group resolves no host name
    host_ip = (socket.gethostbyname(socket.gethostname())
               if world_size > 1 else "127.0.0.1")
    bind_ip = host_ip
    _server = _Server((bind_ip, 0), _RpcHandler)
    port = _server.server_address[1]
    _server_thread = threading.Thread(target=_server.serve_forever,
                                      daemon=True)
    _server_thread.start()
    _executor = ThreadPoolExecutor(max_workers=8)
    me = WorkerInfo(name, rank, host_ip, port)
    _master_call(master_endpoint, "register", me)
    infos = _master_call(master_endpoint, "wait_all", world_size)
    _workers = {info.name: info for info in infos.values()}
    _current = me
    _workers.setdefault(name, me)
    globals()["_master_endpoint"] = master_endpoint
    globals()["_world_size"] = world_size


def _call_endpoint(ip, port, fn, args, kwargs, timeout, to=None,
                   token=None):
    """One authenticated call frame to ip:port — the shared client
    path under rpc_sync/rpc_async (named workers) and call_endpoint
    (rendezvous-free peers like the fleet obs aggregator). Ships the
    ambient trace context so the server-side span joins the caller's
    tree; records the client latency histogram + request counter.
    `token`: the peer's own key (a `_serve(token=)` server), None =
    `_rpc_token()`."""
    o = _obs()
    sp = None
    ctx = None
    if o["t"].enabled():
        sp = o["t"].span("rpc.client",
                         fn=getattr(fn, "__name__", "?"),
                         to=to if to is not None else f"{ip}:{port}")
        sp.__enter__()
        ctx = (sp.trace_id, sp.span_id)
    t0 = time.perf_counter()
    status = "net_error"
    # untraced calls keep the legacy 3-tuple frame: a caller without
    # trace context stays wire-compatible with a server running the
    # pre-trace-context revision (mixed-revision fleets are exactly
    # what the skew machinery upstream exists for)
    body = (fn, tuple(args or ()), dict(kwargs or {}))
    if ctx is not None:
        body = body + (ctx,)
    try:
        with socket.create_connection((ip, int(port)),
                                      timeout=timeout or None) as s:
            _send_msg(s, ("call", body), token)
            status, payload = _recv_msg(s, token)
    finally:
        if sp is not None:
            sp.end()
        if o["m"]._ENABLED:
            o["client"].observe(time.perf_counter() - t0)
            o["requests"].labels(side="client", status=status).inc()
    if status == "err":
        raise payload
    return payload


def _invoke(to, fn, args, kwargs, timeout):
    info = _workers.get(to)
    if info is None:
        raise ValueError(f"unknown rpc worker {to!r}; known: "
                         f"{sorted(_workers)}")
    return _call_endpoint(info.ip, info.port, fn, args, kwargs,
                          timeout, to=to)


def call_endpoint(endpoint, fn, args=None, kwargs=None,
                  timeout=_DEFAULT_RPC_TIMEOUT, retries=0,
                  backoff_s=0.05, backoff_max_s=2.0):
    """Blocking call straight to an `ip:port` (string or (ip, port)
    tuple) without group rendezvous — the peer just needs a serve()d
    call handler and the same HMAC token. Remote exceptions
    propagate like rpc_sync.

    Supervisor-grade hardening: `timeout` bounds EVERY socket
    operation of one attempt (connect, send, receive — a wedged peer
    that accepts but never answers raises socket.timeout instead of
    hanging the caller), and `retries` re-attempts are made after
    transport failures only, sleeping a bounded exponential backoff
    (backoff_s doubling up to backoff_max_s) between attempts. A
    remote exception shipped back as status "err" is a SUCCESSFUL
    round trip and always propagates immediately — retrying it would
    re-execute a non-idempotent call. Accounting lands on
    `paddle_tpu_rpc_retries_total{outcome=retried|gave_up}`."""
    if isinstance(endpoint, str):
        ip, port = endpoint.rsplit(":", 1)
    else:
        ip, port = endpoint
    delay = backoff_s
    attempts_left = max(0, int(retries))
    while True:
        try:
            return _call_endpoint(ip, int(port), fn, args, kwargs,
                                  timeout)
        except (ConnectionError, socket.timeout, OSError) as e:
            o = _obs()
            if attempts_left <= 0:
                if retries:
                    try:
                        o["retries"].labels(outcome="gave_up") \
                            ._value += 1
                    except Exception:
                        pass
                raise
            attempts_left -= 1
            try:
                o["retries"].labels(outcome="retried")._value += 1
            except Exception:
                pass
            _log.warning("rpc call_endpoint to %s:%s failed (%s); "
                         "retrying in %.3fs (%d attempts left)",
                         ip, port, e, delay, attempts_left)
            time.sleep(delay)
            delay = min(delay * 2, backoff_max_s)


def serve(bind: str = "127.0.0.1", port: int = 0):
    """Start a standalone call server (same frames, same handler as
    init_rpc's, no rendezvous). Returns (server, "ip:port"); stop it
    with server.shutdown(); server.server_close()."""
    return _serve(bind, port)


def _serve(bind="127.0.0.1", port=0, token=None):
    """`serve`, answering only frames signed with `token` (bytes) when
    one is given: a server whose key its owner made and shares with its
    callers alone (a spawned replica's, `inference.replica_proc`), not
    the key `_rpc_token()` derives from the environment."""
    srv = _Server((bind, int(port)), _RpcHandler)
    srv.token = token
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    ip, p = srv.server_address[:2]
    return srv, f"{ip}:{p}"


def rpc_sync(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """Blocking remote call (ref: rpc.py:143)."""
    return _invoke(to, fn, args, kwargs, timeout)


class _Future:
    def __init__(self, fut):
        self._fut = fut

    def wait(self, timeout=None):
        return self._fut.result(timeout=timeout)

    def done(self):
        return self._fut.done()


def rpc_async(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """Non-blocking remote call returning a future with .wait()
    (ref: rpc.py:183). The caller's contextvars snapshot rides to the
    executor thread, so the ambient trace context stitches the async
    call into the caller's tree exactly like rpc_sync — without it the
    rpc.client span would start a fresh, disconnected trace."""
    import contextvars
    ctx = contextvars.copy_context()
    return _Future(_executor.submit(
        ctx.run, _invoke, to, fn, args, kwargs, timeout))


def get_worker_info(name):
    return _workers[name]


def get_all_worker_infos():
    return sorted(_workers.values(), key=lambda w: w.rank)


def get_current_worker_info():
    return _current


def shutdown(graceful: bool = True):
    """Barrier, then stop the local server (ref: rpc.py:278).
    graceful=False skips the group barrier — for teardown paths where
    peers may already be dead (a chaos kill) and waiting on every rank
    would hang forever."""
    global _server, _executor, _master_sock
    if graceful and _current is not None:
        _master_call(globals()["_master_endpoint"], "barrier",
                     ("shutdown", globals()["_world_size"], _current.rank))
    if _executor is not None:
        _executor.shutdown(wait=True)
        _executor = None
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
    globals()["_current"] = None
    if _master_sock is not None:
        _master_sock.shutdown()
        _master_sock.server_close()
        _master_sock = None
    _workers.clear()
