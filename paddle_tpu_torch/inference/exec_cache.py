"""Persistent store of built kernel libraries for the serving engine
(counterpart of paddle_tpu/inference/exec_cache.py).

The reference parks XLA executables on disk so a crash-restarted replica
reintegrates warm instead of recompiling. The port's executables are
the kernel libraries `utils/build.py` builds with nvcc and g++ (B3, the
block allocator, ...); its CUDA graphs live in one process and are
captured again on a warm start. This module keeps the reference's
guarantees and its API over those libraries:

* a warm start builds nothing: an `LLMEngine` given `exec_cache_dir=`
  hands `utils.build.build_shared` a `LibraryStore` (this store, keyed
  by the engine's device fingerprint) when it loads its libraries, and
  a hit writes the stored library into the build directory and loads
  it with no compiler run. Only the loads handed a store consult one;
  a library this process has loaded already is not loaded again;
* a stale, corrupt, torn or foreign entry degrades silently to a build:
  `load()` never raises and never returns a payload whose manifest,
  checksum or device fingerprint fails verification. A build that fails
  still raises;
* writes are atomic: payload staged, fsynced and renamed first, the JSON
  manifest LAST, so the manifest's presence is the commit point.

Store layout (flat directory)::

    <root>/<key>.exec   the library's bytes
    <root>/<key>.json   manifest: schema, family, byte count, payload
                        sha256, device fingerprint, timestamps

Outcomes land on `paddle_tpu_compile_total{family,outcome=disk_hit|
compile}` (`LibraryStore`, through `observability.perf.note_build`)."""
from __future__ import annotations

import hashlib
import json
import os
import platform
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..utils.fs import fsync_dir

__all__ = [
    "ExecCache", "fingerprint", "device_fingerprint",
    "code_fingerprint", "SCHEMA_VERSION", "ENV_DIR", "default_dir",
]

SCHEMA_VERSION = 1
#: environment variable naming the default store directory; when unset
#: the engine runs without a persistent cache.
ENV_DIR = "PADDLE_TPU_EXEC_CACHE"

_PAYLOAD_EXT = ".exec"
_MANIFEST_EXT = ".json"


def default_dir() -> Optional[str]:
    """The store directory named by ``PADDLE_TPU_EXEC_CACHE`` (or None:
    persistent caching disabled)."""
    d = os.environ.get(ENV_DIR)
    return d or None


def _plain(v):
    """Coerce key parts to canonical-JSON-safe plain data. Tuples
    become lists; any type without a stable value representation is a
    TypeError (never fall back to repr())."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, bytes):
        return "hex:" + v.hex()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(
                    "exec-cache key part has non-string dict key: "
                    + type(k).__name__)
            out[k] = _plain(x)
        return out
    raise TypeError(
        "exec-cache key part of unstable type " + type(v).__name__
        + " — keys must be built from plain value-comparable data")


def fingerprint(parts: Dict[str, Any]) -> str:
    """sha256 hex digest of the canonical JSON encoding of `parts`: the
    on-disk key. Structurally equal parts land on the same entry in any
    process; an unstable component raises."""
    blob = json.dumps(_plain(parts), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def device_fingerprint(mesh=None, *, device=None) -> Dict[str, Any]:
    """Structural identity of what a library was built for: the torch
    and CUDA versions, the host machine, and the card (its name and
    compute capability) unless `device` names the CPU or no card is
    present. An entry whose fingerprint differs from the loader's is
    FOREIGN and is never used. `mesh` (a sharded engine's sub-mesh) is
    not ported yet."""
    import torch

    if mesh is not None:
        raise NotImplementedError(
            "device_fingerprint(mesh=...): sharded engines are not ported "
            "yet")
    fp: Dict[str, Any] = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "device_name": "cpu",
        "capability": None,
    }
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        idx = dev.index if dev is not None and dev.index is not None \
            else torch.cuda.current_device()
        fp["device_name"] = torch.cuda.get_device_name(idx)
        fp["capability"] = list(torch.cuda.get_device_capability(idx))
    return fp


_CODE_FP_LOCK = threading.Lock()
_CODE_FP: Optional[str] = None
_CODE_EXTS = (".py", ".cu", ".cuh", ".cpp", ".h")


def code_fingerprint() -> str:
    """sha256 over every source file (.py, .cu, .cuh, .cpp, .h) of the
    paddle_tpu_torch package, computed once per process. A library's
    own key hashes its sources already (`utils.build`); this one changes
    with any source of the package."""
    global _CODE_FP
    with _CODE_FP_LOCK:
        if _CODE_FP is not None:
            return _CODE_FP
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for dirpath, dirnames, files in sorted(os.walk(pkg)):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__")
            for fn in sorted(files):
                if not fn.endswith(_CODE_EXTS):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), pkg)
                h.update(rel.encode("utf-8"))
                h.update(b"\0")
                try:
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        h.update(f.read())
                except OSError:
                    h.update(b"<unreadable>")
                h.update(b"\0")
        _CODE_FP = h.hexdigest()
        return _CODE_FP


def library_key(name: str, tag: str, device: Dict[str, Any]) -> str:
    """The store key of one built library: its name, the build's tag (a
    hash of its sources, headers, compiler and flags) and the device
    fingerprint it is built for."""
    return fingerprint({"schema": SCHEMA_VERSION, "kind": "library",
                        "name": name, "tag": tag, "device": device})


class LibraryStore:
    """What `utils.build.build_shared(store=)` asks: the libraries of
    an `ExecCache` built for the device fingerprint `device`, each
    lookup and save recorded as outcome "disk_hit" or "compile" on
    `paddle_tpu_compile_total` under the library's name."""

    def __init__(self, cache: "ExecCache", device: Dict[str, Any]):
        self.cache = cache
        self.device = device

    def fetch(self, name: str, tag: str) -> Optional[bytes]:
        """The stored library `name` built from `tag` (a hash of its
        sources, headers, compiler and flags), or None."""
        from ..observability import perf
        t0 = time.perf_counter()
        blob = self.cache.load(library_key(name, tag, self.device),
                               device=self.device)
        if blob is not None:
            perf.note_build(name, "disk_hit", time.perf_counter() - t0)
        return blob

    def keep(self, name: str, tag: str, blob: bytes,
             seconds: float) -> None:
        """Save a library just compiled (in `seconds`)."""
        from ..observability import perf
        self.cache.save(library_key(name, tag, self.device), blob,
                        family=name, device=self.device)
        perf.note_build(name, "compile", seconds)


_KEY_OK = frozenset("0123456789abcdef")


def _valid_key(key: str) -> bool:
    return (isinstance(key, str) and 8 <= len(key) <= 128
            and set(key) <= _KEY_OK)


class ExecCache:
    """On-disk library store. Exception-free at the load path: anything
    wrong with an entry (torn write, bit rot, schema drift, another
    device) counts as a miss. `stats()` exposes plain counters so
    callers and tests can pin WHY a load missed."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.counters = {
            "hits": 0, "misses": 0, "corrupt": 0, "foreign": 0,
            "saves": 0, "save_errors": 0,
        }

    # -- paths ---------------------------------------------------------
    def _payload_path(self, key: str) -> str:
        return os.path.join(self.root, key + _PAYLOAD_EXT)

    def _manifest_path(self, key: str) -> str:
        return os.path.join(self.root, key + _MANIFEST_EXT)

    def _bump(self, name: str) -> None:
        with self._lock:
            self.counters[name] += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    # -- write path ----------------------------------------------------
    def save(self, key: str, compiled: bytes, *, family: str = "",
             device: Optional[Dict[str, Any]] = None) -> bool:
        """Store `compiled` (a built library's bytes) under `key`.
        Atomic: payload staged, fsynced and renamed first, manifest LAST
        — a crash at any point leaves either no entry or a complete one.
        Returns False (never raises) when IO fails."""
        if not _valid_key(key) or not isinstance(compiled, bytes):
            self._bump("save_errors")
            return False
        try:
            manifest = {
                "schema": SCHEMA_VERSION,
                "key": key,
                "family": family,
                "payload_bytes": len(compiled),
                "payload_sha256": hashlib.sha256(compiled).hexdigest(),
                "device": _plain(device if device is not None
                                 else device_fingerprint()),
                "created_unix": time.time(),
            }
            self._commit(key, compiled, manifest)
        except Exception:
            self._bump("save_errors")
            return False
        self._bump("saves")
        return True

    def _commit(self, key: str, blob: bytes, manifest: dict) -> None:
        suffix = ".tmp-%d-%s" % (os.getpid(), uuid.uuid4().hex[:8])
        ptmp = self._payload_path(key) + suffix
        mtmp = self._manifest_path(key) + suffix
        try:
            with open(ptmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(ptmp, self._payload_path(key))
            with open(mtmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, self._manifest_path(key))
            fsync_dir(self.root)
        except BaseException:
            for t in (ptmp, mtmp):
                try:
                    os.unlink(t)
                except OSError:
                    pass
            raise

    # -- read path -----------------------------------------------------
    def _read_verified(self, key: str, device
                       ) -> Tuple[Optional[bytes], str]:
        """(payload, '') when the entry verifies, else (None, reason):
        one of missing/corrupt/foreign with detail. The payload is read
        once, so what was checked is what is returned."""
        if not _valid_key(key):
            return None, "corrupt: malformed key"
        try:
            with open(self._manifest_path(key), "r",
                      encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None, "missing: no readable manifest"
        if not isinstance(manifest, dict) or \
                manifest.get("schema") != SCHEMA_VERSION:
            return None, "corrupt: schema mismatch"
        if manifest.get("key") != key:
            return None, "corrupt: manifest/key mismatch"
        try:
            with open(self._payload_path(key), "rb") as f:
                blob = f.read()
        except OSError:
            return None, "missing: no payload"
        if len(blob) != manifest.get("payload_bytes") or \
                hashlib.sha256(blob).hexdigest() != \
                manifest.get("payload_sha256"):
            return None, "corrupt: payload checksum mismatch"
        if device is not None and manifest.get("device") != _plain(device):
            return None, "foreign: device fingerprint mismatch"
        return blob, ""

    def verify(self, key: str,
               device: Optional[Dict[str, Any]] = None
               ) -> Tuple[bool, str]:
        """Integrity check. Returns (ok, reason) — reason is '' when ok,
        else one of missing/corrupt/foreign with detail."""
        blob, why = self._read_verified(key, device)
        return blob is not None, why

    def load(self, key: str,
             device: Optional[Dict[str, Any]] = None) -> Optional[bytes]:
        """The verified payload for `key`, or None. Every failure mode —
        absent, torn, corrupt, another device — is a silent miss; the
        caller falls through to a build."""
        try:
            blob, why = self._read_verified(key, device)
        except Exception:
            blob, why = None, "corrupt: unreadable"
        if blob is None:
            if why.startswith("corrupt"):
                self._bump("corrupt")
            elif why.startswith("foreign"):
                self._bump("foreign")
            self._bump("misses")
            return None
        self._bump("hits")
        return blob

    # -- operator surface ----------------------------------------------
    def keys(self) -> List[str]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if n.endswith(_MANIFEST_EXT) and ".tmp-" not in n:
                k = n[:-len(_MANIFEST_EXT)]
                if _valid_key(k):
                    out.append(k)
        return sorted(out)

    def entries(self) -> List[Dict[str, Any]]:
        """Manifest records for listing: key, family, bytes, device
        fingerprint, age. Unreadable manifests are reported with
        family='<corrupt>' so the operator sees them."""
        now = time.time()
        recs = []
        for k in self.keys():
            try:
                with open(self._manifest_path(k), "r",
                          encoding="utf-8") as f:
                    m = json.load(f)
                recs.append({
                    "key": k,
                    "family": m.get("family", ""),
                    "payload_bytes": int(m.get("payload_bytes", 0)),
                    "device": m.get("device", {}),
                    "age_s": max(0.0, now - float(
                        m.get("created_unix", now))),
                })
            except (OSError, ValueError, TypeError, AttributeError):
                recs.append({"key": k, "family": "<corrupt>",
                             "payload_bytes": 0, "device": {},
                             "age_s": 0.0})
        return recs

    def remove(self, key: str) -> None:
        for p in (self._manifest_path(key), self._payload_path(key)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def prune(self, max_age_s: Optional[float] = None,
              max_bytes: Optional[int] = None) -> List[str]:
        """Drop entries older than `max_age_s` (and unreadable ones),
        then oldest-first until the store fits under `max_bytes`.
        Manifest removed first so a concurrent reader never commits to a
        pruned payload. Returns removed keys."""
        removed = []
        recs = self.entries()
        if max_age_s is not None:
            for r in recs:
                if r["age_s"] > max_age_s or r["family"] == "<corrupt>":
                    self.remove(r["key"])
                    removed.append(r["key"])
            recs = [r for r in recs if r["key"] not in set(removed)]
        if max_bytes is not None:
            total = sum(r["payload_bytes"] for r in recs)
            for r in sorted(recs, key=lambda r: -r["age_s"]):
                if total <= max_bytes:
                    break
                self.remove(r["key"])
                removed.append(r["key"])
                total -= r["payload_bytes"]
        # stale staging files from crashed writers (older than 1h)
        try:
            now = time.time()
            for n in os.listdir(self.root):
                if ".tmp-" in n:
                    p = os.path.join(self.root, n)
                    try:
                        if now - os.path.getmtime(p) > 3600.0:
                            os.unlink(p)
                    except OSError:
                        pass
        except OSError:
            pass
        return removed
