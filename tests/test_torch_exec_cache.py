"""paddle_tpu_torch's persistent kernel-library store
(inference/exec_cache.py) and `utils.build`'s use of it, held to the
reference's contract (README "Persistent executable cache"): a warm
start runs no compiler, a corrupt, torn or foreign entry degrades to a
build (outcome "compile"), writes are atomic with the manifest last, and
the operator surface (entries, remove, prune) behaves as the
reference's tests/test_exec_cache.py pins it. The "libraries" here come
from a stub compiler (a Python script that writes its sources'
bytes), so no nvcc is needed; one case builds the real block
allocator with g++ through the store and loads it warm."""
import json
import os
import stat
import sys
import textwrap

import pytest

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import exec_cache as ec
from paddle_tpu_torch.utils import build


def _key(tag):
    return ec.fingerprint({"t": tag})


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture
def stub(tmp_path):
    """A compiler that writes 'LIB:' + its sources' bytes to -o, and a
    source file."""
    cc = tmp_path / "stubcc"
    cc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        out = args[args.index("-o") + 1]
        srcs = [a for a in args if a.endswith(".src")]
        with open(out, "wb") as f:
            f.write(b"LIB:" + b"".join(open(s, "rb").read() for s in srcs))
        """))
    cc.chmod(cc.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "k.src"
    src.write_bytes(b"kernel v1")
    return str(cc), str(src)


def _outcomes():
    """The compile counter's nonzero series (a reset keeps an earlier
    test's series at 0)."""
    snap = obs.snapshot().get("paddle_tpu_compile_total")
    return {} if snap is None else {k: v for k, v in snap["series"].items()
                                    if v}


class TestFingerprints:
    def test_fingerprint_stable_and_order_free(self):
        assert ec.fingerprint({"a": 1, "b": [2, 3]}) == \
            ec.fingerprint({"b": (2, 3), "a": 1})

    def test_fingerprint_distinguishes_and_rejects_unstable(self):
        assert ec.fingerprint({"a": 1}) != ec.fingerprint({"a": 2})
        with pytest.raises(TypeError):
            ec.fingerprint({"a": object()})

    def test_device_fingerprint_names_the_runtime(self):
        fp = ec.device_fingerprint(device="cpu")
        assert fp["device_name"] == "cpu" and fp["torch"]
        with pytest.raises(NotImplementedError):
            ec.device_fingerprint(mesh=object())
        c = ec.code_fingerprint()
        assert c == ec.code_fingerprint() and len(c) == 64


class TestStore:
    def test_save_load_round_trip(self, tmp_path):
        store = ec.ExecCache(str(tmp_path))
        key = _key("round")
        assert store.save(key, b"\x7fELF lib", family="t_fam")
        assert store.load(key) == b"\x7fELF lib"
        assert store.stats()["saves"] == 1 and store.stats()["hits"] == 1
        assert store.load(_key("absent")) is None
        assert store.stats()["misses"] == 1
        assert not store.save("NOT-HEX", b"x")      # refused, no raise
        assert store.stats()["save_errors"] == 1

    def test_corrupt_torn_and_foreign_are_misses(self, tmp_path):
        store = ec.ExecCache(str(tmp_path))
        dev = ec.device_fingerprint(device="cpu")
        k1, k2, k3 = _key("c"), _key("t"), _key("f")
        for k in (k1, k2, k3):
            store.save(k, b"payload-bytes-" * 8, device=dev)
        p = tmp_path / (k1 + ".exec")
        blob = bytearray(p.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        p.write_bytes(bytes(blob))
        ok, why = store.verify(k1)
        assert not ok and why.startswith("corrupt")
        assert store.load(k1) is None
        m = tmp_path / (k2 + ".json")
        m.write_text(m.read_text()[:20])            # torn manifest
        assert not store.verify(k2)[0] and store.load(k2) is None
        other = dict(dev, device_name="NVIDIA H100 80GB HBM3",
                     capability=[9, 0])
        ok, why = store.verify(k3, device=other)
        assert not ok and why.startswith("foreign")
        assert store.load(k3, device=other) is None
        assert store.load(k3, device=dev) is not None
        st = store.stats()
        assert st["corrupt"] == 1 and st["foreign"] == 1

    def test_commit_is_atomic_manifest_last(self, tmp_path, monkeypatch):
        """A writer that dies after the payload and before the manifest
        leaves no entry: the payload alone is never loaded."""
        store = ec.ExecCache(str(tmp_path))
        key = _key("atomic")
        real = json.dump

        def crash(*a, **k):
            raise OSError("disk gone")
        monkeypatch.setattr(ec.json, "dump", crash)
        assert not store.save(key, b"lib")
        monkeypatch.setattr(ec.json, "dump", real)
        assert store.keys() == [] and store.load(key) is None
        assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
        # a payload without its manifest (a crash between the renames)
        (tmp_path / (key + ".exec")).write_bytes(b"lib")
        assert store.load(key) is None

    def test_entries_remove_prune(self, tmp_path):
        store = ec.ExecCache(str(tmp_path))
        keys = [_key("p%d" % i) for i in range(3)]
        for k in keys:
            store.save(k, b"x" * 100, family="fam")
        recs = {r["key"]: r for r in store.entries()}
        assert set(recs) == set(keys) and recs[keys[0]]["family"] == "fam"
        man = tmp_path / (keys[0] + ".json")
        rec = json.loads(man.read_text())
        rec["created_unix"] -= 10 * 86400
        man.write_text(json.dumps(rec))
        assert store.prune(max_age_s=86400.0) == [keys[0]]
        store.prune(max_bytes=100)
        assert len(store.keys()) == 1
        store.remove(store.keys()[0])
        assert store.keys() == []
        stale = tmp_path / ".tmp-1234-deadbeef"
        stale.write_bytes(b"partial")
        old = os.path.getmtime(stale) - 7200
        os.utime(stale, (old, old))
        store.prune()
        assert not stale.exists()


class TestBuildThroughTheStore:
    def test_cold_compile_saves_then_warm_disk_hit(self, tmp_path, stub):
        cc, src = stub
        obs.enable()
        store = ec.ExecCache(str(tmp_path / "store"))
        lib = ec.LibraryStore(store, ec.device_fingerprint(device="cpu"))
        runs0 = build.compiler_runs["stubcc"]
        out = build.build_shared("stublib", [src], cc, (),
                                 out_dir=tmp_path / "b1", store=lib)
        assert open(out, "rb").read() == b"LIB:kernel v1"
        assert build.compiler_runs["stubcc"] == runs0 + 1
        assert store.stats()["saves"] == 1
        # a "restarted process": an empty build directory, the same
        # store -> no compiler run, the stored bytes
        out2 = build.build_shared("stublib", [src], cc, (),
                                  out_dir=tmp_path / "b2", store=lib)
        assert out2 != out and open(out2, "rb").read() == b"LIB:kernel v1"
        assert build.compiler_runs["stubcc"] == runs0 + 1
        assert _outcomes() == {("stublib", "compile"): 1.0,
                               ("stublib", "disk_hit"): 1.0}
        # an edited source is another library: compiled again
        open(src, "wb").write(b"kernel v2")
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "b3",
                           store=lib)
        assert build.compiler_runs["stubcc"] == runs0 + 2

    def test_bad_entries_fall_back_to_a_build(self, tmp_path, stub):
        cc, src = stub
        obs.enable()
        store = ec.ExecCache(str(tmp_path / "store"))
        dev = ec.device_fingerprint(device="cpu")
        lib = ec.LibraryStore(store, dev)
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "b",
                           store=lib)
        (key,) = store.keys()
        p = tmp_path / "store" / (key + ".exec")
        p.write_bytes(b"LIB:rotten")                 # checksum mismatch
        runs = build.compiler_runs["stubcc"]
        out = build.build_shared("stublib", [src], cc, (),
                                 out_dir=tmp_path / "c", store=lib)
        assert open(out, "rb").read() == b"LIB:kernel v1"
        assert build.compiler_runs["stubcc"] == runs + 1
        # the rebuild re-saved a good entry: the next start is warm
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "d",
                           store=lib)
        assert build.compiler_runs["stubcc"] == runs + 1
        # another device's store entry is foreign: a build again
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "e",
                           store=ec.LibraryStore(
                               store, dict(dev, device_name="other")))
        assert build.compiler_runs["stubcc"] == runs + 2
        assert _outcomes()[("stublib", "compile")] == 3.0

    def test_failed_build_still_raises(self, tmp_path, stub):
        _cc, src = stub
        bad = tmp_path / "badcc"
        bad.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
        bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
        lib = ec.LibraryStore(ec.ExecCache(str(tmp_path / "store")),
                              ec.device_fingerprint(device="cpu"))
        with pytest.raises(RuntimeError, match="broken"):
            build.build_shared("badlib", [src], str(bad), (),
                               out_dir=tmp_path / "b", store=lib)

    def test_engine_takes_the_allocator_from_the_store(self, tmp_path):
        """LLMEngine(exec_cache_dir=) hands its store to the load of its
        pool's allocator library, so the store holds the g++ build; it
        comes back as a disk hit into an empty build directory with no
        compiler run, and loads."""
        import ctypes
        from paddle_tpu_torch.inference import paged_cache
        from torch_fleet_cases import ENGINE_KW, tiny_gpt
        from paddle_tpu_torch.inference import LLMEngine
        store_dir = str(tmp_path / "store")
        eng = LLMEngine(tiny_gpt(), device="cpu", exec_cache_dir=store_dir,
                        **ENGINE_KW)
        assert eng._lib_store.cache is eng._exec_cache
        src = os.path.join(os.path.dirname(paged_cache.__file__),
                           "_block_allocator.cpp")
        if not eng._exec_cache.keys():
            # this process loaded the allocator before: put it in the
            # store through a build
            build.build_shared("paged_block_allocator", [src], "g++",
                               build.GXX_FLAGS, out_dir=tmp_path / "b0",
                               store=eng._lib_store)
        assert [e["family"] for e in eng._exec_cache.entries()] == [
            "paged_block_allocator"]
        obs.enable()
        runs = build.compiler_runs["g++"]
        lib = build.build_shared("paged_block_allocator", [src], "g++",
                                 build.GXX_FLAGS, out_dir=tmp_path / "b1",
                                 store=eng._lib_store)
        lib2 = build.build_shared("paged_block_allocator", [src], "g++",
                                  build.GXX_FLAGS, out_dir=tmp_path / "b2",
                                  store=eng._lib_store)
        assert build.compiler_runs["g++"] == runs
        assert _outcomes()[("paged_block_allocator", "disk_hit")] == 2.0
        h = ctypes.CDLL(lib2)
        h.pba_create.restype = ctypes.c_void_p
        h.pba_num_free.argtypes = [ctypes.c_void_p]
        assert h.pba_num_free(h.pba_create(5)) == 5
        assert open(lib, "rb").read() == open(lib2, "rb").read()

    def test_a_store_reaches_only_the_builds_handed_it(self, tmp_path, stub):
        """An engine given a store changes no other build of the
        process: a build without a store still takes the library its
        build directory holds, runs no compiler and records nothing."""
        from paddle_tpu_torch.inference import LLMEngine
        from torch_fleet_cases import ENGINE_KW, tiny_gpt
        cc, src = stub
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "b")
        obs.enable()
        eng = LLMEngine(tiny_gpt(), device="cpu",
                        exec_cache_dir=str(tmp_path / "store"), **ENGINE_KW)
        runs = build.compiler_runs["stubcc"]
        build.build_shared("stublib", [src], cc, (), out_dir=tmp_path / "b")
        assert build.compiler_runs["stubcc"] == runs
        assert "stublib" not in [e["family"]
                                 for e in eng._exec_cache.entries()]
        assert not [k for k in _outcomes() if k[0] == "stublib"]
