"""The Hopper kernels' block-config cache (paddle_tpu_torch.kernels.
autotune) and incubate.autotune against the reference's
(paddle_tpu/kernels/pallas/autotune.py, paddle_tpu/incubate/autotune.py).

tests/test_pallas_autotune.py's six cases run on both modules with the
same stub timer (the real measurement needs the card: chip_smoke.py's
phase 38): the same winners, the same cache entries, the same fallbacks.
Then what the port adds around its use sites (`BuildVariants.select`,
with a stub loader standing in for nvcc and a stub timer): the defaults
first and at most four candidates per kernel and head_dim, a winner
persisted and read back by a fresh process state with no timing, the
kill switch over a cached winner, the capture guard (no timing, no
build inside a CUDA-graph capture), the multi-process rule, failed
builds scoring inf, the bandwidth window, CPU tensors never tuned, and
`set_config` setting the switch as the reference's does."""
import json
import os
import warnings

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.incubate import autotune as jset
from paddle_tpu.kernels.pallas import autotune as jat
from paddle_tpu_torch.incubate import autotune as tset
from paddle_tpu_torch.kernels import autotune as tat
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa

SIDES = {"ref": jat, "port": tat}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_PALLAS_AUTOTUNE", raising=False)
    for at in SIDES.values():
        at.clear()
        at.drain_sweeps()
    yield
    for at in SIDES.values():
        at.clear()
        at.drain_sweeps()


# ---- tests/test_pallas_autotune.py on both modules ------------------------
@pytest.mark.parametrize("side", list(SIDES))
def test_picks_fastest_and_persists(side):
    at = SIDES[side]
    times = {(128, 512): 0.03, (256, 1024): 0.01, (512, 512): 0.02}
    calls = []

    def run(c):
        calls.append(c)
        return times[c]

    key = ("fwd", 4, 256, 256, 8, 8, 64, 1, 0)
    assert at.tune(key, list(times), run) == (256, 1024)
    assert set(calls) == set(times)
    assert len(calls) == 2 * len(times)     # two round-robin rounds
    calls.clear()
    assert at.tune(key, list(times), run) == (256, 1024)
    assert calls == []
    at.clear()
    assert at.lookup(key) == (256, 1024)
    assert at.tune(key, list(times), run) == (256, 1024)
    assert calls == []


@pytest.mark.parametrize("side", list(SIDES))
def test_failed_candidates_are_skipped(side):
    def run(c):
        if c == (512, 512):
            raise RuntimeError("does not fit")
        return {(128, 512): 0.02, (256, 1024): 0.05}[c]

    assert SIDES[side].tune(("bwd", 1, 128, 128, 2, 2, 64, 0, 0),
                            [(512, 512), (128, 512), (256, 1024)],
                            run) == (128, 512)


@pytest.mark.parametrize("side", list(SIDES))
def test_all_failed_falls_back_to_first(side):
    at = SIDES[side]

    def run(c):
        raise RuntimeError("nope")

    key = ("fwd", 1, 128, 128, 2, 2, 64, 0, 1)
    assert at.tune(key, [(256, 1024), (128, 512)], run) == (256, 1024)
    assert at.lookup(key) is None
    assert at.drain_sweeps()[0]["persisted"] is False


@pytest.mark.parametrize("side", list(SIDES))
def test_kill_switch(side, monkeypatch):
    at = SIDES[side]
    monkeypatch.setenv("PADDLE_TPU_PALLAS_AUTOTUNE", "0")
    assert not at.enabled()
    monkeypatch.setenv("PADDLE_TPU_PALLAS_AUTOTUNE", "1")
    assert at.enabled()


@pytest.mark.parametrize("side", list(SIDES))
def test_reentrancy_guard(side):
    at = SIDES[side]
    inner_calls = []

    def run_outer(c):
        w = at.tune(("fwd", 9, 9, 9, 9, 9, 9, 9, 9), [(1, 1), (2, 2)],
                    lambda c2: inner_calls.append(c2) or 0.01)
        assert w == (1, 1)
        return {(128, 512): 0.02, (256, 1024): 0.01}[c]

    assert at.tune(("fwd", 2, 256, 256, 4, 4, 64, 1, 0),
                   [(128, 512), (256, 1024)], run_outer) == (256, 1024)
    assert inner_calls == []


@pytest.mark.parametrize("side", list(SIDES))
def test_distinct_keys_distinct_entries(side):
    at = SIDES[side]
    k1 = ("fwd", 4, 256, 256, 8, 8, 64, 1, 0)
    k2 = ("fwd", 4, 512, 512, 8, 8, 64, 1, 0)
    at.tune(k1, [(1, 1), (2, 2)], lambda c: {(1, 1): 0.1, (2, 2): 0.2}[c])
    at.tune(k2, [(1, 1), (2, 2)], lambda c: {(1, 1): 0.2, (2, 2): 0.1}[c])
    assert at.lookup(k1) == (1, 1)
    assert at.lookup(k2) == (2, 2)


def test_sweep_records_have_the_reference_shape():
    for at in SIDES.values():
        at.tune(("fwd", 1, 2, 3), [(1, 1), (2, 2)],
                lambda c: {(1, 1): 0.2, (2, 2): 0.1}[c])
    (want,), (got,) = jat.drain_sweeps(), tat.drain_sweeps()
    assert got.keys() == want.keys()
    for k in ("key", "candidates", "winner", "bw_window",
              "window_validated", "persisted", "rounds"):
        assert got[k] == want[k], k
    assert tat.drain_sweeps() == []


def test_dedup_candidates_as_the_reference():
    cands = [(256, 1024), (128, 512), (512, 512), (128, 1024)]

    def norm(q, k):
        return min(q, 256), min(k, 512)

    for keep in (False, True):
        assert tat.dedup_candidates(cands, norm, keep) == \
            jat.dedup_candidates(cands, norm, keep)


# ---- the port's build variants --------------------------------------------
TABLES = {"B1": fa._FWD_VARIANTS, "B2": fa._BWD_VARIANTS,
          "B3": rpa._RPA_VARIANTS}


@pytest.mark.parametrize("name", list(TABLES))
def test_variant_tables(name):
    """The sources' own defaults first, at most 4 candidates per head
    dim, every candidate a distinct -D build, and the defaults' build the
    library the kernel loads without flags."""
    table = TABLES[name]
    for d in (64, 128):
        cands = table.candidates(d)
        assert cands[0] == table.defaults(d)
        assert 2 <= len(cands) <= 4 and len(set(cands)) == len(cands)
        assert table.flags(d, cands[0]) == ()
        flags = [table.flags(d, c) for c in cands[1:]]
        assert len(set(flags)) == len(flags)
        for f, c in zip(flags, cands[1:]):
            for m, v in zip(table.knobs[d], c):
                assert f"-D{m}={v}" in f


def _source_defaults(src, table):
    text = open(os.path.join(os.path.dirname(fa.__file__), "csrc",
                             src)).read()
    return {d: tuple(int(text.split(f"#define {m} ")[1].split()[0])
                     for m in table.knobs[d]) for d in table.knobs}


@pytest.mark.parametrize("name,src", [
    ("B1", "flash_fwd_sm90.cu"), ("B2", "flash_bwd_sm90.cu"),
    ("B3", "ragged_paged_attention_sm90.cu")])
def test_defaults_are_the_sources(name, src):
    table = TABLES[name]
    assert _source_defaults(src, table) == {d: table.defaults(d)
                                            for d in table.knobs}


class _Lib:
    def __init__(self, flags):
        self.flags = flags


def _table(loads, fail=()):
    def load(flags):
        if flags in fail:
            raise RuntimeError("nvcc failed")
        loads.append(flags)
        return _Lib(flags)
    return tat.BuildVariants(
        {64: ("K_D64_A", "K_D64_B"), 128: ("K_D128_A",)},
        [{64: (64, 3), 128: (2,)}, {64: (64, 2), 128: (3,)},
         {64: (128, 2), 128: (2,)}], load)


KEY = ("fwd", 1024, 1024, 12, 12, 64, "bfloat16", 1, 0)
TIMES = {(): 3e-4, ("-DK_D64_A=64", "-DK_D64_B=2", "-DK_D128_A=3"): 1e-4,
         ("-DK_D64_A=128", "-DK_D64_B=2", "-DK_D128_A=2"): 2e-4}


def _timer(calls):
    def time_lib(lib):
        calls.append(lib.flags)
        return TIMES[lib.flags]
    return time_lib


def test_select_sweeps_once_persists_and_a_fresh_process_reads_it():
    loads, calls = [], []
    table = _table(loads)
    lib = table.select(KEY, 64, _timer(calls))
    assert lib.flags == ("-DK_D64_A=64", "-DK_D64_B=2", "-DK_D128_A=3")
    assert len(calls) == 6             # 3 candidates x 2 rounds
    (sweep,) = tat.drain_sweeps()
    assert sweep["winner"] == [64, 2] and sweep["persisted"]
    assert sweep["key"] == list(KEY)
    assert table.select(KEY, 64, _timer(calls)) is lib
    assert len(calls) == 6
    # a later process: nothing in memory, the winner on disk
    tat.clear()
    loads2, calls2 = [], []
    fresh = _table(loads2)
    got = fresh.select(KEY, 64, _timer(calls2))
    assert got.flags == lib.flags and calls2 == [] and len(loads2) == 1
    assert tat.drain_sweeps() == []
    disk = json.load(open(os.path.join(
        os.environ["PADDLE_TPU_CACHE_DIR"], "kernel_tune_cpu.json")))
    assert list(disk.values()) == [[64, 2]]


def test_kill_switch_restores_the_defaults_over_a_cached_winner(
        monkeypatch):
    calls = []
    table = _table([])
    assert table.select(KEY, 64, _timer(calls)).flags != ()
    monkeypatch.setenv("PADDLE_TPU_PALLAS_AUTOTUNE", "0")
    n = len(calls)
    assert table.select(KEY, 64, _timer(calls)).flags == ()
    assert len(calls) == n
    tset.set_config({"kernel": {"enable": True}})
    assert table.select(KEY, 64, _timer(calls)).flags != ()


def test_capture_takes_the_cached_winner_or_the_defaults(monkeypatch):
    """Inside a CUDA-graph capture nothing is timed or built."""
    monkeypatch.setattr(tat, "_capturing", lambda: True)
    loads, calls = [], []
    table = _table(loads)
    assert table.select(KEY, 64, _timer(calls)).flags == ()
    assert calls == [] and set(loads) == {()}
    assert tat.tune(KEY, [(64, 3), (64, 2)], lambda c: 1 / 0) == (64, 3)
    assert tat.drain_sweeps() == []
    # the shape class keeps the defaults in this process, so its eager
    # calls match its captured ones
    monkeypatch.setattr(tat, "_capturing", lambda: False)
    assert table.select(KEY, 64, _timer(calls)).flags == ()
    assert calls == []
    # a winner on disk whose library is not loaded yet: still no build
    tat.tune(("other",), [(64, 3), (64, 2)],
             lambda c: {(64, 3): 2.0, (64, 2): 1.0}[c])
    monkeypatch.setattr(tat, "_capturing", lambda: True)
    assert table.select(("other",), 64, _timer(calls)).flags == ()
    assert set(loads) == {()}


def test_load_all_builds_every_variant_once():
    loads = []
    table = _table(loads)
    table.load_all()
    assert sorted(loads) == sorted([
        (), ("-DK_D64_A=64", "-DK_D64_B=2", "-DK_D128_A=3"),
        ("-DK_D64_A=128", "-DK_D64_B=2", "-DK_D128_A=2")])


def test_several_processes_use_the_defaults_unless_cached(monkeypatch):
    """The reference's process_count() > 1 rule."""
    from paddle_tpu_torch.distributed import parallel
    monkeypatch.setattr(parallel, "process_count", lambda: 2)
    calls = []
    table = _table([])
    assert table.select(KEY, 64, _timer(calls)).flags == ()
    assert calls == []
    tat.clear()
    tat.tune(KEY, [(64, 3), (128, 2)],
             lambda c: {(64, 3): 2.0, (128, 2): 1.0}[c])
    got = table.select(KEY, 64, _timer(calls))
    assert got.flags == ("-DK_D64_A=128", "-DK_D64_B=2", "-DK_D128_A=2")
    assert calls == []


def test_a_variant_that_does_not_build_scores_inf():
    bad = ("-DK_D64_A=64", "-DK_D64_B=2", "-DK_D128_A=3")
    calls = []
    table = _table([], fail={bad})
    lib = table.select(KEY, 64, _timer(calls))
    assert lib.flags == ("-DK_D64_A=128", "-DK_D64_B=2", "-DK_D128_A=2")
    (sweep,) = tat.drain_sweeps()
    assert sweep["candidates"]["(64, 2)"] is None


def test_a_sweep_outside_the_bandwidth_window_is_not_kept(monkeypatch):
    monkeypatch.setattr(tat, "_validated_bw_window", lambda: (2e12, 3e12))
    monkeypatch.setattr(tat, "measure_effective_bw", lambda: 1e12)
    calls = []
    table = _table([])
    assert table.select(KEY, 64, _timer(calls)).flags == ()
    assert calls == []
    (sweep,) = tat.drain_sweeps()
    assert sweep["window_validated"] is False and not sweep["persisted"]
    assert sweep["bw_probes_bytes_per_s"] == [1e12] * 3
    assert tat.lookup(KEY) is None


def test_the_head_dims_share_a_build():
    """Variant i sets every head_dim's macros: its build is D 64's
    candidate i and D 128's."""
    loads = []
    table = _table(loads)
    a = table.library(64, (64, 2))
    b = table.library(128, (3,))
    assert a is b and len(loads) == 1


def test_cpu_tensors_tune_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU call reached the cache")

    monkeypatch.setattr(fa._FWD_VARIANTS, "select", boom)
    monkeypatch.setattr(fa._BWD_VARIANTS, "select", boom)
    q = torch.randn(1, 128, 2, 64, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, requires_grad=True)
    out = fa.flash_attention(q, k, k, causal=True)
    out.sum().backward()
    assert tat.drain_sweeps() == [] and tat.measure_effective_bw() is None


def test_set_config_sets_the_switch_as_the_reference(tmp_path):
    cases = [None, {"kernel": {"enable": False}}, {"kernel": {"enable": 1}},
             {"layout": {"enable": False}}]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"kernel": {"enable": False}}))
    cases.append(str(path))
    for cfg in cases:
        seen = []
        for mod in (jset, tset):
            os.environ.pop("PADDLE_TPU_PALLAS_AUTOTUNE", None)
            mod.set_config(cfg)
            seen.append(os.environ.get("PADDLE_TPU_PALLAS_AUTOTUNE"))
        assert seen[0] == seen[1], cfg
    for section in ("layout", "dataloader"):
        with pytest.warns(UserWarning, match=section):
            tset.set_config({section: {"enable": True}})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tset.set_config({"layout": {"enable": False}})
    assert ptt.incubate.autotune is tset
