"""The request lifecycle of paddle_tpu_torch's LLMEngine against
paddle_tpu's, and the port's fault-injection registry and watchdog.

`paddle_tpu_torch.resilience.faults` runs the reference's own harness
cases (tests/test_resilience.py's TestFaultHarness). The engine cases of
tests/test_resilience.py (a pool sized exactly to admission's check, a
request poisoned at decode and at prefill, a deadline on an injected
clock, load shedding, the legacy raises) and `abort_request` run on
both engines, twin tiny GPTs with the same weights, under the same
faults: finish reasons, `ok`, the error strings (their exception
classes included), every `stats` counter and `available_blocks` equal,
greedy tokens equal under the logit-margin guard. The watchdog reads
FLAGS_watchdog_timeout_s / FLAGS_watchdog_abort, and an engine's
step_timeout_s fires it around a launch that hangs.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.resilience import faults as jfaults
import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.watchdog import watchdog
from torch_port_helpers import assert_tokens_equal_guarded, twin_gpts


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear_all()
    jfaults.clear_all()
    yield
    faults.clear_all()
    jfaults.clear_all()


# ---------------------------------------------------------------------------
# the harness itself (the reference's cases on the port's copy)
# ---------------------------------------------------------------------------
def test_disarmed_is_noop():
    faults.fault_point("nothing.armed", x=1)


def test_context_scoping_and_fired():
    with faults.inject("chaos.a", exc=ValueError("boom")):
        with pytest.raises(ValueError, match="boom"):
            faults.fault_point("chaos.a")
    faults.fault_point("chaos.a")              # cleared on exit
    assert faults.fired("chaos.a") == 1


def test_times_budget():
    faults.inject("chaos.b", exc=RuntimeError, times=2)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            faults.fault_point("chaos.b")
    faults.fault_point("chaos.b")              # budget exhausted
    assert faults.fired("chaos.b") == 2


def test_match_and_when():
    with faults.inject("chaos.c", exc=KeyError, match={"rid": "bad"}):
        faults.fault_point("chaos.c", rid="good")
        with pytest.raises(KeyError):
            faults.fault_point("chaos.c", rid="bad")
    with faults.inject("chaos.d", exc=KeyError,
                       when=lambda ctx: ctx.get("i", 0) > 3):
        faults.fault_point("chaos.d", i=1)
        with pytest.raises(KeyError):
            faults.fault_point("chaos.d", i=7)


def test_delay():
    with faults.inject("chaos.e", delay=0.05):
        t0 = time.monotonic()
        faults.fault_point("chaos.e")
        assert time.monotonic() - t0 >= 0.05


def test_when_may_call_back_into_faults():
    faults.inject("chaos.seq.a", exc=ValueError, times=1)
    faults.inject("chaos.seq.b", exc=RuntimeError,
                  when=lambda ctx: faults.fired("chaos.seq.a") > 0)
    faults.fault_point("chaos.seq.b")          # A not fired yet
    with pytest.raises(ValueError):
        faults.fault_point("chaos.seq.a")
    with pytest.raises(RuntimeError):
        faults.fault_point("chaos.seq.b")


def test_snapshot_drops_when_and_installs():
    faults.inject("chaos.f", exc=ValueError, match={"bi": 1})
    faults.inject("chaos.g", exc=ValueError, when=lambda c: True)
    snap = faults.snapshot()
    assert {s.name for s in snap} == {"chaos.f"}
    faults.clear_all()
    faults.install(snap)
    with pytest.raises(ValueError):
        faults.fault_point("chaos.f", bi=1)


def test_fault_spec_needs_an_effect_and_observer_sees_fires():
    with pytest.raises(ValueError):
        faults.inject("chaos.h")
    seen = []
    faults.set_on_fire(lambda name, ctx: seen.append((name, ctx)))
    try:
        with faults.inject("chaos.i", exc=OSError):
            with pytest.raises(OSError):
                faults.fault_point("chaos.i", rid=3)
    finally:
        faults.set_on_fire(None)
    assert seen == [("chaos.i", {"rid": 3})]


# ---------------------------------------------------------------------------
# engine hardening on both engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


BASE_KW = dict(max_batch=2, block_size=16, decode_chunk=4,
               prompt_quantum=16, max_model_len=64)


def _drain(eng):
    done = {}
    while eng.has_unfinished:
        for r in eng.step():
            done[r.request_id] = r
    return done


def _tight_pool(rng):
    prompt = rng.integers(0, 1024, (17,)).astype(np.int32)

    def drive(eng, reg):
        eng.add_request(0, prompt, max_new_tokens=20)
        return _drain(eng)
    # 37 tokens need 5 blocks of 8: a pool of 5 + the trash page
    return dict(kw=dict(max_batch=1, block_size=8, num_blocks=6),
                drive=drive, prompts={0: prompt})


def _poisoned_decode(rng):
    prompts = {k: rng.integers(0, 1024, (9,)).astype(np.int32)
               for k in ("good1", "bad", "good2")}

    def drive(eng, reg):
        for k, p in prompts.items():
            eng.add_request(k, p, max_new_tokens=8)
        with reg.inject("engine.decode.seq",
                        exc=MemoryError("chaos decode OOM"),
                        match={"rid": "bad"}):
            return _drain(eng)
    return dict(drive=drive, prompts=prompts,
                expect=lambda st: st["failed_requests"] == 1)


def _poisoned_prefill(rng):
    prompts = {"good": rng.integers(0, 1024, (9,)).astype(np.int32),
               "bad": rng.integers(0, 1024, (11,)).astype(np.int32)}

    def drive(eng, reg):
        for k, p in prompts.items():
            eng.add_request(k, p, max_new_tokens=6)
        with reg.inject("engine.prefill.seq",
                        exc=RuntimeError("chaos prefill"),
                        match={"rid": "bad"}):
            return _drain(eng)
    return dict(drive=drive, prompts=prompts,
                expect=lambda st: st["failed_requests"] == 1)


def _all_poisoned(rng):
    """Every request poisoned at decode: nothing survives alone, so the
    failure is systemic. shed_load degrades it into per-request
    failures (without it the step raises:
    test_systemic_decode_failure_raises_on_both)."""
    prompts = {k: rng.integers(0, 1024, (9,)).astype(np.int32)
               for k in ("a", "b")}

    def drive(eng, reg):
        for k, p in prompts.items():
            eng.add_request(k, p, max_new_tokens=8)
        with reg.inject("engine.decode.seq", exc=MemoryError("chaos")):
            return _drain(eng)
    return dict(kw=dict(shed_load=True), drive=drive, prompts=prompts,
                expect=lambda st: st["failed_requests"] == 2)


def _deadline(rng):
    pv = rng.integers(0, 1024, (9,)).astype(np.int32)
    pn = rng.integers(0, 1024, (12,)).astype(np.int32)
    pq = rng.integers(0, 1024, (7,)).astype(np.int32)

    def drive(eng, reg):
        clock = {"now": 0.0}
        eng._now = lambda: clock["now"]
        eng.add_request("victim", pv, max_new_tokens=30, deadline_s=5.0)
        eng.add_request("neighbor", pn, max_new_tokens=8)
        eng.add_request("queued", pq, max_new_tokens=8, deadline_s=5.0)
        done = {r.request_id: r for r in eng.step()}
        clock["now"] = 10.0             # both TTLs elapse
        done.update(_drain(eng))
        return done
    return dict(drive=drive, prompts={"neighbor": pn},
                expect=lambda st: st["deadline_expired"] == 2)


def _load_shedding(rng):
    def drive(eng, reg):
        eng.add_request("big", np.zeros(20, np.int32), max_new_tokens=20)
        eng.add_request("long", np.zeros(60, np.int32), max_new_tokens=10)
        eng.add_request("ok1", np.zeros(4, np.int32), max_new_tokens=2)
        eng.add_request("spill", np.zeros(4, np.int32), max_new_tokens=2)
        return _drain(eng)
    return dict(kw=dict(max_batch=1, block_size=8, num_blocks=5,
                        shed_load=True, max_waiting=1),
                drive=drive, prompts={"ok1": np.zeros(4, np.int32)},
                expect=lambda st: st["rejected_requests"] == 3)


def _abort_queued_and_running(rng):
    prompts = {k: rng.integers(0, 1024, (n,)).astype(np.int32)
               for k, n in (("run", 17), ("gone", 9), ("wait", 5),
                            ("keep", 12))}

    def drive(eng, reg):
        for k, p in prompts.items():
            eng.add_request(k, p, max_new_tokens=10)
        done = {r.request_id: r for r in eng.step()}  # run, gone admitted
        hit = (eng.abort_request("gone"), eng.abort_request("wait"),
               eng.abort_request("nobody"))
        assert hit == (True, True, False)
        done.update(_drain(eng))
        assert eng.abort_request("run") is False      # already finished
        return done
    return dict(drive=drive, prompts={k: prompts[k] for k in ("run",
                                                              "keep")},
                expect=lambda st: st["aborted_requests"] == 2)


LIFECYCLE_CASES = {
    "tight_pool": _tight_pool, "poisoned_decode": _poisoned_decode,
    "poisoned_prefill": _poisoned_prefill,
    "all_poisoned_shed": _all_poisoned, "deadline": _deadline,
    "load_shedding": _load_shedding, "abort": _abort_queued_and_running,
}


@pytest.mark.parametrize("name", sorted(LIFECYCLE_CASES))
def test_lifecycle_matches_reference(name, gpts):
    jm, tm = gpts
    c = LIFECYCLE_CASES[name](np.random.default_rng(5))
    kw = dict(BASE_KW, **c.get("kw", {}))
    je = JaxEngine(jm, **kw)
    jres = c["drive"](je, jfaults)
    te = LLMEngine(tm, device="cpu", **kw)
    tres = c["drive"](te, faults)
    assert dict(je.stats) == te.stats
    assert te.cache.available_blocks == je.cache.available_blocks \
        == te.cache.allocator.num_blocks - 1
    assert te.peak_used_blocks == je.peak_used_blocks
    if "expect" in c:
        assert c["expect"](te.stats), te.stats
    assert sorted(tres, key=str) == sorted(jres, key=str)
    for rid, jr in jres.items():
        tr = tres[rid]
        assert (tr.finish_reason, tr.ok, tr.error) == \
            (jr.finish_reason, jr.ok, jr.error), rid
        if tr.ok:
            assert assert_tokens_equal_guarded(
                tm, c["prompts"][rid], jr.output_ids, tr.output_ids) > 0
        else:
            # a failed request keeps what it generated before failing
            assert len(tr.output_ids) == len(jr.output_ids)


def test_systemic_decode_failure_raises_on_both(gpts):
    """Without shed_load, a failure no request survives alone is raised
    (one loud engine error), by both engines."""
    jm, tm = gpts
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 1024, (9,)).astype(np.int32)
               for _ in range(2)]
    for eng, reg in ((JaxEngine(jm, **BASE_KW), jfaults),
                     (LLMEngine(tm, device="cpu", **BASE_KW), faults)):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=8)
        with reg.inject("engine.decode.seq", exc=MemoryError("chaos")):
            with pytest.raises(MemoryError, match="chaos"):
                _drain(eng)


def test_engine_step_fault_point(gpts):
    _jm, tm = gpts
    eng = LLMEngine(tm, device="cpu", **BASE_KW)
    eng.add_request(0, np.arange(5, dtype=np.int32), max_new_tokens=3)
    with faults.inject("engine.step", exc=RuntimeError("step chaos"),
                       times=1):
        with pytest.raises(RuntimeError, match="step chaos"):
            eng.step()
    assert faults.fired("engine.step") == 1
    assert len(_drain(eng)[0].output_ids) == 3


@pytest.mark.parametrize("kind,exc", [("long", ValueError),
                                      ("big", MemoryError),
                                      ("spill", RuntimeError)])
def test_legacy_raise_admission_matches_reference(kind, exc, gpts):
    jm, tm = gpts
    kw = dict(BASE_KW, max_batch=1, block_size=8, num_blocks=5,
              max_waiting=1)
    args = {"long": (np.zeros(60, np.int32), 10),
            "big": (np.zeros(20, np.int32), 20),
            "spill": (np.zeros(4, np.int32), 2)}[kind]
    msgs = []
    for eng in (JaxEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)):
        if kind == "spill":
            eng.add_request("first", np.zeros(4, np.int32), max_new_tokens=2)
        with pytest.raises(exc) as e:
            eng.add_request(kind, *args)
        msgs.append(str(e.value))
        assert eng.stats["rejected_requests"] == 0
    assert msgs[0] == msgs[1]


def test_prefix_hashes_are_used(gpts):
    """A precomputed block-hash chain is admission's key: the same
    prefix hits whether the chain was given or computed, and a chain
    of another prompt finds nothing (the reference's contract: the
    caller's chain is trusted)."""
    _jm, tm = gpts
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 1024, (40,)).astype(np.int32)
    eng = LLMEngine(tm, device="cpu", **dict(BASE_KW, max_batch=1))
    eng.add_request("a", prompt, max_new_tokens=4)
    _drain(eng)
    chain = eng.cache.block_hashes(prompt)
    eng.add_request("b", prompt, max_new_tokens=4, prefix_hashes=chain)
    _drain(eng)
    assert eng.stats["prefix_cache_hit_tokens"] == 32
    other = eng.cache.block_hashes(prompt[::-1].copy())
    eng.add_request("c", prompt, max_new_tokens=4, prefix_hashes=other)
    _drain(eng)
    assert eng.stats["prefix_cache_hit_tokens"] == 32


def test_unported_options_still_raise(gpts):
    _jm, tm = gpts
    for kw in (dict(mesh=object()), dict(shard_param=lambda *a: None),
               dict(exec_cache_dir="x")):
        with pytest.raises(NotImplementedError):
            LLMEngine(tm, device="cpu", **BASE_KW, **kw)
    eng = LLMEngine(tm, device="cpu", **BASE_KW)
    with pytest.raises(NotImplementedError):
        eng.add_request(0, np.arange(4), obs_carry=("t", "s", 0.0))


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_a_hang_and_stays_quiet_otherwise(capfd):
    with watchdog(5.0, what="quick region", abort=False):
        pass
    with watchdog(0.05, what="slow region", abort=False) as w:
        time.sleep(0.3)
    assert w is not None
    err = capfd.readouterr().err
    assert "'slow region' exceeded" in err
    assert "quick region" not in err


def test_watchdog_reads_the_flags(capfd):
    saved = ptt.get_flags(["FLAGS_watchdog_timeout_s",
                           "FLAGS_watchdog_abort"])
    try:
        with watchdog(what="unarmed") as w:
            assert w is None            # 0 by default: disarmed
        ptt.set_flags({"FLAGS_watchdog_timeout_s": "0.05"})
        with watchdog(what="armed by flag") as w:
            assert w is not None and w.abort is False
            time.sleep(0.3)
        ptt.set_flags({"FLAGS_watchdog_abort": "1"})
        with watchdog(what="would abort") as w:
            assert w.abort is True and w.timeout_s == 0.05
    finally:
        ptt.set_flags(saved)
    assert "'armed by flag' exceeded" in capfd.readouterr().err


def test_engine_step_timeout_fires_around_a_hung_launch(gpts, capfd,
                                                        monkeypatch):
    """step_timeout_s arms the watchdog around each device launch: a
    decode chunk that hangs past it dumps the stacks (warn only with
    FLAGS_watchdog_abort off); the engine then serves on."""
    _jm, tm = gpts
    eng = LLMEngine(tm, device="cpu", step_timeout_s=1.0, **BASE_KW)
    chunk = eng._decode_chunk
    calls = []

    def slow(*args):
        if not calls:
            time.sleep(1.5)
        calls.append(threading.get_ident())
        return chunk(*args)

    monkeypatch.setattr(eng, "_decode_chunk", slow)
    res = eng.generate([np.arange(6, dtype=np.int32)], max_new_tokens=6)
    assert res[0].ok and len(res[0].output_ids) == 6
    err = capfd.readouterr().err
    assert "'engine decode chunk' exceeded" in err
    assert "engine ragged launch" not in err
