"""Speculative decoding in paddle_tpu_torch against paddle_tpu's.

The proposers, the acceptance rule and SpeculativeConfig's validation
are held to the reference's on the same inputs (its
test_spec_decode.py cases). The port's LLMEngine with a
SpeculativeConfig is held to the reference's on the same traffic, twin
models (tiny GPT and LLaMA) with the same weights: every `stats` counter
(the five spec_* ones included), `peak_used_blocks` and
`available_blocks` exactly equal, finish reasons equal, greedy tokens
equal under the logit-margin guard (torch_port_helpers). The traffic
covers preemption, prefix-cache LRU pressure, int8 pools, a proposer
that raises, an `engine.verify.seq` fault (both degrade the step to the
chunked decode), a self-drafting model, a deadline and load shedding.
The port alone: a verify wave that raises propagates out of step() (it
does not degrade), do_sample is refused, blocks are conserved after
every step, rejected drafts never reach the prefix index, and
`PagedKVCache.truncate` keeps its guards.
"""
import numpy as np
import pytest

from paddle_tpu.inference import (DraftModelProposer as JDraftModel,
                                  DraftProposer as JDraftProposer,
                                  LLMEngine as JaxEngine,
                                  NgramProposer as JNgram,
                                  SpeculativeConfig as JSpec)
from paddle_tpu.inference import calibrate_kv_scales as jcalibrate
from paddle_tpu.inference.speculative import accept_drafts as jaccept
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch.inference import (DraftModelProposer, DraftProposer,
                                        LLMEngine, NgramProposer,
                                        PagedKVCache, SpeculativeConfig,
                                        calibrate_kv_scales)
from paddle_tpu_torch.inference.speculative import accept_drafts
from paddle_tpu_torch.resilience import faults
from torch_port_helpers import (assert_tokens_equal_guarded, twin_gpts,
                                twin_llamas)

ENGINE_KW = dict(max_batch=2, block_size=16, decode_chunk=4,
                 prompt_quantum=16, max_model_len=64)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear_all()
    jfaults.clear_all()
    yield
    faults.clear_all()
    jfaults.clear_all()


@pytest.fixture(scope="module")
def gpts():
    return twin_gpts()


@pytest.fixture(scope="module")
def llamas():
    return twin_llamas()


def _rep(rng, pat_len=8, reps=4):
    return np.tile(rng.integers(0, 1024, (pat_len,)).astype(np.int32),
                   reps)


def _drain(eng):
    done = {}
    while eng.has_unfinished:
        for r in eng.step():
            done[r.request_id] = r
    return done


# ---------------------------------------------------------------------------
# proposers, acceptance and the config, against the reference's
# ---------------------------------------------------------------------------
NGRAM_CASES = [
    # (min_n, max_n, context, k): test_spec_decode.py's cases
    (1, 3, [1, 2, 3, 4, 1, 2, 3], 3),
    (2, 4, list(range(10)), 4),
    (1, 2, [7, 8, 9, 7, 8, 9, 7, 8], 2),
    (1, 2, [7, 8, 9, 7, 8, 9, 7, 8], 0),
    (1, 2, [5, 6, 11, 12, 13, 14, 5, 6, 1, 5, 6], 4),
    (1, 2, [5, 6, 11, 12, 13, 14, 5, 6, 1, 5, 6], 3),
    (2, 3, [4, 9, 1, 4], 2),
    (1, 4, [3], 2),
    (1, 4, [8, 8, 8, 8, 8], 7),
]


@pytest.mark.parametrize("min_n,max_n,ctx,k", NGRAM_CASES)
def test_ngram_proposer_matches_reference(min_n, max_n, ctx, k):
    ctx = np.asarray(ctx, np.int32)
    want = JNgram(min_n, max_n).propose(ctx, k)
    got = NgramProposer(min_n, max_n).propose(ctx, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("drafts,targets", [
    ([1, 2, 3], [1, 2, 3, 9]), ([1, 2, 3], [1, 9, 3, 4]), ([5], [4, 4]),
    ([], [7]), ([2, 2], [2])])
def test_accept_drafts_matches_reference(drafts, targets):
    assert accept_drafts(drafts, targets) == jaccept(drafts, targets)


@pytest.mark.parametrize("make", [
    lambda m: m.NgramProposer(3, 2),
    lambda m: m.SpeculativeConfig(num_speculative_tokens=0),
    lambda m: m.SpeculativeConfig(proposer="draft_model").build_proposer(),
    lambda m: m.SpeculativeConfig(proposer="nope").build_proposer()])
def test_config_validation_matches_reference(make):
    import paddle_tpu.inference as jinf
    import paddle_tpu_torch.inference as tinf
    for mod in (jinf, tinf):
        with pytest.raises(ValueError):
            make(mod)


def test_config_builds_the_reference_proposers(gpts):
    cfg = SpeculativeConfig(num_speculative_tokens="5", ngram_min=2,
                            ngram_max=3)
    assert cfg.num_speculative_tokens == 5
    p = cfg.build_proposer()
    assert isinstance(p, NgramProposer) and (p.min_n, p.max_n) == (2, 3)
    own = NgramProposer()
    assert SpeculativeConfig(proposer=own).build_proposer() is own
    dm = SpeculativeConfig(proposer="draft_model",
                           draft_model=gpts[1]).build_proposer()
    assert isinstance(dm, DraftModelProposer) and dm.model is gpts[1]


# ---------------------------------------------------------------------------
# the engine with speculation, against the reference's, on the same traffic
# ---------------------------------------------------------------------------
class _Wrong:
    """Adversarial drafts: token ids the tiny models essentially never
    emit, so every draft is rejected and every step rolls back."""

    def propose(self, context, k):
        return np.full((k,), 1023, np.int32)


class _Exploding:
    def propose(self, context, k):
        raise RuntimeError("proposer boom")


def _proposer(base, impl):
    return type(impl.__name__, (base,), {"propose": impl.propose})()


def _spec(pkg, k=3, proposer=None):
    cfg = SpeculativeConfig if pkg == "torch" else JSpec
    if proposer is None:
        return cfg(num_speculative_tokens=k)
    return cfg(proposer=proposer, num_speculative_tokens=k)


def _submit_all(prompts, n_new):
    def drive(eng, pkg):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=n_new)
        return _drain(eng)
    return drive


def _one_by_one(prompts, n_new):
    def drive(eng, pkg):
        done = {}
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=n_new)
            done.update(_drain(eng))
        return done
    return drive


def _case_gpt_mixed(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (5, 9, 13)] + [_rep(rng)]
    return dict(drive=_submit_all(prompts, 12), prompts=prompts)


def _case_k7_repetitive(rng):
    prompts = [_rep(rng), _rep(rng), _rep(rng, 6, 3)]
    return dict(drive=_submit_all(prompts, 16), prompts=prompts, k=7)


def _case_llama(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (6, 11)] + [_rep(rng, 6, 3)]
    return dict(drive=_submit_all(prompts, 8), prompts=prompts,
                model="llama")


def _case_preemption(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (17, 18)]
    return dict(drive=_submit_all(prompts, 20), prompts=prompts,
                kw=dict(block_size=8, num_blocks=9),
                expect=lambda st: st["preemptions"] >= 1)


def _case_lru_pressure(rng):
    shared = rng.integers(0, 1024, (16,)).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.integers(0, 1024, (4,))]),
        rng.integers(0, 1024, (20,)), rng.integers(0, 1024, (20,)),
        np.concatenate([shared, rng.integers(0, 1024, (6,))])]
    prompts = [p.astype(np.int32) for p in prompts]
    return dict(drive=_one_by_one(prompts, 12), prompts=prompts,
                kw=dict(max_batch=1, block_size=8, num_blocks=8))


def _case_int8(rng):
    prompts = [rng.integers(0, 1024, (8,)).astype(np.int32),
               _rep(rng, 6, 3)]
    return dict(drive=_submit_all(prompts, 8), prompts=prompts, int8=True)


def _case_rejected(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (5, 9, 13)]
    return dict(drive=_submit_all(prompts, 10), prompts=prompts,
                proposer=_Wrong,
                expect=lambda st: st["spec_drafted_tokens"] > 0
                == st["spec_accepted_tokens"])


def _case_raising_proposer(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (5, 9)]
    return dict(drive=_submit_all(prompts, 8), prompts=prompts,
                proposer=_Exploding,
                expect=lambda st: st["spec_proposer_errors"] > 0
                and st["spec_steps"] == 0)


def _case_verify_fault(rng):
    prompt = _rep(rng)

    def drive(eng, pkg):
        (jfaults if pkg == "jax" else faults).inject(
            "engine.verify.seq", exc=RuntimeError("verify boom"), times=1)
        eng.add_request("a", prompt, max_new_tokens=12)
        return _drain(eng)
    return dict(drive=drive, prompts={"a": prompt},
                expect=lambda st: st["spec_step_errors"] == 1
                and st["decode_chunks"] >= 1 and st["spec_steps"] >= 1)


def _case_self_draft(rng):
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (5, 9)]
    return dict(drive=_submit_all(prompts, 12), prompts=prompts,
                proposer="self",
                expect=lambda st: st["spec_drafted_tokens"]
                == st["spec_accepted_tokens"] > 0)


def _case_deadline(rng):
    prompt = _rep(rng)
    neighbor = rng.integers(0, 1024, (9,)).astype(np.int32)

    def drive(eng, pkg):
        t = [0.0]
        eng._now = lambda: t[0]
        eng.add_request("slow", prompt, max_new_tokens=16, deadline_s=5.0)
        eng.add_request("n", neighbor, max_new_tokens=12)
        done = {r.request_id: r for r in eng.step()}
        t[0] = 10.0                     # the TTL elapses mid-generation
        done.update(_drain(eng))
        return done
    return dict(drive=drive, prompts={"slow": prompt, "n": neighbor},
                expect=lambda st: st["deadline_expired"] == 1)


def _case_shed_load(rng):
    prompts = [rng.integers(0, 1024, (6,)).astype(np.int32)
               for _ in range(4)]
    return dict(drive=_submit_all(prompts, 4), prompts=prompts,
                kw=dict(shed_load=True, max_waiting=1),
                expect=lambda st: st["rejected_requests"] > 0)


SPEC_CASES = {
    "gpt_mixed": _case_gpt_mixed, "k7_repetitive": _case_k7_repetitive,
    "llama_rope": _case_llama, "preemption": _case_preemption,
    "lru_pressure": _case_lru_pressure, "int8_pools": _case_int8,
    "all_rejected": _case_rejected,
    "raising_proposer": _case_raising_proposer,
    "verify_fault": _case_verify_fault, "self_draft": _case_self_draft,
    "deadline": _case_deadline, "shed_load": _case_shed_load,
}


def _serve_both(case, jm, tm, seed):
    """Run `case` on both engines; returns (reference engine, port
    engine, reference results, port results, prompts by id)."""
    c = case(np.random.default_rng(seed))
    runs = []
    for pkg, model in (("jax", jm), ("torch", tm)):
        prop = c.get("proposer")
        if prop == "self":
            prop = (JDraftModel if pkg == "jax" else DraftModelProposer)(
                model)
        elif prop is not None:
            prop = _proposer(JDraftProposer if pkg == "jax"
                             else DraftProposer, prop)
        kw = dict(ENGINE_KW, **c.get("kw", {}))
        if c.get("int8"):
            calib = jcalibrate if pkg == "jax" else calibrate_kv_scales
            kw["kv_quant_scales"] = calib(model, c["prompts"][0][None])
        spec = _spec(pkg, c.get("k", 3), prop)
        if pkg == "jax":
            eng = JaxEngine(model, speculative_config=spec, **kw)
        else:
            eng = LLMEngine(model, speculative_config=spec, device="cpu",
                            **kw)
        runs.append((eng, c["drive"](eng, pkg)))
    prompts = c["prompts"]
    if not isinstance(prompts, dict):
        prompts = dict(enumerate(prompts))
    return runs[0][0], runs[1][0], runs[0][1], runs[1][1], prompts, c


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_spec_engine_matches_reference(name, gpts, llamas):
    case = SPEC_CASES[name]
    jm, tm = llamas if name == "llama_rope" else gpts
    je, te, jres, tres, prompts, c = _serve_both(case, jm, tm, seed=17)
    assert dict(je.stats) == te.stats
    assert te.peak_used_blocks == je.peak_used_blocks
    assert te.cache.available_blocks == je.cache.available_blocks \
        == te.cache.allocator.num_blocks - 1
    assert te.stats["spec_steps"] > 0 or name == "raising_proposer"
    if "expect" in c:
        assert c["expect"](te.stats), te.stats
    assert sorted(tres, key=str) == sorted(jres, key=str)
    for rid, jr in jres.items():
        tr = tres[rid]
        assert (tr.finish_reason, tr.ok, tr.error) == \
            (jr.finish_reason, jr.ok, jr.error)
        if rid in prompts and len(jr.output_ids):
            assert_tokens_equal_guarded(tm, prompts[rid], jr.output_ids,
                                        tr.output_ids)
    if c.get("int8"):
        import torch
        assert te.cache.key_caches[0].dtype == torch.int8


def test_int8_spec_engine_equals_int8_spec_off(gpts):
    """The reference's bar for int8 pools: the verify wave dequantizes
    as the decode step does, so speculation on and off give the same
    tokens (exactly, on the CPU)."""
    _jm, tm = gpts
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 1024, (8,)).astype(np.int32),
               _rep(rng, 6, 3)]
    scales = calibrate_kv_scales(tm, prompts[0][None])
    off = LLMEngine(tm, device="cpu", kv_quant_scales=scales, **ENGINE_KW)
    on = LLMEngine(tm, device="cpu", kv_quant_scales=scales,
                   speculative_config=SpeculativeConfig(), **ENGINE_KW)
    want = [r.output_ids for r in off.generate(prompts, 8)]
    got = [r.output_ids for r in on.generate(prompts, 8)]
    assert on.stats["spec_steps"] > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def test_verify_wave_failure_propagates(gpts, monkeypatch):
    """A failure raised by the verify wave's device function is not a
    poisoned request: it leaves step() and nothing degrades."""
    _jm, tm = gpts
    eng = LLMEngine(tm, device="cpu", speculative_config=SpeculativeConfig(),
                    **ENGINE_KW)
    eng.add_request("a", _rep(np.random.default_rng(3)), max_new_tokens=12)
    eng.step()                          # the prefill wave
    wave = eng._ragged_wave

    def broken(*args):
        if args[-1]:                    # all_pos: a verify wave
            raise RuntimeError("device failure")
        return wave(*args)

    monkeypatch.setattr(eng, "_ragged_wave", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        eng.step()
    assert eng.stats["spec_step_errors"] == 0
    assert eng.stats["decode_chunks"] == 0


def test_decode_chunk_failure_propagates(gpts, monkeypatch):
    """The same for the decode chunk: its launch raising leaves step()
    with no request evicted."""
    _jm, tm = gpts
    eng = LLMEngine(tm, device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(4)
    for i in range(2):
        eng.add_request(i, rng.integers(0, 1024, (9,)), max_new_tokens=8)

    def broken(*args):
        raise RuntimeError("device failure")

    monkeypatch.setattr(eng, "_decode_chunk", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        eng.step()
    assert eng.stats["failed_requests"] == 0
    assert all(s is not None for s in eng.slots)


def test_sampling_refused(gpts):
    with pytest.raises(ValueError, match="greedy"):
        LLMEngine(gpts[1], device="cpu", do_sample=True,
                  speculative_config=SpeculativeConfig(), **ENGINE_KW)


def test_block_accounting_conserved_every_step(gpts):
    """After every step: free + parked + leased == num_blocks - 1 (the
    trash page), and no sequence holds more pages than its token budget
    allows."""
    _jm, tm = gpts
    rng = np.random.default_rng(11)
    eng = LLMEngine(tm, device="cpu", speculative_config=SpeculativeConfig(),
                    **ENGINE_KW)
    bs = eng.block_size
    for i, p in enumerate([_rep(rng),
                           rng.integers(0, 1024, (9,)).astype(np.int32)]):
        eng.add_request(i, p, max_new_tokens=12)
    steps = 0
    while eng.has_unfinished:
        eng.step()
        steps += 1
        nb = eng.cache.allocator.num_blocks
        leased = sum(len(v) for v in eng.cache._pages.values())
        assert eng.cache.allocator.num_free + eng.cache.lru_pages \
            + leased == nb - 1
        for s in eng.slots:
            if s is not None:
                assert len(eng.cache.pages(s.rid)) <= \
                    -(-s.token_budget // bs)
    assert steps > 2 and eng.stats["spec_steps"] > 0
    assert eng.cache.available_blocks == eng.cache.allocator.num_blocks - 1


def test_rejected_blocks_never_enter_prefix_index(gpts):
    """Rejected drafts rolled back every step: a second identical
    request hits the prefix index and gets the same tokens, and every
    hash-indexed page belongs to a committed chain."""
    from paddle_tpu_torch.models import generate
    _jm, tm = gpts
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 1024, (18,)).astype(np.int32)
    eng = LLMEngine(tm, device="cpu", speculative_config=SpeculativeConfig(
        proposer=_proposer(DraftProposer, _Wrong)),
        **dict(ENGINE_KW, max_batch=1))
    eng.add_request("a", prompt, max_new_tokens=14)
    out1 = _drain(eng)["a"].output_ids
    hits0 = eng.stats["prefix_cache_hit_tokens"]
    eng.add_request("b", prompt, max_new_tokens=14)
    out2 = _drain(eng)["b"].output_ids
    want = generate(tm, prompt[None], max_new_tokens=14,
                    device="cpu").numpy()[0, len(prompt):]
    np.testing.assert_array_equal(out1, want)
    np.testing.assert_array_equal(out2, want)
    assert eng.stats["prefix_cache_hit_tokens"] > hits0
    assert eng.stats["spec_accepted_tokens"] == 0
    assert eng.cache.cached_pages == len(eng.cache._hash_to_page)
    assert set(eng.cache._page_hash.values()) == \
        set(eng.cache._hash_to_page.keys())


def test_truncate_releases_pages_and_guards():
    cache = PagedKVCache(num_layers=1, num_blocks=8, kv_heads=1,
                         block_size=4, head_dim=8, layout="token",
                         device="cpu")
    cache.add_sequence("s", 10)          # 3 pages
    assert cache.truncate("s", 5) == 1
    assert cache.length("s") == 5 and len(cache.pages("s")) == 2
    assert cache.allocator.num_free == 6
    assert cache.truncate("s", 5) == 0   # idempotent at the same length
    with pytest.raises(ValueError):
        cache.truncate("s", 6)           # growing is extend()'s job
    cache.free_sequence("s")
    assert cache.allocator.num_free == 8

    cache = PagedKVCache(num_layers=1, num_blocks=8, kv_heads=1,
                         block_size=4, head_dim=8, layout="token",
                         enable_prefix_caching=True, device="cpu")
    toks = np.arange(10, dtype=np.int32)
    cache.add_sequence("s", 10, tokens=toks)
    cache.commit_prefix("s", toks)       # 2 full blocks committed
    with pytest.raises(ValueError, match="committed prefix"):
        cache.truncate("s", 7)
    cache.truncate("s", 9)               # above the chain: fine
    cache.free_sequence("s")
