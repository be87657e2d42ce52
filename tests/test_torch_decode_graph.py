"""The port's decode executables on the CPU: LLMEngine's decode step at
a width-bucketed page table, and `generate(use_fused_step=True)`.

On the card both run as CUDA graphs (tests/test_torch_decode_graph_cuda.py
holds them to the eager steps there); on the CPU the same step functions
run eagerly, so these tests pin their arithmetic and the host rules
around them:
  * a trash-padded table of any bucketed width gives exactly the tokens
    of the unpadded one (the padding lies past every row's length);
  * the width bucket rule keeps the serving runs' graphs few and their
    padding under a quarter of the table;
  * `generate(use_fused_step=True)` gives exactly the eager loop's
    tokens, and the reference's fused `generate` tokens under the
    logit-margin guard (torch_port_helpers), greedy, with an eos.
"""
import collections
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import llm_engine
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny
from torch_port_helpers import (assert_tokens_equal_guarded, twin_gpts,
                                twin_llamas)

# the engine tests' traffic: a shared prefix, and a pool small enough to
# preempt (tests/test_torch_llm_engine.py)
ENGINE_KW = dict(max_batch=3, block_size=8, num_blocks=11, decode_chunk=4,
                 prompt_quantum=16, max_model_len=64)
N_NEW = 14


@pytest.fixture(scope="module")
def gpt_twins():
    return twin_gpts()


@pytest.fixture(scope="module")
def llama_twins():
    return twin_llamas("tiny_gqa", seed=5)


def _models(request, family):
    return request.getfixturevalue(f"{family}_twins")


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 1024, (n,))])
            .astype(np.int32) for n in (3, 5, 9, 2, 7, 4)]


def _serve(tm, monkeypatch, rule):
    """Serve the engine tests' traffic with the width bucket rule
    `rule(width, cap)`; returns (outputs, widths the decode steps ran
    at, stats)."""
    widths = []
    monkeypatch.setattr(llm_engine, "_width_bucket", rule)
    eng = LLMEngine(tm, device="cpu", **ENGINE_KW)
    step = eng._decode_step

    def recorded(inp):
        widths.append(inp.shape[1] - 2)
        return step(inp)

    eng._decode_step = recorded
    res = eng.generate(_prompts(), max_new_tokens=N_NEW)
    return [r.output_ids for r in res], widths, eng.stats


RULES = {
    "unpadded": lambda width, cap: width,
    "bucket": llm_engine._width_bucket,
    "full table": lambda width, cap: cap,
}


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("rule", ["bucket", "full table"])
def test_padded_width_gives_the_unpadded_tokens(request, monkeypatch,
                                                family, rule):
    _jm, tm = _models(request, family)
    want, w_want, st_want = _serve(tm, monkeypatch, RULES["unpadded"])
    got, w_got, st_got = _serve(tm, monkeypatch, RULES[rule])
    assert st_want["preemptions"] >= 1
    assert st_got == st_want
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    # the rule really padded some steps' tables
    assert len(w_got) == len(w_want)
    assert all(g >= w for g, w in zip(w_got, w_want))
    if rule == "full table":
        assert any(g > w for g, w in zip(w_got, w_want))


def test_width_bucket_rule():
    for cap in (16, 32, 512):
        for width in range(1, cap + 1):
            got = llm_engine._width_bucket(width, cap)
            assert width <= got <= cap
            # the padding stays under a quarter of the table
            assert got - width < max(1, width / 4)
        # at most four buckets an octave (lo, 2 lo]
        for lo in (1, 2, 4, 8, 16, 32, 64):
            if 2 * lo <= cap:
                keys = {llm_engine._width_bucket(w, cap)
                        for w in range(lo + 1, 2 * lo + 1)}
                assert len(keys) <= 4


# chip_smoke.py's serving runs (phases 4 and 9): 16 requests of a
# 512-token prefix and 8-32 more tokens, 64 new tokens each, max_batch 8,
# 64-slot pages, 16-token chunks; gpt3_1p3b's 2048 positions and
# llama2_7b's max_model_len 1024
SERVING_RUNS = {"phase 4 (gpt3_1p3b)": 2048, "phase 9 (llama2_7b)": 1024}
MAX_SERVING_GRAPHS = 4


@pytest.mark.parametrize("run", list(SERVING_RUNS))
def test_serving_runs_capture_few_graphs(monkeypatch, run):
    """The scheduler at the serving runs' lengths (the model's work
    replaced by constant tokens: only the host decisions run): the
    width buckets its decode chunks take are the graphs the run
    captures, and their padding adds under a quarter to the slots each
    step attends over."""
    max_len = SERVING_RUNS[run]
    tm = GPTForCausalLM(dataclasses.replace(
        gpt_tiny(), max_position_embeddings=max_len), device="cpu")
    eng = LLMEngine(tm, device="cpu", max_batch=8, block_size=64,
                    decode_chunk=16, prompt_quantum=128,
                    max_model_len=max_len)
    chunks = []

    def decode_chunk(cur, lens, tbl, chunk):
        width = -(-int(lens.max() + chunk) // eng.block_size)
        chunks.append((width, tbl.shape[1]))
        return np.zeros((eng.max_batch, chunk), np.int32)

    monkeypatch.setattr(eng, "_decode_chunk", decode_chunk)
    monkeypatch.setattr(eng, "_run_ragged", lambda entries: {
        s.slot: np.zeros((1,), np.int32) for s, *_ in entries})
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 1024, (512,))
    for i, t in enumerate(rng.integers(8, 33, 16)):
        eng.add_request(i, np.concatenate(
            [prefix, rng.integers(0, 1024, (int(t),))]), max_new_tokens=64)
    done = []
    while eng.has_unfinished:
        done += eng.step()
    assert len(done) == 16 and all(len(r.output_ids) == 64 for r in done)
    keys = {w for _width, w in chunks}
    assert 1 <= len(keys) <= MAX_SERVING_GRAPHS, chunks
    for width, w in chunks:
        assert width <= w < 1.25 * width


def test_cpu_decode_captures_no_graph(gpt_twins, monkeypatch):
    cuda_graph.reset_counters()
    _serve(gpt_twins[1], monkeypatch, RULES["bucket"])
    assert not cuda_graph.captures and not cuda_graph.replays


def _greedy_eos(tm, p, n_new):
    """An eos id the greedy run of `p` reaches a few tokens in, so the
    run's tail is forced."""
    toks = generate(tm, p[None], max_new_tokens=n_new,
                    device="cpu").numpy()[0, len(p):]
    return int(toks[3])


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("sampling", [
    dict(), dict(do_sample=True, temperature=0.8, top_p=0.9, top_k=50,
                 seed=3)], ids=["greedy", "sampled"])
def test_fused_generate_equals_the_eager_loop(request, family, sampling):
    _jm, tm = _models(request, family)
    rng = np.random.default_rng(2)
    p = rng.integers(0, 1024, (2, 9)).astype(np.int32)
    eos = _greedy_eos(tm, p[0], 12)
    for kw in (dict(), dict(eos_token_id=eos)):
        fused = generate(tm, p, max_new_tokens=12, device="cpu",
                         **sampling, **kw)
        eager = generate(tm, p, max_new_tokens=12, device="cpu",
                         use_fused_step=False, **sampling, **kw)
        assert fused.dtype == torch.int32 and fused.shape == (2, 21)
        torch.testing.assert_close(fused, eager, rtol=0, atol=0)
    if not sampling:
        row = fused[0, 9:].numpy()
        first = int(np.flatnonzero(row == eos)[0])
        assert (row[first:] == eos).all() and first < len(row) - 1


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fused_generate_equals_reference(request, family):
    jm, tm = _models(request, family)
    rng = np.random.default_rng(5)
    for n in (7, 19):
        p = rng.integers(0, 1024, (n,)).astype(np.int32)
        eos = _greedy_eos(tm, p, 12)
        want = np.asarray(jax_generate(
            jm, pt.to_tensor(p[None]), max_new_tokens=12,
            eos_token_id=eos, use_fused_step=True).numpy())[0, n:]
        got = generate(tm, p[None], max_new_tokens=12, eos_token_id=eos,
                       device="cpu", use_fused_step=True).numpy()[0, n:]
        assert eos in want
        assert assert_tokens_equal_guarded(tm, p, want, got) > 0


def test_generate_has_the_reference_parameters():
    from paddle_tpu.models import generation as ref
    mine = inspect.signature(generate).parameters
    theirs = inspect.signature(ref.generate).parameters
    assert [n for n in mine if n != "device"] == list(theirs)
    assert mine["use_fused_step"].default is True
    assert theirs["use_fused_step"].default is True


def test_fused_loops_are_an_lru_of_eight(gpt_twins):
    _jm, tm = gpt_twins
    tm.__dict__.pop("_fused_decode_loops", None)
    p = np.arange(1, 6, dtype=np.int32)[None]
    for eos in range(10):
        generate(tm, p, max_new_tokens=3, eos_token_id=eos, device="cpu")
    loops = tm.__dict__["_fused_decode_loops"]
    assert isinstance(loops, collections.OrderedDict)
    assert [k[4] for k in loops] == list(range(2, 10))
    # a loop whose model's weights moved is built again
    loop = loops[next(reversed(loops))]
    generate(tm, p, max_new_tokens=3, eos_token_id=9, device="cpu")
    assert loops[next(reversed(loops))] is loop
    w = tm.gpt.final_norm.weight._data
    saved = w.data
    w.data = saved.clone()
    try:
        generate(tm, p, max_new_tokens=3, eos_token_id=9, device="cpu")
        assert loops[next(reversed(loops))] is not loop
    finally:
        w.data = saved
        tm.__dict__.pop("_fused_decode_loops", None)
