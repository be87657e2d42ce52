"""The port's decode executables on the card: LLMEngine's decode-step
graphs and `generate(use_fused_step=True)`'s prefill and decode-step
graphs, against the same steps run eagerly on the card. Every test here
is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph_cuda.py

A graph replays the kernels its eager step launched, on the same
inputs, so greedy tokens are compared exactly. Sampled tokens are too:
a generator registered with a graph (CUDAGraph.register_generator_state)
advances at each replay by the Philox offsets the captured kernels
consumed, and each replay reads the generator's state when it starts,
so the graphs draw the same numbers as the eager steps from the same
seed, not only numbers of the same distribution.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMEngine, llm_engine
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generate, gpt_tiny, llama_tiny)

pytestmark = pytest.mark.cuda

# the CPU engine tests' traffic: a shared prefix, and a pool small enough
# to preempt mid-decode (tests/test_torch_llm_engine.py)
ENGINE_KW = dict(max_batch=3, block_size=8, num_blocks=11, decode_chunk=4,
                 prompt_quantum=16, max_model_len=64)
N_NEW = 14
SAMPLING = dict(do_sample=True, temperature=0.8, top_p=0.9, top_k=50,
                seed=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _model(family, dtype):
    """2 layers at head_dim 64, which B3's kernels take (LLaMA with
    GQA, 4 heads over 2 kv heads)."""
    cls, cfg = {"gpt": (GPTForCausalLM, gpt_tiny),
                "llama": (LlamaForCausalLM, llama_tiny)}[family]
    cfg = dataclasses.replace(cfg(), hidden_size=256)
    return cls(cfg, device="cuda", dtype=dtype, seed=0)


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 1024, (n,))])
            .astype(np.int32) for n in (3, 5, 9, 2, 7, 4)]


def _serve(model, eager, prompts=None, n_new=N_NEW, **kw):
    """(engine, outputs, [(pages the chunk reaches, its table's width
    bucket)] a decode step) for the traffic, the decode steps run as
    graphs or eagerly on the card."""
    eng = LLMEngine(model, **{**ENGINE_KW, **kw})
    eng._eager_decode = eager
    widths = []
    chunk_fn = eng._decode_chunk

    def recorded(cur, lens, tbl, chunk):
        reach = -(-int(lens.max() + chunk) // eng.block_size)
        widths.extend([(reach, tbl.shape[1])] * chunk)
        return chunk_fn(cur, lens, tbl, chunk)

    eng._decode_chunk = recorded
    res = eng.generate(prompts or _prompts(), max_new_tokens=n_new)
    return eng, [r.output_ids for r in res], widths


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_graphs_equal_eager_steps(cuda_device, family, dtype):
    """Greedy: the graphs' tokens are the eager steps'; the run preempts
    mid-decode and resumes on the graphs captured before, one graph a
    width bucket, every decode step a replay."""
    model = _model(family, dtype)
    _e, want, w_want = _serve(model, eager=True)
    cuda_graph.reset_counters()
    eng, got, w_got = _serve(model, eager=False)
    assert eng.stats["preemptions"] >= 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert w_got == w_want
    assert cuda_graph.replays["engine_decode"] == len(w_got)
    buckets = {b for _r, b in w_got}
    assert cuda_graph.captures["engine_decode"] == len(buckets) \
        == len(eng._dec_graphs)


def test_engine_sampled_graphs_equal_eager_steps(cuda_device):
    model = _model("llama", "float32")
    _e, want, _w = _serve(model, eager=True, **SAMPLING)
    _e, got, _w = _serve(model, eager=False, **SAMPLING)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    # the draws depend on the seed
    _e, other, _w = _serve(model, eager=False, **{**SAMPLING, "seed": 4})
    assert any(not np.array_equal(a, b) for a, b in zip(got, other))


def test_engine_captures_one_graph_per_width_bucket(cuda_device):
    """Long rows over small pages meet many table widths: the graphs
    captured are the bucket rule's, fewer than the widths."""
    model = _model("gpt", "float32")
    kw = dict(block_size=4, num_blocks=97, max_model_len=128)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 1024, (n,)).astype(np.int32)
               for n in (5, 40, 70)]
    cuda_graph.reset_counters()
    eng, _got, w = _serve(model, eager=False, prompts=prompts, n_new=50,
                          **kw)
    reached = {r for r, _b in w}
    buckets = {b for _r, b in w}
    assert buckets == {llm_engine._width_bucket(r, eng.npb_full)
                       for r in reached}
    assert len(buckets) < len(reached)
    assert cuda_graph.captures["engine_decode"] == len(buckets)
    assert cuda_graph.replays["engine_decode"] == len(w)


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_generate_equals_eager_loop(cuda_device, family, dtype):
    model = _model(family, dtype)
    rng = np.random.default_rng(2)
    p = rng.integers(0, 1024, (2, 9)).astype(np.int32)
    eos = int(generate(model, p, max_new_tokens=8,
                       use_fused_step=False)[0, 9 + 3])
    model.__dict__.pop("_fused_decode_loops", None)
    cuda_graph.reset_counters()
    for kw in (dict(), dict(eos_token_id=eos), SAMPLING):
        eager = generate(model, p, max_new_tokens=12, use_fused_step=False,
                         **kw)
        fused = generate(model, p, max_new_tokens=12, **kw)
        again = generate(model, p, max_new_tokens=12, **kw)
        torch.testing.assert_close(fused, eager, rtol=0, atol=0)
        torch.testing.assert_close(again, eager, rtol=0, atol=0)
    # one prefill and one step graph a key; every later call replays
    assert cuda_graph.captures["generate_prefill"] == 3
    assert cuda_graph.captures["generate_decode"] == 3
    assert cuda_graph.replays["generate_prefill"] == 6
    assert cuda_graph.replays["generate_decode"] == 6 * 11
    # a shorter prompt in the same cache bucket replays the same step
    generate(model, p[:, :5], max_new_tokens=12)
    assert cuda_graph.captures["generate_decode"] == 3
    assert cuda_graph.captures["generate_prefill"] == 4


@pytest.mark.parametrize("heads", [(4, 2), (8, 8), (8, 1)],
                         ids=["gqa", "mha", "mqa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_the_card_equals_cpu(cuda_device, heads, dtype):
    """The engine's decode attention: on the card half-precision
    operands are multiplied into f32 by cuBLAS, on the CPU they are
    widened first. A p rounded the other way moves an output by at most
    one bf16 ulp of p (2^-7 of it) times |v|; the f32 sums' order adds
    ~1e-6."""
    H, kvH = heads
    D, bs, NB, B, P = 64, 8, 40, 5, 6
    g = torch.Generator().manual_seed(0)
    kp = torch.randn(NB * bs, kvH, D, generator=g).to(dtype)
    vp = torch.randn(NB * bs, kvH, D, generator=g).to(dtype)
    q = torch.randn(B, H, D, generator=g).to(dtype)
    tbl = torch.randperm(NB, generator=g)[:B * P].reshape(B, P)
    lens = torch.tensor([0, 7, 8, 30, P * bs - 1])
    args = (q, kp, vp, tbl, lens)
    want = llm_engine._pool_decode_attention(*args, 0.125, bs)
    got = llm_engine._pool_decode_attention(
        *(a.to(cuda_device) for a in args), 0.125, bs).cpu()
    assert got.dtype == want.dtype == torch.float32
    tol = 2.0 ** -7 * float(vp.float().abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol
    # a kv head's block taken from the wrong head is far outside it
    wrong = want.reshape(B, kvH, H // kvH, D).roll(1, dims=1).reshape(B, -1)
    if kvH > 1:
        assert float((got - wrong).abs().max()) > 10 * tol


def test_capture_survives_a_dead_cycle_holding_a_graph(cuda_device):
    """A graph kept only by a dead reference cycle is freed by the
    cyclic collector, not during another graph's capture (the collector
    runs at every allocation here)."""
    x = torch.zeros(4, device=cuda_device)

    class Holder:
        pass

    for _ in range(3):
        h = Holder()
        h.me = h
        h.graph = cuda_graph.CapturedStep("test", lambda: x.add_(1))
        del h
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        step = cuda_graph.CapturedStep("test", lambda: x.mul(2))
    finally:
        gc.set_threshold(*thresholds)
    x.fill_(3)
    torch.testing.assert_close(step.replay(), torch.full_like(x, 6))
