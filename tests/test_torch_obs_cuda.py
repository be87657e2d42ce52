"""The port's observability, profiler and device memory on the card.
Every test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_obs_cuda.py

A counter around a CUDA graph's replay counts every replay (a recorder
inside the captured function would run at the capture only); the
capture is the family's compile; device.memory equals torch.cuda's;
a Profiler session's device events name the hand-written kernels B3
(rpa_sm90) and B1 (flash_fwd_sm90); the engine's and TrainStep's
rooflines on the H100's peaks lie in (0, 1.05]."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import device as pdev
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.observability import perf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, the caching "
                    "allocator and CUPTI are the card's)")
    obs.disable()
    obs.reset()
    yield torch.device("cuda", torch.cuda.current_device())
    obs.disable()
    obs.reset()


def _series(name):
    rec = obs.snapshot().get(name, {"series": {}})
    return {k: v for k, v in rec["series"].items() if v}


def test_counter_around_a_captured_step_counts_every_replay(card):
    obs.enable()
    x = torch.zeros(16, device=card)
    hits = obs.registry().counter("paddle_tpu_t_replays_total", "replays")
    inside = obs.registry().counter("paddle_tpu_t_inside_total", "inside")

    def fn():
        inside.inc()            # Python of the captured function
        x.add_(1.0)
        return x

    cost = perf.count_cost("optimizer_fused", elements=16,
                           update_bytes=128)
    step = cuda_graph.CapturedStep("t_family", fn,
                                   pool=torch.cuda.graph_pool_handle(),
                                   expected=cost)
    for _ in range(5):
        step.replay()
        hits.inc()
    torch.cuda.synchronize()
    assert _series("paddle_tpu_t_replays_total") == {(): 5.0}
    # the warm-up run and the capture ran the Python; no replay did
    assert _series("paddle_tpu_t_inside_total") == {(): 2.0}
    assert float(x[0]) == 1.0 + 5   # the warm-up's add, then 5 replays
    assert _series("paddle_tpu_compile_total") == {
        ("t_family", "compile"): 1.0}
    assert step.expected is cost
    assert _series("paddle_tpu_executable_flops") == {
        ("t_family",): 17.0 * 16}


def test_memory_functions_equal_torch_cuda(card):
    m = pdev.memory
    for _ in range(2):
        m.reset_max_memory_allocated()
        base = (m.max_memory_allocated(), torch.cuda.max_memory_allocated())
        held = torch.empty(1 << 26, dtype=torch.uint8, device=card)
        assert m.memory_allocated() == torch.cuda.memory_allocated()
        assert m.max_memory_allocated() == torch.cuda.max_memory_allocated()
        assert m.memory_reserved() == torch.cuda.memory_reserved()
        assert m.max_memory_reserved() == torch.cuda.max_memory_reserved()
        st = m.memory_stats()
        assert st["bytes_in_use"] == st["allocated_bytes.all.current"]
        assert st["peak_bytes_in_use"] == st["allocated_bytes.all.peak"]
        assert st["bytes_limit"] == \
            torch.cuda.get_device_properties(card).total_memory
        assert base[0] == base[1]
        assert m.max_memory_allocated() >= base[0] + (1 << 26)
        del held
    assert pdev.cuda.max_memory_allocated(0) == \
        torch.cuda.max_memory_allocated(0)
    s = pdev.Stream()
    e = pdev.Event(enable_timing=True)
    e0 = pdev.Event(enable_timing=True)
    with pdev.stream_guard(s):
        e0.record()
        torch.ones(1 << 20, device=card).sum()
        e.record()
    e.synchronize()
    assert e0.elapsed_time(e) >= 0 and e.query()
    pdev.synchronize()


def _tiny_gpt(card, dtype):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    # head_dim 64 in bf16: the sm90 designs of B1 and B3
    return GPTForCausalLM(GPTConfig(
        vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4,
        max_position_embeddings=256, hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0, use_flash_attention=True),
        dtype=dtype, seed=0, device=card)


def _named(evs, name):
    return sum(e.get("cat") == "kernel" and name in e["name"] for e in evs)


def test_profiler_device_events_name_b3_and_b1(card):
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.nn import functional as F
    model = _tiny_gpt(card, "bfloat16")
    eng = LLMEngine(model, max_batch=2, block_size=16, decode_chunk=4,
                    prompt_quantum=16, max_model_len=128)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 128, 4, 64))).to(
        card, torch.bfloat16)
    F.flash_attention(q, q, q, causal=True)         # built before
    eng.add_request(0, rng.integers(0, 1024, (20,)), max_new_tokens=4)
    with profiler.Profiler() as prof:
        eng.step()                                  # a packed wave: B3
        F.flash_attention(q, q, q, causal=True)     # B1
    evs = prof.events()
    assert _named(evs, "rpa_sm90") >= 2             # one a layer
    assert _named(evs, "flash_fwd_sm90") >= 1
    host = {e["name"] for e in evs if "cat" not in e}
    assert {"engine.step", "engine.prefill", "engine.ragged"} <= host
    # device events sit on the host spans' clock: inside the session
    t0 = min(e["ts"] for e in evs if "cat" not in e)
    t1 = max(e["ts"] + e["dur"] for e in evs if "cat" not in e)
    k = [e for e in evs if _named([e], "rpa_sm90")]
    assert all(t0 - 1e4 <= e["ts"] <= t1 + 1e4 for e in k)


def test_profiler_refuses_to_start_inside_a_capture(card):
    g = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device=card)
    x.add_(1)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g):
            x.add_(1)
            profiler.Profiler().start()


def test_engine_and_train_step_rooflines_on_the_card(card):
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    assert perf.device_peaks() is not None
    obs.enable()
    cuda_graph.reset_counters()
    model = _tiny_gpt(card, "bfloat16")
    eng = LLMEngine(model, max_batch=2, block_size=16, decode_chunk=4,
                    prompt_quantum=16, max_model_len=128)
    rng = np.random.default_rng(1)
    for i in range(2):
        eng.add_request(i, rng.integers(0, 1024, (20,)), max_new_tokens=9)
    while eng.has_unfinished:
        eng.step()
    tm = _tiny_gpt(card, "float32")
    crit = GPTPretrainingCriterion()
    step = TrainStep(tm, AdamW(learning_rate=1e-3,
                               parameters=tm.parameters()),
                     lambda m, i, l: crit(m(i), l))
    ids = rng.integers(0, 1024, (2, 128)).astype(np.int32)
    for _ in range(4):
        step(ids, ids)
    torch.cuda.synchronize()
    step._read_timings()
    compiles = _series("paddle_tpu_compile_total")
    assert compiles == {(f, "compile"): float(n) for f, n in
                        cuda_graph.captures.items()}
    assert set(compiles) == {("engine_decode", "compile"),
                             ("train_step", "compile")}
    roof = _series("paddle_tpu_roofline_utilization")
    assert {f for f, _b in roof} == {"engine_decode", "engine_ragged",
                                     "train_step"}
    assert all(0 < v <= 1.05 for v in roof.values())
    # the calls after the capture, each read once completed
    assert perf.family_records()["train_step"]["runs"] == 3
