"""paddle_tpu_torch LLMEngine against paddle_tpu's LLMEngine and against
the port's own dense `generate`.

The traffic shares a page-aligned prefix (so the second admission wave
resumes from the prefix cache through the with_pool ragged launch) and
the pool is small enough to force preemption. The scheduler's integer
record (`stats`) must be EXACTLY equal across the two engines; greedy
tokens must be equal under the logit-margin guard (torch_port_helpers).
"""
import numpy as np
import pytest

from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import generate
from torch_port_helpers import assert_tokens_equal_guarded, twin_gpts

STAT_KEYS = ("prefills", "preemptions", "decode_chunks", "decode_tokens",
             "prefix_cache_hit_tokens", "prefix_cache_miss_tokens",
             "ragged_launches")
ENGINE_KW = dict(max_batch=3, block_size=8, num_blocks=11, decode_chunk=4,
                 prompt_quantum=16, max_model_len=64)
N_NEW = 14


@pytest.fixture(scope="module")
def served():
    jm, tm = twin_gpts()
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 1024, (16,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 1024, (n,))])
               .astype(np.int32) for n in (3, 5, 9, 2, 7, 4)]
    je = JaxEngine(jm, **ENGINE_KW)
    jres = je.generate(prompts, max_new_tokens=N_NEW)
    te = LLMEngine(tm, device="cpu", **ENGINE_KW)
    tres = te.generate(prompts, max_new_tokens=N_NEW)
    return dict(tm=tm, prompts=prompts, je=je, te=te, jres=jres,
                tres=tres)


def test_scheduler_stats_equal_exactly(served):
    js, ts = served["je"].stats, served["te"].stats
    assert {k: js[k] for k in STAT_KEYS} == {k: ts[k] for k in STAT_KEYS}
    # the traffic exercised what it is meant to
    assert ts["preemptions"] >= 1
    assert ts["prefix_cache_hit_tokens"] > 0
    assert served["te"].peak_used_blocks == served["je"].peak_used_blocks
    assert served["te"].cache.available_blocks == \
        served["je"].cache.available_blocks


def test_greedy_outputs_equal_paddle_tpu(served):
    for p, jr, tr in zip(served["prompts"], served["jres"],
                         served["tres"]):
        assert tr.finish_reason == jr.finish_reason == "length"
        assert len(tr.output_ids) == N_NEW
        assert assert_tokens_equal_guarded(
            served["tm"], p, jr.output_ids, tr.output_ids) > 0


def test_engine_equals_port_dense_generate(served):
    tm = served["tm"]
    for p, tr in zip(served["prompts"], served["tres"]):
        dense = generate(tm, p[None], max_new_tokens=N_NEW,
                         device="cpu").numpy()[0, len(p):]
        assert assert_tokens_equal_guarded(tm, p, dense,
                                           tr.output_ids) > 0
