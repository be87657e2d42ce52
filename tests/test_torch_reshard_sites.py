"""The reshard sites and the shard plans of model parallelism
(paddle_tpu_torch.distributed.meta_parallel, models.shard_plans, ROADMAP
item 26b) against the reference's: tests/test_comms_obs.py's
``TestReshardSites`` (the sequence-parallel boundaries: the same
launches, bytes and zero-duration markers, no latency histogram), the
pipeline's ``pp_transfer`` records of a stage transfer and of its
cotangent, and the Megatron shard plans (equal PartitionSpecs, printed
alike)."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu import observability as jobs
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg
from torch_port_helpers import cpu_place

SIDES = {"ref": (pt, jdist, jobs), "port": (ptt, tdist, tobs)}


@pytest.fixture(autouse=True)
def _reset():
    for _, d, obs in SIDES.values():
        d.destroy_process_group()
        obs.disable()
        obs.reset()
    jset_hcg(None)
    tset_hcg(None)
    with cpu_place():
        yield
    for _, d, obs in SIDES.values():
        d.destroy_process_group()
        obs.disable()
        obs.reset()
    jset_hcg(None)
    tset_hcg(None)


def _init(d, **degrees):
    strategy = d.fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    d.fleet.init(strategy=strategy)


def _nonzero(obs, name):
    rec = obs.snapshot().get(name)
    out = {}
    for key, val in (rec["series"] if rec else {}).items():
        if isinstance(val, dict):
            if val["count"]:
                out[key] = val
        elif val:
            out[key] = val
    return out


def _markers(obs):
    return [(e["args"]["op"], e["args"]["group"], e["args"]["bytes"],
             e["dur"]) for e in obs.trace_events()
            if e["name"] == "comms.reshard"]


def test_sequence_parallel_notes_reshards():
    """tests/test_comms_obs.py::TestReshardSites on both packages at
    mp 8: one reshard launch of each op, its bytes, zero-duration
    markers, no latency histogram."""
    got = {}
    x = np.ones((2, 8, 4), np.float32)
    for name, (P, d, obs) in SIDES.items():
        _init(d, dp=1, mp=8, pp=1)
        sp = d.meta_parallel.sequence_parallel
        obs.enable()
        sp.scatter(x)
        sp.all_gather(x)
        sp.reduce_scatter(x)
        launches = _nonzero(obs, "paddle_tpu_collective_launches_total")
        assert launches[("scatter", "reshard")] == 1.0
        assert launches[("all_gather", "reshard")] == 1.0
        assert launches[("reduce_scatter", "reshard")] == 1.0
        assert _nonzero(obs, "paddle_tpu_collective_seconds") == {}
        got[name] = (launches,
                     _nonzero(obs, "paddle_tpu_collective_bytes_total"),
                     _markers(obs))
        obs.disable()
    assert got["port"] == got["ref"]
    assert {m[0] for m in got["port"][2]} == {"scatter", "all_gather",
                                              "reduce_scatter"}
    assert all(m[3] == 0.0 for m in got["port"][2])


def test_pipeline_transfer_notes_reshards():
    """pp 2: a forward and backward through a PipelineLayer records each
    stage transfer ("pp_transfer", the destination stage, the
    activation's bytes) as the reference's does."""
    got = {}
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(
        np.float32)
    for name, (P, d, obs) in SIDES.items():
        _init(d, pp=2)
        mp = d.meta_parallel
        model = mp.PipelineLayer(
            layers=[mp.LayerDesc(P.nn.Linear, 16, 16),
                    mp.LayerDesc(P.nn.Linear, 16, 8)], loss_fn=None)
        obs.enable()
        xt = P.to_tensor(x, stop_gradient=False)
        P.ops.mean(model(xt) ** 2).backward()
        got[name] = (_nonzero(obs, "paddle_tpu_collective_launches_total"),
                     _nonzero(obs, "paddle_tpu_collective_bytes_total"),
                     _markers(obs))
        obs.disable()
        assert xt.grad is not None
    assert got["port"] == got["ref"]
    assert got["port"][2] == [("pp_transfer", "stage1", 4 * 16 * 4, 0.0)]


def test_shard_plans_equal_the_reference():
    from paddle_tpu.models import shard_plans as jplans
    from paddle_tpu_torch.models import shard_plans as tplans
    names = ["gpt.embeddings.word_embeddings.weight",
             "gpt.embeddings.position_embeddings.weight",
             "gpt.layers.0.attn.qkv_proj.weight",
             "gpt.layers.0.attn.qkv_proj.bias",
             "gpt.layers.0.attn.out_proj.weight",
             "gpt.layers.0.mlp.fc1.weight", "gpt.layers.0.mlp.fc2.bias",
             "lm_head.weight", "llama.embed_tokens.weight",
             "layers.0.self_attn.q_proj.weight", "layers.0.mlp.up_proj.weight",
             "layers.0.self_attn.o_proj.weight", "norm.weight"]
    for fn in ("gpt_tp_rules", "llama_tp_rules", "fsdp_rules"):
        for n in names:
            for shape in ((8, 4), (4, 8), (4,), ()):
                got = getattr(tplans, fn)(n, shape)
                want = getattr(jplans, fn)(n, shape)
                assert got == want and repr(got) == repr(want), (fn, n)
