"""The training path's observability against the reference's: the
GradScaler's loss-scale gauge and step and decrease counters over
poisoned steps (tests/test_torch_amp_scaler.py's twin Linear layers,
AdamW on both sides), TrainStep's compile and ``train_step`` roofline
samples on a tiny GPT, and the optimizer's
``paddle_tpu_optimizer_fused_step_total``. Counts and label sets are
equal, except where the port differs by design, pinned here: the
reference counts a fused step's first call of a signature as a
"compile" and later ones as "hit"; the port builds no executable, so
each multi-tensor step is a "hit" and an optimizer without a
multi-tensor form (SGD) a "fallback". Durations are never compared."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.observability import perf as jperf
import paddle_tpu_torch as ptt
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import perf as tperf
from test_torch_amp_scaler import SCHEDULES, _Both
from torch_port_helpers import cpu_place, twin_gpts

OBS = {"ref": (jobs, jperf), "port": (tobs, tperf)}


@pytest.fixture(autouse=True)
def _clean():
    for obs, perf in OBS.values():
        obs.disable()
        obs.reset()
        perf.set_device_peaks()
    with cpu_place():
        yield
    for obs, perf in OBS.values():
        obs.disable()
        obs.reset()
        perf.set_device_peaks()


def _series(obs, name):
    """{labels: value or observation count} of one series, non-zero ones
    (earlier tests' registrations of the process-global registry read 0
    after a reset)."""
    rec = obs.snapshot().get(name)
    if rec is None:
        return {}
    out = {k: v["count"] if isinstance(v, dict) else v
           for k, v in rec["series"].items()}
    return {k: v for k, v in out.items() if v}


AMP_SERIES = ("paddle_tpu_amp_loss_scale", "paddle_tpu_amp_steps_total",
              "paddle_tpu_amp_scale_decreases_total")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_grad_scaler_series_equal_the_reference(name):
    kw, poisoned = SCHEDULES[name]
    for obs, _p in OBS.values():
        obs.enable()
    b = _Both(scaler_kw=kw)
    for i in range(8):
        b.step(poison=i in poisoned)
    got = {s: _series(tobs, s) for s in AMP_SERIES}
    assert got == {s: _series(jobs, s) for s in AMP_SERIES}
    assert got["paddle_tpu_amp_steps_total"] == {
        ("ok",): 8 - len(poisoned), ("skipped",): len(poisoned)}
    assert got["paddle_tpu_amp_loss_scale"] == {(): b.ts._scale}
    # the fused step: 'hit' for each step the optimizer ran (the port),
    # 'compile' then 'hit' (the reference)
    fused = "paddle_tpu_optimizer_fused_step_total"
    assert _series(tobs, fused) == {("hit",): 8 - len(poisoned)}
    ref = _series(jobs, fused)
    assert ref[("compile",)] == 1
    assert ref[("compile",)] + ref[("hit",)] == 8 - len(poisoned)


def test_grad_scaler_set_loss_scaling_and_static_scale():
    for obs, _p in OBS.values():
        obs.enable()
    b = _Both(scaler_kw=dict(use_dynamic_loss_scaling=False))
    b.step()
    b.js.set_loss_scaling(64.0)
    b.ts.set_loss_scaling(64.0)
    for s in AMP_SERIES:
        assert _series(tobs, s) == _series(jobs, s), s
    assert _series(tobs, "paddle_tpu_amp_loss_scale") == {(): 64.0}


@pytest.mark.parametrize("make", ["adamw_f32", "sgd_f32", "adamw_bf16"])
def test_optimizer_fused_step_counter(make):
    """3 Optimizer.step calls: AdamW over f32 parameters takes the
    multi-tensor update ('hit' each step); SGD has none ('fallback');
    bf16 parameters without masters are not a fused step on either
    side. The reference counts its executable cache's compile and
    hits."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    dtype = "bfloat16" if make.endswith("bf16") else "float32"
    cls = "AdamW" if make.startswith("adamw") else "SGD"
    for obs, _p in OBS.values():
        obs.enable()
    jp = pt.to_tensor(w).astype(dtype)
    jp.stop_gradient = False
    tp = torch.nn.Parameter(torch.from_numpy(w).to(getattr(torch, dtype)))
    jopt = getattr(pt.optimizer, cls)(learning_rate=0.1, parameters=[jp])
    topt = getattr(ptt.optimizer, cls)(learning_rate=0.1, parameters=[tp])
    for _ in range(3):
        (jp * jp).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tp.float() * tp.float()).sum().backward()
        topt.step()
        topt.clear_grad()
    fused = "paddle_tpu_optimizer_fused_step_total"
    got, ref = _series(tobs, fused), _series(jobs, fused)
    want = {"adamw_f32": {("hit",): 3}, "sgd_f32": {("fallback",): 3},
            "adamw_bf16": {}}[make]
    assert got == want
    assert ref == (
        {} if make == "adamw_bf16" else {("compile",): 1, ("hit",): 2})
    flops = _series(tobs, "paddle_tpu_executable_flops")
    assert flops == ({("optimizer_fused",): 17.0 * 16}
                     if make == "adamw_f32" else {})


def test_train_step_compile_and_roofline_samples():
    """4 TrainStep calls of one signature: one 'train_step' compile (the
    first call), and the roofline sampled from the third call on, as
    the reference samples it; no fused-step count (the step's update is
    the functional one on both sides)."""
    from paddle_tpu.jit import TrainStep as JStep
    from paddle_tpu.models import GPTPretrainingCriterion as JCrit
    from paddle_tpu_torch import TrainStep as TStep
    from paddle_tpu_torch.models import GPTPretrainingCriterion as TCrit
    jm, tm = twin_gpts(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jm.train()
    tm.train()
    ids = np.random.default_rng(1).integers(0, 1024, (2, 16)).astype(
        np.int32)
    out = {}
    for side, m, Step, Crit, opt_mod in (
            ("ref", jm, JStep, JCrit, pt.optimizer),
            ("port", tm, TStep, TCrit, ptt.optimizer)):
        obs, perf = OBS[side]
        perf.set_device_peaks(1e12, 1e11)
        obs.enable()
        crit = Crit()
        step = Step(m, opt_mod.AdamW(learning_rate=1e-3,
                                     parameters=m.parameters()),
                    lambda mm, i, l: crit(mm(i), l))
        for _ in range(4):
            step(ids, ids)
        rec = perf.family_records()["train_step"]
        out[side] = (
            _series(obs, "paddle_tpu_compile_total"),
            _series(obs, "paddle_tpu_compile_seconds"),
            rec["runs"], rec["compiles"],
            sorted(_series(obs, "paddle_tpu_roofline_utilization")),
            _series(obs, "paddle_tpu_optimizer_fused_step_total"))
    assert out["port"] == out["ref"]
    assert out["port"][:4] == ({("train_step", "compile"): 1.0},
                               {("train_step",): 1}, 2, 1)
    assert out["port"][4] == [("train_step", "flops"),
                              ("train_step", "hbm")]


@pytest.mark.parametrize("family", ["gpt", "llama", "bert", "other"])
def test_train_step_expectation_from_the_models_attention_shape(family):
    """TrainStep counts a step's attention from the model's own
    `attention_shape()` (the BERT encoder's is not causal) and holds no
    family names: a model that states none records no expectation."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch import models as M
    make = {"gpt": (M.GPTForCausalLM, M.gpt_tiny),
            "llama": (M.LlamaForCausalLM, M.llama_tiny),
            "bert": (M.BertForMaskedLM, M.bert_tiny),
            "other": (M.GPTForCausalLM, M.gpt_tiny)}[family]
    cfg = make[1]()
    inner = make[0](cfg, device="cpu")
    if family == "other":
        class Wrapped(torch.nn.Module):     # no attention_shape()
            def __init__(self):
                super().__init__()
                self.inner = inner

            def forward(self, ids):
                return self.inner(ids)
        model = Wrapped()
    else:
        model = inner
    step = TrainStep(model, ptt.optimizer.AdamW(
        learning_rate=1e-3, parameters=inner.parameters()),
        lambda m, i: m(i).float().mean())
    ids = np.zeros((2, 16), np.int64)
    cost = step._count_cost((ids,))
    if family == "other":
        assert cost is None
        return
    params = sum(p.numel() for p in step._params)
    per_token = {"gpt": 6, "llama": 6, "bert": 12}[family]
    assert cost.flops == 6.0 * params * 32 + per_token * cfg.num_layers \
        * cfg.hidden_size * 16 * 32
    assert cost.bytes_accessed > 0


def test_training_records_nothing_when_disabled():
    b = _Both(scaler_kw=SCHEDULES["decr_every_1"][0])
    for i in range(3):
        b.step(poison=i == 1)
    for obs, _p in OBS.values():
        snap = obs.snapshot()
        for name in AMP_SERIES + ("paddle_tpu_optimizer_fused_step_total",):
            assert not any(snap.get(name, {"series": {}})["series"]
                           .values()), name
