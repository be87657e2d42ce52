"""Activation recompute on the card: TrainStep's CUDA graph with
recomputed blocks against eager steps without them, and the generator
calls the recomputation relies on inside a capture. Every test here is
marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_recompute_cuda.py

The model is gpt_tiny at hidden 256 (head_dim 64, so B1/B2's sm90
kernels) and 4 layers, bf16 O1, dropout 0.1, batch 2 x seq 128. A graph
step replays the kernels an eager step launches, and a recomputed block
draws its forward's masks, so graph steps with recompute are held to
eager steps without it by chip phase 7's rule: no element beyond 2 * lr
* steps, fewer than 2e-3 of them beyond 1e-3 * lr. One block's masks
drawn anew move nearly every parameter by ~lr.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch import TrainStep, amp
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     GPTPretrainingCriterion, gpt_tiny)
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

LR, LAYERS, SEQ = 1e-3, 4, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels)")
    return torch.device("cuda")


def _captured(body):
    """`body(g)` captured with a registered generator g; returns what 3
    replays gave, or raises what the capture raised."""
    g = torch.Generator(device="cuda").manual_seed(5)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        outs = body(g)
    reps = []
    for _ in range(3):
        graph.replay()
        reps.append([o.clone() for o in outs])
    return reps


def test_generator_calls_inside_a_capture(cuda_device):
    """recompute.py's claims on this torch: get_state()/set_state()
    rewind a registered generator inside a capture, and each replay
    draws anew; graphsafe_get_state() returns the live state (setting
    it back rewinds nothing); clone_state() raises during a capture."""
    def rewind(g, get, put):
        s = get()
        a = torch.rand(64, device="cuda", generator=g)
        put(s)
        return a, torch.rand(64, device="cuda", generator=g)

    reps = _captured(lambda g: rewind(g, g.get_state, g.set_state))
    assert all(torch.equal(a, b) for a, b in reps)
    assert not torch.equal(reps[0][0], reps[1][0])
    reps = _captured(lambda g: rewind(g, g.graphsafe_get_state,
                                      g.graphsafe_set_state))
    assert not any(torch.equal(a, b) for a, b in reps)
    with pytest.raises(RuntimeError, match="capture"):
        _captured(lambda g: (g.clone_state(),))


def _model_and_step(remat=None, seed=0):
    """remat: None or (interval, policy)."""
    kw = {} if remat is None else dict(
        recompute=True, recompute_interval=remat[0],
        recompute_policy=remat[1])
    cfg = dataclasses.replace(
        gpt_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                 use_flash_attention=True, **kw),
        hidden_size=256, num_layers=LAYERS)
    model = GPTForCausalLM(cfg, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=0.01)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(ids)
        return crit(logits, labels)

    return model, TrainStep(model, opt, loss_fn)


def _batch():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, (2, SEQ)).astype(np.int32)
            for _ in range(2)]


def _run(remat, eager, steps=3):
    model, step = _model_and_step(remat)
    step._eager = eager
    ids, labels = _batch()
    losses = [float(step(ids, labels)) for _ in range(steps)]
    gen = model.gpt.layers[0].dropout.generator
    return (losses, {k: v.detach().clone()
                     for k, v in model.state_dict().items()},
            gen.get_state(), step)


def _close(pa, pb, steps):
    err = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    n = sum(v.numel() for v in pa.values())
    far = sum(int(((pa[k] - pb[k]).abs() > 1e-3 * LR).sum()) for k in pa)
    return err <= 2 * LR * steps and far / n < 2e-3, (err, far / n)


@pytest.mark.parametrize("remat", [(1, "full"), (3, "full"), (1, "dots"),
                                   (2, "dots_no_batch")],
                         ids=lambda r: f"{r}")
def test_graph_step_with_recompute_equals_eager_without(cuda_device, remat):
    want_losses, want, _, _ = _run(None, eager=True)
    cuda_graph.reset_counters()
    losses, got, _, _ = _run(remat, eager=False)
    assert cuda_graph.captures["train_step"] == 1
    assert cuda_graph.replays["train_step"] == 2
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    ok, err = _close(got, want, 3)
    assert ok, err


def test_capture_takes_the_dots_policy_and_relaunches_b1(cuda_device):
    """A captured step under "dots" at interval 2: B1 launches for the
    4 blocks and again for the 2 recomputed ones (0 and 2), in the
    eager first step and in the capture; B2 once a block in each."""
    fa.reset_counters()
    cuda_graph.reset_counters()
    _, _, _, step = _run((2, "dots"), eager=False, steps=2)
    assert cuda_graph.captures["train_step"] == 1
    assert fa.flash_fwd.design_launches["sm90"] == 2 * (LAYERS + 2)
    assert fa.flash_bwd.design_launches["sm90"] == 2 * LAYERS
    assert fa.flash_fwd.plain_calls == fa.flash_bwd.plain_calls == 0


def test_generator_state_after_replays_is_the_eager_steps(cuda_device):
    """After N steps through the graph with recompute (the eager first
    step, then replays), the model's dropout generator and the default
    CUDA generator stand where N eager steps without recompute leave
    them: every recomputation put them back."""
    for n in (2, 4):
        torch.cuda.manual_seed(11)
        _, _, want, _ = _run(None, eager=True, steps=n)
        want_default = torch.cuda.get_rng_state()
        torch.cuda.manual_seed(11)
        _, _, got, _ = _run((1, "full"), eager=False, steps=n)
        assert torch.equal(got, want)
        assert torch.equal(torch.cuda.get_rng_state(), want_default)
