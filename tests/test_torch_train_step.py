"""The training slice's gate: paddle_tpu_torch's TrainStep against
paddle_tpu's, from the same weights and batches.

The configuration is bench.py's bench_gpt2_small CPU smoke config
(vocab 1024, hidden 128, 2 layers, 4 heads, dropout 0, batch 2, seq 64)
with bench_gpt's loss (GPTForCausalLM under bf16 O1 auto_cast when
enabled, GPTPretrainingCriterion) and AdamW (weight decay 0.01), three
steps."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.optimizer import AdamW as JAdamW
import paddle_tpu_torch as ptt
from paddle_tpu_torch import gpt_params_from_numpy
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import jax_state_numpy

SMOKE = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
LR, STEPS = 1e-3, 3

CASES = {
    # name: (config overrides, seq, bf16 O1)
    "f32": ({}, 64, False),
    "bf16_o1": ({}, 64, True),
    # head_dim 32: both packages route flash attention to the composite
    "flash_f32_seq128": (dict(use_flash_attention=True), 128, False),
    # head_dim 64: the port's flash path (the plain B1/B2 behind
    # _FlashCore) against the reference's (its composite off the TPU)
    "flash_d64_f32_seq128": (dict(use_flash_attention=True, num_heads=2),
                             128, False),
    "flash_d64_bf16_o1_seq128": (dict(use_flash_attention=True,
                                      num_heads=2), 128, True),
}
# per-step loss tolerance. f32: the same math on both sides, summed in
# other orders. bf16 O1: every white op rounds to bf16, at places that
# differ by an ulp between XLA and torch (bf16 gelu is rounded per
# elementwise op in XLA, once in torch; flash probabilities are rounded
# after normalising in one, before in the other); on a loss of ~6.9
# those differences stay below 2e-3 (largest measured: 7.6e-4)
LOSS_TOL = {False: dict(rtol=1e-5, atol=0), True: dict(rtol=0, atol=2e-3)}


def _batch(cfg, seq):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg["vocab_size"], (2, seq)).astype(np.int32)
    labels = rng.integers(0, cfg["vocab_size"], (2, seq)).astype(np.int32)
    return ids, labels


def _reference(cfg, seq, amp_on):
    pt.seed(0)
    model = JGPT(JConfig(**cfg))
    model.train()
    init = jax_state_numpy(model)
    opt = JAdamW(learning_rate=LR, parameters=model.parameters(),
                 weight_decay=0.01)
    crit = JCrit()

    def loss_fn(m, ids, labels):
        with pt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            logits = m(ids)
        return crit(logits, labels)

    step = JTrainStep(model, opt, loss_fn)
    ids, labels = _batch(cfg, seq)
    losses = [float(step(ids, labels).numpy()) for _ in range(STEPS)]
    step.sync()
    return init, losses, jax_state_numpy(model)


def _port(cfg, seq, amp_on, init):
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    model.load_state_dict(gpt_params_from_numpy(init))
    model.train()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                weight_decay=0.01)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids, labels):
        with ptt.amp.auto_cast(enable=amp_on, level="O1",
                               dtype="bfloat16"):
            logits = m(ids)
        return crit(logits, labels)

    step = ptt.TrainStep(model, opt, loss_fn)
    ids, labels = _batch(cfg, seq)
    losses = [float(step(ids, labels)) for _ in range(STEPS)]
    step.sync()
    return losses, {k: v.detach().numpy() for k, v in
                    model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_paddle_tpu(name):
    over, seq, amp_on = CASES[name]
    cfg = dict(SMOKE, **over)
    init, want_losses, want_params = _reference(cfg, seq, amp_on)
    n0 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    got_losses, got_params = _port(cfg, seq, amp_on, init)
    flash_path = cfg.get("use_flash_attention") and \
        cfg["hidden_size"] // cfg["num_heads"] == 64
    n1 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    want_calls = cfg["num_layers"] * STEPS if flash_path else 0
    assert n1 == (n0[0] + want_calls, n0[1] + want_calls)
    assert all(np.isfinite(got_losses))
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL[amp_on])
    assert sorted(got_params) == sorted(want_params)
    bound = 2 * LR * STEPS
    moved, far = [], 0
    for k, w in want_params.items():
        d = np.abs(got_params[k] - w)
        # a sign flip of a near-zero gradient moves an Adam parameter by
        # up to ~2 lr a step: nothing may differ by more
        assert d.max() <= bound, (k, d.max())
        moved.append(np.abs(w - init[k]).max())
        far += int((d > 1e-3 * LR).sum())
    assert max(moved) > 0.5 * LR * STEPS    # the steps did move weights
    if not amp_on:
        # in f32 such flips are rare: they take parameters whose gradient
        # is zero up to rounding (the key bias: softmax ignores a shift
        # shared by all keys), whose Adam step is noise over epsilon.
        # All but a sliver of the model agrees far inside the bound
        n = sum(w.size for w in want_params.values())
        assert far / n < 2e-3, far / n


def test_train_step_reads_lr_per_call_and_steps_the_scheduler():
    from paddle_tpu_torch.optimizer import lr as tlr
    cfg = dict(SMOKE)
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    sched = tlr.StepDecay(1e-3, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    seen = []
    real = opt._lr_tensor

    def spy(lr, device):
        seen.append(lr)
        return real(lr, device)

    opt._lr_tensor = spy
    step = ptt.TrainStep(model, opt,
                         lambda m, i, l: GPTPretrainingCriterion()(m(i), l))
    ids, labels = _batch(cfg, 16)
    for _ in range(3):
        step(ids, labels)
    assert seen == [1e-3, 5e-4, 2.5e-4]
    assert sched.last_epoch == 3


def test_train_step_ignores_grad_clip_like_the_reference():
    """functional_update applies no grad_clip (optimizer.py:523 vs the
    clip in Optimizer.step :228): a clip that would zero every update
    changes nothing on this path."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    cfg = dict(SMOKE, num_layers=1)
    ids, labels = _batch(cfg, 16)
    outs = []
    for clip in (None, ClipGradByGlobalNorm(1e-12)):
        model = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=3)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=clip)
        step = ptt.TrainStep(
            model, opt, lambda m, i, l: GPTPretrainingCriterion()(m(i), l))
        step(ids, labels)
        outs.append(torch.cat([p.detach().flatten()
                               for p in model.parameters()]))
    assert torch.equal(outs[0], outs[1])


def test_gpt_config_validation_and_remat_gate():
    with pytest.raises(ValueError):
        GPTConfig(recompute_interval=0)
    with pytest.raises(ValueError):
        GPTConfig(recompute_policy="some")
    cfg = GPTConfig(**SMOKE, recompute=True, recompute_policy="dots",
                    recompute_interval=3)
    assert cfg.recompute_interval == 3
    # remat builds, and its forward is the plain one's
    remat = GPTForCausalLM(cfg, device="cpu").train()
    plain = GPTForCausalLM(GPTConfig(**SMOKE), device="cpu").train()
    ids = torch.as_tensor(_batch(SMOKE, 16)[0])
    assert torch.equal(remat(ids), plain(ids))


def test_num_params_matches_reference():
    from paddle_tpu.models.gpt import gpt2_small, num_params as jn
    from paddle_tpu_torch.models import gpt2_small as tg
    from paddle_tpu_torch.models import num_params as tn
    assert tn(tg()) == jn(gpt2_small())
    m = GPTForCausalLM(GPTConfig(**SMOKE), device="cpu")
    assert tn(GPTConfig(**SMOKE)) == sum(p.numel() for p in m.parameters())


def test_fused_flash_attention_refuses_training_dropout():
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_flash_attention)
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(NotImplementedError):
        fused_flash_attention(q, q, q, dropout=0.1, training=True)
    assert fused_flash_attention(q, q, q, dropout=0.1,
                                 training=False).shape == q.shape
