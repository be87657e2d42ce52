"""paddle_tpu_torch's activation recompute
(``distributed.meta_parallel.recompute``) against paddle_tpu's, and
against the port's own run without recompute.

The model is test_torch_train_step.py's SMOKE GPT at 4 layers (with 2,
intervals 2 and 3 would recompute the same block): vocab 1024, hidden
128, 4 heads, batch 2 x seq 64, weights drawn by paddle_tpu and carried
by ``gpt_params_from_numpy``, ids from a numpy seed."""
import gc
import importlib
import weakref

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.optimizer import AdamW as JAdamW
import paddle_tpu_torch as ptt
from paddle_tpu_torch import gpt_params_from_numpy
from paddle_tpu_torch.distributed.meta_parallel import (recompute,
                                                        recompute_sequential)
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.layers import Dropout
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import jax_state_numpy
from torch_port_helpers import tnamed, tstate

# the modules (each package's meta_parallel exports the function under
# the module's name)
jrecompute = importlib.import_module(
    "paddle_tpu.distributed.meta_parallel.recompute")
trecompute = importlib.import_module(
    "paddle_tpu_torch.distributed.meta_parallel.recompute")

SMALL = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
INTERVALS = (1, 2, 3)
POLICIES = ("full", "dots", "dots_no_batch")
SEQ, LR, STEPS = 64, 1e-3, 3
# loss tolerance: test_torch_train_step.py's LOSS_TOL (f32: the same math
# summed in other orders; bf16 O1: white ops round to bf16 at places an
# ulp apart between XLA and torch)
LOSS_TOL = {False: dict(rtol=1e-5, atol=0), True: dict(rtol=0, atol=2e-3)}
# gradient tolerance, each tensor's largest error over its largest
# element. f32: summation order only (measured <= 9.1e-7). bf16 O1: the
# same ulp-apart roundings, summed over 128 tokens into each gradient
# (measured <= 1.6e-2 of the tensor's largest element, 4 bf16 ulps); a
# block recomputed outside its forward's AMP state or with other dropout
# masks is off by order 1
GRAD_TOL = {False: 1e-5, True: 4e-2}


def _cfg(**kw):
    return dict(SMALL, **kw)


@pytest.fixture
def one_thread():
    """The tests of bit-equal results run torch's CPU kernels on one
    thread: with several, some sum in an order that depends on the
    threads (head_dim 64 at seq 128 gave unequal gradients in 3 of 8
    runs without recompute, none on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _remat(interval, policy):
    return dict(recompute=True, recompute_interval=interval,
                recompute_policy=policy)


def _batch(cfg, seq=SEQ):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg["vocab_size"], (2, seq)).astype(np.int32)
    labels = rng.integers(0, cfg["vocab_size"], (2, seq)).astype(np.int32)
    return ids, labels


def _reference_grads(cfg, amp_on):
    """paddle_tpu: (initial weights, loss, {name: gradient})."""
    pt.seed(0)
    model = JGPT(JConfig(**cfg))
    model.train()
    init = jax_state_numpy(model)
    ids, labels = _batch(cfg)
    with pt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        logits = model(pt.to_tensor(ids))
    loss = JCrit()(logits, pt.to_tensor(labels))
    loss.backward()
    return init, float(loss.numpy()), {
        n: np.asarray(p.grad.numpy()) for n, p in model.named_parameters()}


def _port_model(cfg, init=None, seed=0):
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=seed)
    if init is not None:
        model.load_state_dict(gpt_params_from_numpy(init))
    model.train()
    return model


def _port_grads(model, cfg, amp_on, seq=SEQ):
    """The port: (loss, {name: gradient}), the gradients taken outside
    the auto_cast block, as TrainStep takes them."""
    ids, labels = _batch(cfg, seq)
    with ptt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
        logits = model(torch.as_tensor(ids))
    loss = GPTPretrainingCriterion()(logits, torch.as_tensor(labels))
    names, params = zip(*tnamed(model))
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("interval", INTERVALS)
def test_loss_and_grads_match_paddle_tpu(interval, policy, amp_on):
    cfg = _cfg(**_remat(interval, policy))
    init, want_loss, want = _reference_grads(cfg, amp_on)
    loss, got = _port_grads(_port_model(cfg, init), cfg, amp_on)
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL[amp_on])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL[amp_on], (k, err)


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("interval", INTERVALS)
def test_equal_to_the_port_without_recompute(interval, policy, amp_on,
                                             one_thread):
    """Dropout 0.1 (hidden and attention), masks from the model's
    generator seeded alike: the recomputation draws the forward's masks
    under the forward's AMP state, so losses and gradients are equal bit
    for bit."""
    drop = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    plain = _port_grads(_port_model(_cfg(**drop), seed=5), _cfg(), amp_on)
    cfg = _cfg(**drop, **_remat(interval, policy))
    got = _port_grads(_port_model(cfg, seed=5), cfg, amp_on)
    assert torch.equal(got[0], plain[0])
    for k, g in plain[1].items():
        assert torch.equal(got[1][k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_flash_path_recomputes_b1(policy, one_thread):
    """head_dim 64 at seq 128 takes the flash kernels' plain versions on
    the CPU (_FlashCore). B1 runs in no aten product the policies name, so every
    recomputed block runs it again: 4 forward + 2 recomputed calls at
    interval 3 (blocks 0 and 3); B2 once a block. The gradients equal
    the run without recompute."""
    over = dict(use_flash_attention=True, num_heads=2)
    plain = _port_grads(_port_model(_cfg(**over)), _cfg(**over), True, 128)
    cfg = _cfg(**over, **_remat(3, policy))
    n0 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    got = _port_grads(_port_model(cfg), cfg, True, 128)
    n1 = tfa.flash_fwd.plain_calls, tfa.flash_bwd.plain_calls
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (4 + 2, 4)
    assert torch.equal(got[0], plain[0])
    for k, g in plain[1].items():
        assert torch.equal(got[1][k], g), k


class _Census(TorchDispatchMode):
    """Every storage an operator writes while the mode is on, by a weak
    reference: what is still alive after the forward is what the
    autograd graph holds for the backward (saved tensors, the selective
    checkpoint's kept products) and the outputs."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made[s.data_ptr()] = (weakref.ref(s), s.nbytes())
        return out

    def alive_bytes(self):
        gc.collect()
        return sum(n for r, n in self.made.values() if r() is not None)


def _held_bytes(cfg, amp_on):
    model = _port_model(cfg)
    ids, labels = _batch(cfg)
    with _Census() as census:
        with ptt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            logits = model(torch.as_tensor(ids))
        loss = GPTPretrainingCriterion()(logits, torch.as_tensor(labels))
    held = census.alive_bytes()
    del loss
    return held


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
def test_checkpoint_frees_what_it_should(amp_on):
    """The bytes the forward leaves held for the backward, every block
    recomputed: no recompute > "dots" (keeps the products) > "full"
    (keeps the block inputs). An outer ``saved_tensors_hooks`` cannot
    count this: inside a checkpointed block the checkpoint's own hooks
    take the saves, and "dots" keeps its products outside any hook."""
    none = _held_bytes(_cfg(), amp_on)
    dots = _held_bytes(_cfg(**_remat(1, "dots")), amp_on)
    full = _held_bytes(_cfg(**_remat(1, "full")), amp_on)
    assert none > dots > full, (none, dots, full)
    # "dots" keeps at least the four products of each block, [128, 3h],
    # [128, h], [128, 4h], [128, h], in the products' dtype
    itemsize = 2 if amp_on else 4
    assert dots - full >= 4 * 128 * 9 * 128 * itemsize


@pytest.mark.parametrize("interval,policy,amp_on", [
    pytest.param(1, "full", False, id="f32_full_1"),
    pytest.param(3, "dots", True, id="bf16_o1_dots_3"),
    pytest.param(2, "dots_no_batch", True, id="bf16_o1_dots_no_batch_2")])
def test_train_step_with_recompute_matches_paddle_tpu(interval, policy,
                                                      amp_on):
    """3 TrainSteps with recompute against paddle_tpu's TrainStep with
    the same config (tests/test_train_scale_paths.py:50-70), held as
    test_torch_train_step.py holds the steps without it."""
    cfg = _cfg(**_remat(interval, policy))
    ids, labels = _batch(cfg)

    pt.seed(0)
    jm = JGPT(JConfig(**cfg))
    jm.train()
    init = jax_state_numpy(jm)
    jcrit = JCrit()

    def jloss(m, i, l):
        with pt.amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            logits = m(i)
        return jcrit(logits, l)

    jstep = JTrainStep(jm, JAdamW(learning_rate=LR, weight_decay=0.01,
                                  parameters=jm.parameters()), jloss)
    want_losses = [float(jstep(ids, labels).numpy()) for _ in range(STEPS)]
    jstep.sync()
    want = jax_state_numpy(jm)

    tm = _port_model(cfg, init)
    crit = GPTPretrainingCriterion()

    def loss(m, i, l):
        with ptt.amp.auto_cast(enable=amp_on, level="O1",
                               dtype="bfloat16"):
            logits = m(i)
        return crit(logits, l)

    step = ptt.TrainStep(tm, AdamW(learning_rate=LR, weight_decay=0.01,
                                   parameters=tnamed(tm)), loss)
    got_losses = [float(step(ids, labels)) for _ in range(STEPS)]
    got = {k: v.detach().numpy() for k, v in tstate(tm).items()}
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL[amp_on])
    assert sorted(got) == sorted(want)
    bound, far = 2 * LR * STEPS, 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        # test_torch_train_step.py's bound: a sign flip of a near-zero
        # gradient moves an Adam parameter by up to ~2 lr a step
        assert d.max() <= bound, (k, d.max())
        far += int((d > 1e-3 * LR).sum())
    assert max(np.abs(w - init[k]).max() for k, w in want.items()) \
        > 0.5 * LR * STEPS
    if not amp_on:
        assert far / sum(w.size for w in want.values()) < 2e-3


def _spy_blocks(monkeypatch, module, attr, layers):
    """Record the index of each block `module.attr` (a recompute) gets."""
    seen = []
    real = getattr(module, attr)

    def spy(function, *args, **kwargs):
        seen.append(layers.index(function))
        return real(function, *args, **kwargs)

    monkeypatch.setattr(module, attr, spy)
    return seen


@pytest.mark.parametrize("interval", INTERVALS)
def test_recomputes_the_reference_blocks(monkeypatch, interval):
    """Block i is recomputed iff recompute and training and i % interval
    == 0, in both packages; eval never recomputes."""
    cfg = _cfg(**_remat(interval, "full"))
    ids, _ = _batch(cfg)
    pt.seed(0)
    jm = JGPT(JConfig(**cfg))
    jm.train()
    want = _spy_blocks(monkeypatch, jrecompute, "recompute",
                       list(jm.gpt.layers))
    jm(pt.to_tensor(ids))
    tm = _port_model(cfg)
    got = _spy_blocks(monkeypatch, tgpt, "recompute", list(tm.gpt.layers))
    tm(torch.as_tensor(ids))
    assert got == want == [i for i in range(4) if i % interval == 0]
    got.clear()
    tm.eval()
    tm(torch.as_tensor(ids))
    assert got == []


def _mlp(seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(16, 32), nn.GELU(), nn.Linear(32, 32),
                         nn.Tanh(), nn.Linear(32, 8))


def _out_and_grads(run, mlp, x):
    out = run(mlp, x)
    grads = torch.autograd.grad(out.square().sum(),
                                [x, *mlp.parameters()])
    return out.detach(), grads


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("form", ["module", "function", "sequential"])
def test_entry_forms_equal_the_plain_call(form, one_thread):
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    mlp = _mlp()
    runs = {
        "module": lambda m, v: recompute(m, v),
        "function": lambda m, v: recompute(
            lambda a, b, c, d, e, t: e(d(c(b(a(t))))), *m, v),
        "sequential": lambda m, v: recompute_sequential({"segments": 2},
                                                        m, v),
    }
    _assert_same(_out_and_grads(runs[form], mlp, x),
                 _out_and_grads(lambda m, v: m(v), mlp, x))


def test_sequential_cuts_segments_like_the_reference(monkeypatch):
    """5 modules in 2 segments: chunks of 5 // 2 = 2, so 3 recomputes."""
    sizes = []
    real = trecompute.recompute

    def spy(function, *args, **kwargs):
        sizes.append(len(function))
        return real(function, *args, **kwargs)

    monkeypatch.setattr(trecompute, "recompute", spy)
    x = torch.randn(4, 16, requires_grad=True)
    recompute_sequential({"segments": 2}, _mlp(), x)
    assert sizes == [2, 2, 1]


def test_unknown_policy_raises_like_the_reference():
    mlp, x = _mlp(), torch.randn(2, 16, requires_grad=True)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(mlp, x, policy="everything")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        jrecompute._resolve_policy("everything")


class _Probe(nn.Module):
    """Dropout that records, at every run, the AMP state it ran under and
    the mask it drew (forward and recomputation alike)."""

    def __init__(self, gen):
        super().__init__()
        self.drop = Dropout(0.5, generator=gen)
        self.seen = []

    def forward(self, x):
        st = ptt.amp.amp_state()
        y = self.drop(x)
        self.seen.append(((st.enabled, st.level, st.dtype), y != 0))
        return ptt.nn.functional.matmul(y, y, transpose_y=True)


@pytest.mark.parametrize("preserve", [True, False])
def test_recomputation_runs_under_the_forwards_state(preserve):
    """The recomputation sees the forward's AMP state (O1 bf16, though
    the backward runs after auto_cast's exit) and, with
    preserve_rng_state, draws the forward's dropout masks from the
    block's own generator, which it then leaves where a run without
    recompute leaves it. Without preserve_rng_state it draws new masks,
    as the reference's PRNGKey(0) branch does."""
    gen = torch.Generator().manual_seed(3)
    probe = _Probe(gen)
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        out = recompute(probe, x, preserve_rng_state=preserve)
    after_forward = gen.get_state()
    torch.autograd.grad(out.float().sum(), x)
    (fwd_amp, fwd_mask), (re_amp, re_mask) = probe.seen
    assert fwd_amp == re_amp == (True, "O1", torch.bfloat16)
    assert not ptt.amp.is_auto_cast_enabled()
    if preserve:
        assert torch.equal(re_mask, fwd_mask)
        assert torch.equal(gen.get_state(), after_forward)
    else:
        assert not torch.equal(re_mask, fwd_mask)


def test_eval_and_no_grad_are_plain_calls():
    """Without gradients nothing is checkpointed and nothing stashed."""
    probe = _Probe(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = recompute(probe, torch.randn(4, 16))
    assert out.grad_fn is None and len(probe.seen) == 1
