"""The port's training executables on the card: the multi-tensor Adam
kernel against its plain version, and TrainStep's CUDA graph against the
same steps run eagerly. Every test here is marked `cuda` and skips
without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph_cuda.py

Limits. The kernel computes the plain version's f32 operations in the
same order without contraction, and rounds each store to nearest even as
the plain version's casts do, so each value is held within 2 ulps of its
type (f32) or 1 (bf16, f16): a planted 1 % error in one tensor's lr
moves its elements by ~1e-2 of an update, hundreds of f32 ulps. A graph
step replays the eager step's kernels, so the two are held to chip
phase 7's bound: 2 * lr * steps for any element (a sign flip of a
near-zero gradient), and fewer than 2e-3 of the elements beyond 1e-3 *
lr.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch import TrainStep
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.kernels import multi_tensor_adam as mta
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     GPTPretrainingCriterion, gpt_tiny)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

pytestmark = pytest.mark.cuda

ULPS = {torch.float32: 2, torch.bfloat16: 1, torch.float16: 1}
MANTISSA = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def ulp_err(got, want):
    """The largest |got - want| in units of the last place of want's
    dtype at |want|, or at the tensor's rms where |want| is smaller (a
    value that is small by cancellation carries its terms' rounding)."""
    g, w = got.double(), want.double()
    floor = max(float(w.square().mean().sqrt()) if w.numel() else 0.0,
                torch.finfo(want.dtype).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(floor)))
                     - MANTISSA[want.dtype])
    return float(((g - w).abs() / ulp).max()) if w.numel() else 0.0


# (name, optimizer kind, moment dtype, grad dtype, masters)
KERNEL_CASES = [
    ("adamw_f32", True, torch.float32, torch.float32, False),
    ("adamw_bf16_moments", True, torch.bfloat16, torch.float32, False),
    ("adam_l2", False, torch.float32, torch.float32, False),
    ("adamw_masters_bf16_grads", True, torch.float32, torch.bfloat16,
     True),
    ("adam_f16_moments_f16_grads", False, torch.float16, torch.float16,
     False),
]
# odd sizes; a start 4 bytes past a 16-byte boundary; more tensors than
# a launch takes (192), so the table splits
SHAPES = [(1,), (3,), (1001,), (16385,), (7, 13), (0,), (64, 33)] * 30


def _slots(dev, moment_dtype, grad_dtype, masters, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    slots = []
    for i, shape in enumerate(SHAPES):
        n = int(np.prod(shape))
        buf = torch.randn(n + 1, device=dev, generator=gen) * 0.02
        w = buf[1:] if i % 2 else buf[:n]   # odd ones start unaligned
        g = (torch.randn(n, device=dev, generator=gen) * 1e-2).to(
            grad_dtype)
        m = (torch.randn(n, device=dev, generator=gen) * 1e-3).to(
            moment_dtype)
        v = (torch.rand(n, device=dev, generator=gen) * 1e-5).to(
            moment_dtype)
        pows = [torch.full((), b ** 3, device=dev) for b in (0.9, 0.999)]
        out = w.to(torch.bfloat16) if masters else None
        slots.append(mta.AdamSlot(w, g, m, v, *pows,
                                  wd=(0.01, 0.1)[i % 2], out=out))
    return slots


def _clone(slots):
    return [mta.AdamSlot(*(None if t is None else t.clone()
                           for t in s[:6]), s.wd,
                         None if s.out is None else s.out.clone())
            for s in slots]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                     KERNEL_CASES])
def test_update_kernel_matches_plain(cuda_device, case):
    _, decoupled, mdt, gdt, masters = case
    slots = _slots(cuda_device, mdt, gdt, masters, seed=1)
    plain = _clone(slots)
    lr = torch.full((), 1e-3, device=cuda_device)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=decoupled)
    n0 = mta.multi_tensor_adam.kernel_launches
    for _ in range(3):
        mta.multi_tensor_adam(slots, lr, **kw)
        mta.multi_tensor_adam(plain, lr, path="torch", **kw)
    torch.cuda.synchronize()
    # 210 tensors: two launches a call
    assert mta.multi_tensor_adam.kernel_launches - n0 == 3 * 2
    for s, p in zip(slots, plain):
        for k in ("w", "m", "v", "out"):
            a, b = getattr(s, k), getattr(p, k)
            if a is None:
                continue
            assert ulp_err(a, b) <= ULPS[b.dtype], k
        assert torch.equal(s.beta1_pow, p.beta1_pow)
        assert torch.equal(s.beta2_pow, p.beta2_pow)
    # the steps moved the weights (by ~1e-4 each: |m_hat / sqrt(v_hat)|
    # is ~0.1 from these moments)
    moved = max(float((s.w - p0.w).abs().max()) for s, p0 in
                zip(slots, _slots(cuda_device, mdt, gdt, masters, seed=1))
                if s.w.numel())
    assert moved > 1e-5


def test_update_kernel_check_catches_a_planted_fault(cuda_device):
    slots = _slots(cuda_device, torch.float32, torch.float32, False, 2)
    plain = _clone(slots)
    lr = torch.full((), 1e-3, device=cuda_device)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True)
    mta.multi_tensor_adam(slots, lr, **kw)
    # tensor 3 (16385 elements) planted: its lr off by 1 %
    mta.multi_tensor_adam(plain[:3], lr, path="torch", **kw)
    mta.multi_tensor_adam(plain[3:4], lr * 1.01, path="torch", **kw)
    mta.multi_tensor_adam(plain[4:], lr, path="torch", **kw)
    errs = [ulp_err(s.w, p.w) for s, p in zip(slots, plain)]
    assert max(errs[:3] + errs[4:]) <= 2 and errs[3] > 2


def test_update_kernel_refuses_what_it_does_not_take(cuda_device):
    s = _slots(cuda_device, torch.float32, torch.float32, False, 3)[2]
    lr = torch.full((), 1e-3, device=cuda_device)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True)
    bad = [s._replace(w=s.w.to(torch.bfloat16)),
           s._replace(v=s.v.to(torch.bfloat16)),
           s._replace(m=torch.zeros(2 * s.m.numel(), device=cuda_device)[
               ::2])]
    for b in bad:
        with pytest.raises(ValueError):
            mta.multi_tensor_adam([b], lr, **kw)
    with pytest.raises(ValueError):
        mta.multi_tensor_adam([s], lr.cpu(), **kw)


LR = 1e-3


def _model_and_step(dev, lr=LR, dropout=0.0, seed=0):
    cfg = dataclasses.replace(
        gpt_tiny(hidden_dropout_prob=dropout,
                 attention_dropout_prob=dropout, use_flash_attention=True),
        hidden_size=256)
    model = GPTForCausalLM(cfg, device=dev, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01)
    crit = GPTPretrainingCriterion()
    return model, TrainStep(model, opt, lambda m, i, t: crit(m(i), t))


def _batch(seed=0, b=2, s=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, (b, s)).astype(np.int32)
            for _ in range(2)]


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _max_diff(pa, pb):
    return max(float((pa[k] - pb[k]).abs().max()) for k in pa)


def _close(pa, pb, lr, steps):
    err = _max_diff(pa, pb)
    n = sum(v.numel() for v in pa.values())
    far = sum(int(((pa[k] - pb[k]).abs() > 1e-3 * lr).sum()) for k in pa)
    return err <= 2 * lr * steps and far / n < 2e-3, err


@pytest.fixture
def f32_products():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _run(dev, eager, steps, lr=LR):
    model, step = _model_and_step(dev, lr)
    step._eager = eager
    ids, labels = _batch()
    losses = [step(ids, labels) for _ in range(steps)]
    return [float(x) for x in losses], _params(model), step


def test_graph_step_equals_eager_steps(cuda_device, f32_products):
    steps = 4
    cuda_graph.reset_counters()
    n0 = mta.multi_tensor_adam.kernel_launches
    gl, gp, _ = _run(cuda_device, False, steps)
    # one capture; its warm-up is the first step, the rest replays; the
    # update kernel launched by the warm-up and recorded by the capture
    assert cuda_graph.captures["train_step"] == 1
    assert cuda_graph.replays["train_step"] == steps - 1
    assert mta.multi_tensor_adam.kernel_launches - n0 == 2
    el, ep, _ = _run(cuda_device, True, steps)
    assert max(abs(a - b) / abs(b) for a, b in zip(gl, el)) <= 1e-5
    ok, err = _close(gp, ep, LR, steps)
    assert ok, err
    # N calls are N updates, not N + 1: one eager step more moves the
    # weights by about lr
    _, ep1, _ = _run(cuda_device, True, steps + 1)
    assert _max_diff(gp, ep1) > 0.5 * LR


def test_scheduler_changes_lr_across_replays(cuda_device, f32_products):
    runs = []
    for eager in (False, True):
        model, step = _model_and_step(cuda_device)
        sched = tlr.StepDecay(LR, step_size=1, gamma=0.5)
        step.optimizer.set_lr_scheduler(sched)
        step._eager = eager
        ids, labels = _batch()
        for _ in range(4):
            step(ids, labels)
        assert sched.last_epoch == 4
        runs.append(_params(model))
    ok, err = _close(runs[0], runs[1], LR, 4)
    assert ok, err
    # a constant lr ends about lr away
    _, const, _ = _run(cuda_device, True, 4)
    assert _max_diff(runs[0], const) > 0.5 * LR


def test_a_second_batch_shape_is_a_second_capture(cuda_device):
    cuda_graph.reset_counters()
    _, step = _model_and_step(cuda_device)
    for s in (64, 32, 64, 32, 64):
        ids, labels = _batch(s=s)
        assert torch.isfinite(step(ids, labels))
    assert cuda_graph.captures["train_step"] == 2
    assert cuda_graph.replays["train_step"] == 3
    assert len(step._graphs) == 2


def test_dropout_draws_new_masks_at_each_replay(cuda_device):
    # lr 0: the weights never move, so the losses differ by the masks
    _, step = _model_and_step(cuda_device, lr=0.0, dropout=0.1)
    ids, labels = _batch()
    losses = [float(step(ids, labels)) for _ in range(4)]
    assert len(set(losses)) == 4, losses


def test_returned_losses_are_distinct_tensors(cuda_device):
    _, step = _model_and_step(cuda_device)
    ids, labels = _batch()
    losses = [step(ids, labels) for _ in range(4)]
    values = [float(x) for x in losses]
    assert len({x.data_ptr() for x in losses}) == 4
    assert len(set(values)) == 4
    step(ids, labels)
    assert [float(x) for x in losses] == values


def test_multi_precision_step_on_the_card_matches_the_cpu(cuda_device):
    """Optimizer.step with bf16 parameters and f32 masters: the kernel on
    the card against the plain version on the CPU, from the same
    gradients (the update of each master, then its cast)."""
    rng = np.random.default_rng(5)
    shapes = [(64, 48), (48,), (7, 3, 5)]
    init = [rng.standard_normal(s).astype(np.float32) * 0.02
            for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 1e-2
              for s in shapes] for _ in range(3)]
    runs = []
    for dev in ("cpu", cuda_device):
        ps = [torch.tensor(a, device=dev).to(torch.bfloat16)
              .requires_grad_() for a in init]
        opt = AdamW(learning_rate=1e-3, parameters=ps, weight_decay=0.01,
                    multi_precision=True)
        n0 = mta.multi_tensor_adam.kernel_launches
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.tensor(g, device=dev).to(torch.bfloat16)
            opt.step()
        if dev != "cpu":
            assert mta.multi_tensor_adam.kernel_launches - n0 == 3
        runs.append(([p.detach().cpu() for p in ps],
                     [opt._master_weights[id(p)].cpu() for p in ps]))
    (cp, cm), (gp, gm) = runs
    for a, b in zip(gm, cm):
        assert a.dtype == torch.float32 and ulp_err(a, b) <= 2
    for a, b in zip(gp, cp):
        assert a.dtype == torch.bfloat16 and ulp_err(a, b) <= 1


def test_loading_state_keeps_the_graph_reading_it(cuda_device,
                                                  f32_products):
    """set_state_dict refills the optimizer's tensors in place, so a
    captured step replayed after a load continues from the loaded
    state: the same as the steps first taken from it."""
    model, step = _model_and_step(cuda_device)
    ids, labels = _batch()
    for _ in range(2):
        step(ids, labels)
    params = _params(model)
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in step.optimizer.state_dict().items()}
    first = [float(step(ids, labels)) for _ in range(2)]
    after = _params(model)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(params[k])
    step.optimizer.set_state_dict(state)
    again = [float(step(ids, labels)) for _ in range(2)]
    assert again == first
    assert _max_diff(_params(model), after) == 0.0
