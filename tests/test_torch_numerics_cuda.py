"""The multi-tensor update's statistics variant and the numerics plane on
the card. Every test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_numerics_cuda.py

The statistics kernel against its plain version (pack_stats over clones
of the pre-update work arrays): f32 sums of the same terms in another
order, so within rel 1e-5, counts exactly; parameters, moments and powers
bit-equal to the statistics-off launch, across two launches of a
208-tensor table and inside a CUDA graph; a launch without a large enough
scratch raises; PADDLE_TPU_FUSED_OPT=0 keeps the update on the kernel;
the plane on a TrainStep graph publishes one pull a step and leaves the
parameters bit-equal."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import multi_tensor_adam as mta
from paddle_tpu_torch.observability import numerics as num

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the update kernel has no CPU "
                    "mode)")
    num.disable()
    num.reset_window()
    yield torch.device("cuda", torch.cuda.current_device())
    num.disable()
    num.reset_window()


def _slots(dev, shapes, seed, gdt=torch.float32, mdt=torch.float32,
           masters=False, poison=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i, sh in enumerate(shapes):
        w = torch.randn(sh, device=dev, generator=gen)
        g = (torch.randn(sh, device=dev, generator=gen) * 1e-2).to(gdt)
        if poison is not None and i == poison:
            g.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                           -float("inf")], device=dev)
        m = (torch.randn(sh, device=dev, generator=gen) * 1e-3).to(mdt)
        v = (torch.rand(sh, device=dev, generator=gen) * 1e-5).to(mdt)
        pows = [torch.full((), b ** 3, device=dev) for b in (0.9, 0.999)]
        out.append(mta.AdamSlot(w, g, m, v, *pows, wd=0.01 * (i % 2),
                                out=w.to(torch.bfloat16) if masters
                                else None))
    return out


def _bits(t):
    """`t`'s bits as integers: torch.equal on the values would call two
    equal NaNs unequal."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _clone(slots):
    return [mta.AdamSlot(*(t.clone() if isinstance(t, torch.Tensor) else t
                           for t in s)) for s in slots]


SHAPES = [(768, 3072), (3072,), (50304, 768), (1,), (5, 7), (40000,)]
KW = dict(beta1=0.9, beta2=0.999, eps=1e-8)


def _check(got, want):
    """Sums within rel 1e-5 (a NaN sum, a poisoned tensor's, equal to
    NaN), counts exactly."""
    P = (got.numel() - 3) // 2
    sums = torch.cat([got[:P], got[2 * P:2 * P + 2]])
    want_sums = torch.cat([want[:P], want[2 * P:2 * P + 2]])
    torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=0,
                               equal_nan=True)
    assert torch.equal(got[P:2 * P], want[P:2 * P])
    assert torch.equal(got[2 * P + 2], want[2 * P + 2])


@pytest.mark.parametrize("case", ["adamw", "adam_bf16", "masters",
                                  "poisoned", "two_launches"])
def test_stats_kernel_against_its_plain_version(card, case):
    shapes = SHAPES * (35 if case == "two_launches" else 1)
    kw = dict(gdt=torch.bfloat16 if case == "adam_bf16" else torch.float32,
              mdt=torch.bfloat16 if case == "adam_bf16" else torch.float32,
              masters=case == "masters",
              poison=2 if case == "poisoned" else None)
    decoupled = case != "adam_bf16"
    on = _slots(card, shapes, 0, **kw)
    off = _clone(on)
    olds = [s.w.clone() for s in on]
    lr = torch.full((), 1e-3, device=card)
    P = len(shapes)
    positions = list(reversed(range(P)))
    table = torch.zeros(P, mta.STATS_COLS, device=card)
    scratch = torch.zeros(mta.scratch_floats(s.w.numel() for s in on),
                          device=card)
    n0 = (mta.multi_tensor_adam.kernel_launches,
          mta.multi_tensor_adam.stats_launches)
    mta.multi_tensor_adam(on, lr, decoupled=decoupled, stats=table,
                          positions=positions, scratch=scratch, **KW)
    packed = mta.pack_rows(table)
    mta.multi_tensor_adam(off, lr, decoupled=decoupled, **KW)
    torch.cuda.synchronize()
    launches = 2 if case == "two_launches" else 1
    assert (mta.multi_tensor_adam.kernel_launches - n0[0],
            mta.multi_tensor_adam.stats_launches - n0[1]) == (2 * launches,
                                                              launches)
    for a, b in zip(on, off):
        for k in ("w", "m", "v", "beta1_pow", "beta2_pow", "out"):
            x, y = getattr(a, k), getattr(b, k)
            assert x is None or torch.equal(_bits(x), _bits(y)), k
    order = sorted(range(P), key=lambda i: positions[i])
    want = num.pack_stats([olds[i] for i in order], [on[i].g for i in order],
                          [on[i].w for i in order])
    _check(packed, want)
    if case == "poisoned":
        assert float(packed[P + positions[2]]) == 3.0


def test_stats_kernel_in_a_cuda_graph(card):
    slots = _slots(card, SHAPES, 1)
    lr = torch.full((), 1e-3, device=card)
    table = torch.zeros(len(SHAPES), mta.STATS_COLS, device=card)
    out = torch.zeros(2 * len(SHAPES) + 3, device=card)
    scratch = torch.zeros(mta.scratch_floats(s.w.numel() for s in slots),
                          device=card)
    ref = _clone(slots)

    def step():
        mta.multi_tensor_adam(slots, lr, decoupled=True, stats=table,
                              scratch=scratch, **KW)
        mta.pack_rows(table, out=out)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                # the warm-up is step 1
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    for _ in range(3):
        olds = [s.w.clone() for s in slots]
        g.replay()
        torch.cuda.synchronize()
        want = num.pack_stats(olds, [s.g for s in slots],
                              [s.w for s in slots])
        _check(out, want)
    for _ in range(4):
        mta.multi_tensor_adam(ref, lr, decoupled=True, **KW)
    for a, b in zip(slots, ref):
        assert torch.equal(a.w, b.w) and torch.equal(a.m, b.m)


def test_stats_launch_needs_a_large_enough_scratch(card):
    slots = _slots(card, SHAPES, 2)
    table = torch.zeros(len(SHAPES), mta.STATS_COLS, device=card)
    short = torch.zeros(mta.scratch_floats(s.w.numel() for s in slots) - 1,
                        device=card)
    lr = torch.full((), 1e-3, device=card)
    for scratch in (None, short):
        with pytest.raises(ValueError, match="scratch"):
            mta.multi_tensor_adam(slots, lr, decoupled=True, stats=table,
                                  scratch=scratch, **KW)


def test_fused_opt_flag_keeps_the_kernel(card, monkeypatch):
    """PADDLE_TPU_FUSED_OPT=0 changes what a step reports (source
    optimizer_eager, no fused step), not where the update runs: every f32
    parameter still goes through the kernel, with the statistics too."""
    from paddle_tpu_torch.optimizer import AdamW
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "0")
    gen = torch.Generator(device=card).manual_seed(3)
    ps = [torch.randn(sh, device=card, generator=gen).requires_grad_()
          for sh in SHAPES]
    opt = AdamW(learning_rate=1e-3, parameters=ps, weight_decay=0.01)
    num.enable(interval=1)
    n0 = (mta.multi_tensor_adam.kernel_launches,
          mta.multi_tensor_adam.stats_launches,
          mta.multi_tensor_adam.plain_calls)
    for _ in range(2):
        for p in ps:
            p.grad = torch.randn(p.shape, device=card, generator=gen)
        opt.step()
    rec = num.flush()
    assert (mta.multi_tensor_adam.kernel_launches - n0[0],
            mta.multi_tensor_adam.stats_launches - n0[1],
            mta.multi_tensor_adam.plain_calls - n0[2]) == (2, 2, 0)
    assert rec["source"] == "optimizer_eager"


def _gpt_step(card, seed=0):
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.0,
                                    attention_dropout_prob=0.0),
                           device=card, dtype="float32", seed=seed)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    return model, TrainStep(
        model, opt, lambda m, ids: m(ids).float().square().mean())


def test_train_step_graph_one_pull_a_step_and_bit_equal(card):
    ids = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int64)

    def run(on):
        model, step = _gpt_step(card)
        if on:
            num.enable(interval=1)
        base = num.pulls()
        losses = [step(ids) for _ in range(5)]
        pulls = num.pulls() - base
        rec = num.flush()
        num.disable()
        return ([p.detach().clone() for p in model.parameters()],
                [float(x) for x in losses], pulls, rec)

    p_off, l_off, _, _ = run(False)
    p_on, l_on, pulls, rec = run(True)
    assert l_on == l_off
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))
    assert pulls == 4 and rec["source"] == "train_step"
    assert rec["loss"] == pytest.approx(l_on[-1], rel=1e-6)
    assert rec["grad_norm"] > 0 and rec["update_ratio"] > 0
