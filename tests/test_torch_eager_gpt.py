"""The eager API as a whole: one paddle-style eager script
(tests/eager_gpt_script.py, re-exported by torch_port_helpers: to_tensor
parameters with stop_gradient=False, the registered ops and nn ops,
loss.backward(), opt.step(), opt.clear_grad()) trains a 2-layer tiny GPT
for 3 AdamW steps on each package from the same weights and batches, in
f32 and in bf16 O1 auto_cast. Off the TPU both packages' attention op
runs its plain composite.

Tolerances: f32 losses within rtol 1e-5 and parameters within 1e-4
(Adam divides each gradient by its own root mean square, so where a
gradient is near 0 the few-ulp differences between XLA's and torch's
sums move a parameter by up to ~lr = 1e-3 a step; measured 2.3e-5).
bf16: losses within rtol 5e-4 (measured 1.2e-4), parameters within
1e-2 (10 lr: bf16 products round differently in the two packages, and
Adam turns a rounding-sized gradient difference into up to lr a step;
measured 5.6e-3 after 3 steps). The port's script is also held to the
port's own GPTForCausalLM trained eagerly on the same weights and
batches: the same torch functions in the same order, so bit-equal in
f32 and bf16."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny)
from paddle_tpu_torch.optimizer import AdamW
from torch_port_helpers import cpu_place, eager_gpt_steps

LR = 1e-3
STEPS = 3
TOLS = {False: dict(loss=1e-5, param=1e-4),
        True: dict(loss=5e-4, param=1e-2)}


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _setup(seed=0):
    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cpu", seed=seed)
    weights = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    batches = [(rng.integers(0, cfg.vocab_size, (2, 32)),
                rng.integers(0, cfg.vocab_size, (2, 32)))
               for _ in range(STEPS)]
    return cfg, model, weights, batches


def _np(t):
    return np.asarray(t.numpy(), np.float32)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_eager_script_matches_reference(amp):
    cfg, _, weights, batches = _setup()
    got_l, got_p = eager_gpt_steps(ptt, weights, batches, cfg.num_layers,
                                   cfg.num_heads, lr=LR, amp=amp)
    want_l, want_p = eager_gpt_steps(pt, weights, batches, cfg.num_layers,
                                     cfg.num_heads, lr=LR, amp=amp)
    tol = TOLS[amp]
    np.testing.assert_allclose(got_l, want_l, rtol=tol["loss"])
    for k in weights:
        np.testing.assert_allclose(_np(got_p[k]), _np(want_p[k]),
                                   atol=tol["param"], rtol=0, err_msg=k)
        # every parameter moved, the same way in both packages
        assert not np.array_equal(_np(got_p[k]), weights[k]), k


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_eager_script_equals_the_ports_model(amp):
    """The script on Tensors against GPTForCausalLM's own eager steps
    (loss.backward(), AdamW.step(), clear_grad()) on torch tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # bit-equality: one summation order
    try:
        cfg, model, weights, batches = _setup()
        got_l, got_p = eager_gpt_steps(ptt, weights, batches,
                                       cfg.num_layers, cfg.num_heads, lr=LR,
                                       amp=amp)
        crit = GPTPretrainingCriterion()
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    weight_decay=0.01)
        want_l = []
        for ids, labels in batches:
            with auto_cast(enable=amp, level="O1", dtype="bfloat16"):
                loss = crit(model(torch.as_tensor(ids, dtype=torch.int32)),
                            torch.as_tensor(labels, dtype=torch.int32))
            loss.backward()
            opt.step()
            opt.clear_grad()
            want_l.append(float(loss))
    finally:
        torch.set_num_threads(threads)
    assert got_l == want_l
    state = model.state_dict()
    for k in weights:
        torch.testing.assert_close(got_p[k]._data, state[k], rtol=0, atol=0)


def test_eager_script_counts_its_ops():
    """The dispatches of one eager step: every op of the forward goes
    through the registry (the count phase 22 reports on the card)."""
    from paddle_tpu_torch.ops import registry
    cfg, _, weights, batches = _setup()
    before = registry.dispatch_count()
    eager_gpt_steps(ptt, weights, batches[:1], cfg.num_layers,
                    cfg.num_heads)
    n = registry.dispatch_count() - before
    # per layer: 2 layer norms, 4 linears, reshape, unbind (split and 3
    # squeezes), attention, reshape, gelu, 2 residual adds; then the
    # embeddings (2 and an add), the final norm, the head, the loss and
    # its mean
    per_layer = 2 + 4 + 1 + 4 + 1 + 1 + 1 + 2
    assert n == cfg.num_layers * per_layer + 3 + 1 + 1 + 2
