"""A paddle-style GPT built from nn.Layers (tests/eager_gpt_layer_script.py:
``P.nn.Embedding``, ``LayerNorm`` and ``Linear`` in ``P.nn.Layer``
subclasses, weights in by ``set_state_dict``, ``AdamW(parameters=
model.parameters())``) trains a 2-layer tiny GPT for 3 steps on each
package from the same weights and batches, in f32 and in bf16 O1
auto_cast, within tests/test_torch_eager_gpt.py's tolerances (``TOLS``,
whose docstring gives their reasons). On the port it is held bit for
bit to GPTForCausalLM's own eager steps and to the dict script of PR
15 (the same torch functions in the same order), and a save/load round
trip through ``save`` / ``load`` gives a model whose next step equals
the original's bit for bit."""
import numpy as np
import pytest
import torch

import eager_gpt_layer_script as LS
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
from test_torch_eager_gpt import LR, TOLS, _np, _setup
from torch_port_helpers import cpu_place, eager_gpt_steps
from torch_port_helpers import tparams, tstate


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.fixture
def one_thread():
    """Bit-equality needs one summation order: torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _steps(P, weights, batches, cfg, amp):
    return LS.layer_gpt_steps(P, weights, batches, cfg.num_layers,
                              cfg.num_heads, lr=LR, amp=amp)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_layer_script_matches_reference(amp):
    cfg, _, weights, batches = _setup()
    got_l, got_m, _ = _steps(ptt, weights, batches, cfg, amp)
    want_l, want_m, _ = _steps(pt, weights, batches, cfg, amp)
    tol = TOLS[amp]
    np.testing.assert_allclose(got_l, want_l, rtol=tol["loss"])
    got, want = got_m.state_dict(), want_m.state_dict()
    assert list(got) == list(want) == list(weights)
    assert all(isinstance(p, ptt.nn.Parameter) for p in got.values())
    for k in weights:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                   atol=tol["param"], rtol=0, err_msg=k)
        assert not np.array_equal(_np(got[k]), weights[k]), k


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_layer_script_equals_the_ports_model(amp, one_thread):
    """The Layer script on Tensors against GPTForCausalLM's own eager
    steps on torch tensors, and against the dict script."""
    cfg, model, weights, batches = _setup()
    got_l, got_m, _ = _steps(ptt, weights, batches, cfg, amp)
    dict_l, dict_p = eager_gpt_steps(ptt, weights, batches, cfg.num_layers,
                                     cfg.num_heads, lr=LR, amp=amp)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tparams(model),
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
    assert got_l == want_l == dict_l
    state, got = tstate(model), got_m.state_dict()
    for k in weights:
        torch.testing.assert_close(got[k]._data, state[k], rtol=0, atol=0)
        torch.testing.assert_close(dict_p[k]._data, state[k], rtol=0,
                                   atol=0)


def test_layer_script_round_trip(tmp_path, one_thread):
    """save(model.state_dict()) writes the saved-Tensor form (read back
    with pickle and numpy alone) with every value of the model; a fresh
    model loaded from it takes the same next step bit for bit."""
    cfg, _, weights, batches = _setup()
    _, model, _ = _steps(ptt, weights, batches, cfg, False)
    arrays, fresh, (loss_fresh, loss_orig) = LS.round_trip(
        ptt, model, str(tmp_path / "gpt.pdparams"), batches[0],
        cfg.num_layers, cfg.num_heads, lr=LR)
    assert list(arrays) == list(weights)
    assert loss_fresh == loss_orig
    a, b = fresh.state_dict(), model.state_dict()
    for k in weights:
        assert a[k]._data.data_ptr() != b[k]._data.data_ptr()
        torch.testing.assert_close(a[k]._data, b[k]._data, rtol=0, atol=0)
    # the reference reads the port's file into its own Layer GPT
    ref = LS.build_gpt(pt, cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
                       cfg.num_heads, cfg.max_position_embeddings)
    assert ref.set_state_dict(pt.load(str(tmp_path / "gpt.pdparams"))) \
        == ([], [])


def test_layer_script_dispatches_the_dict_scripts_ops():
    """The Layers add no op to a step: the same dispatches as the dict
    script's (test_torch_eager_gpt.py counts them)."""
    from paddle_tpu_torch.ops import registry
    cfg, _, weights, batches = _setup()
    counts = []
    for run in (lambda: eager_gpt_steps(ptt, weights, batches[:1],
                                        cfg.num_layers, cfg.num_heads),
                lambda: _steps(ptt, weights, batches[:1], cfg, False)):
        before = registry.dispatch_count()
        run()
        counts.append(registry.dispatch_count() - before)
    assert counts[0] == counts[1]
