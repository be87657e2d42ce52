"""Shared helpers for the paddle_tpu_torch parity tests
(tests/test_torch_*.py): build one GPT in both packages from the same
weights, and compare greedy tokens under a logit-margin guard."""
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import gpt_params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM as TorchGPT
from paddle_tpu_torch.models import gpt as tgpt

# greedy tokens are compared up to the first position whose top-1/top-2
# logit margin falls below this: f32 sums in XLA and in torch run in
# different orders (~1e-6 apart at these sizes), so a closer race may
# legitimately flip
MARGIN = 1e-3


def jax_state_numpy(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def twin_gpts(cfg_name="gpt_tiny", seed=0, **cfg_kw):
    """(paddle_tpu model, paddle_tpu_torch model) with identical f32
    weights: paddle_tpu draws them, the port loads them by name."""
    from paddle_tpu.models import gpt as jgpt
    pt.seed(seed)
    jm = JaxGPT(getattr(jgpt, cfg_name)(**cfg_kw))
    jm.eval()
    tm = TorchGPT(getattr(tgpt, cfg_name)(**cfg_kw), device="cpu")
    tm.load_state_dict(gpt_params_from_numpy(jax_state_numpy(jm)))
    tm.eval()
    return jm, tm


@torch.no_grad()
def guarded_len(torch_model, prompt, tokens, margin=MARGIN):
    """How many leading generated `tokens` (after `prompt`) sit at
    positions whose top-1/top-2 margin is >= `margin`, with the logits
    taken from a full forward of the port model over prompt+tokens."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])
    ids = torch.as_tensor(seq[None].astype(np.int64))
    lg = torch_model(ids)[0, len(prompt) - 1:len(seq) - 1]
    top2 = torch.topk(lg.float(), 2, dim=-1).values
    low = np.flatnonzero((top2[:, 0] - top2[:, 1]).numpy() < margin)
    return int(low[0]) if len(low) else len(tokens)


def assert_tokens_equal_guarded(torch_model, prompt, want, got,
                                margin=MARGIN):
    """`got` equals `want` at every position before the first one where
    `want`'s own margin is below `margin`; returns that guarded length."""
    n = guarded_len(torch_model, prompt, want, margin)
    np.testing.assert_array_equal(np.asarray(got)[:n],
                                  np.asarray(want)[:n])
    return n
