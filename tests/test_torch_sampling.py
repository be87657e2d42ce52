"""Sampling of paddle_tpu_torch's `generate` / LLMEngine (`_pick_token`:
temperature, top-k, top-p) against paddle_tpu's, as DISTRIBUTIONS: the
draws come from different generators (torch's Philox / mt19937 against
jax.random), so no draw is compared, only how often each token comes.

On fixed logits over 16 tokens, each side draws N = 4000 tokens (one
batch of N identical rows). Each histogram is held to the exact
distribution the keep rule gives (numpy float64) by Pearson's chi-square
over the kept tokens, and the two histograms to each other by the
two-sample chi-square; a p-value below 1e-4 fails (the chance that a
correct sampler fails a given check is 1e-4). A token the rule drops is
never drawn on either side. Also: `generate(seed=None)` draws from the
default generator (`paddle_tpu_torch.seed` fixes it), and greedy leaves
the generator untouched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu_torch as ptt
from paddle_tpu.models.generation import _pick_token as jax_pick
from paddle_tpu_torch.core.generator import default_generator
from paddle_tpu_torch.models import generate
from paddle_tpu_torch.models.generation import _pick_token as torch_pick
from torch_fleet_cases import tiny_gpt

N, V = 4000, 16
P_MIN = 1e-4
LOGITS = np.array([2.0, 1.7, 1.5, 1.2, 1.0, 0.9, 0.5, 0.4, 0.1, 0.0,
                   -0.3, -0.5, -1.0, -1.2, -2.0, -3.0], np.float64)[
    np.random.default_rng(0).permutation(V)]


def _expected(temperature, top_p, top_k):
    """The keep rule in float64: temperature, top-k (ties kept), softmax,
    top-p (the smallest high-probability set whose mass reaches top_p,
    the crossing token included), renormalised."""
    lt = LOGITS / max(temperature, 1e-6)
    if top_k and 0 < top_k < V:
        kth = np.sort(lt)[::-1][top_k - 1]
        lt = np.where(lt < kth, -np.inf, lt)
    p = np.exp(lt - lt.max())
    p /= p.sum()
    if top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        sp = p[order]
        drop = (np.cumsum(sp) - sp) >= top_p
        keep = np.zeros(V, bool)
        keep[order[~drop]] = True
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    return p


CASES = {
    "temperature": (0.8, 1.0, 0),
    "top_k": (1.0, 1.0, 5),
    "top_p": (1.0, 0.8, 0),
    "top_k_top_p": (0.7, 0.9, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampling_distribution_equals_the_reference(case):
    temperature, top_p, top_k = CASES[case]
    lf = np.tile(LOGITS.astype(np.float32), (N, 1))
    g = torch.Generator().manual_seed(1)
    got = torch_pick(torch.from_numpy(lf), g, True, temperature, top_p,
                     top_k).numpy()
    want, _key = jax_pick(jnp.asarray(lf), jax.random.PRNGKey(1), True,
                          temperature, top_p, top_k)
    want = np.asarray(want)
    p = _expected(temperature, top_p, top_k)
    kept = p > 0
    hists = {}
    for side, draws in (("port", got), ("ref", want)):
        h = np.bincount(draws.astype(np.int64), minlength=V)
        assert h[~kept].sum() == 0, (side, "drew a dropped token")
        chi = stats.chisquare(h[kept], N * p[kept])
        assert chi.pvalue > P_MIN, (side, chi)
        hists[side] = h[kept]
    table = np.stack([hists["port"], hists["ref"]])
    table = table[:, table.sum(0) > 0]
    two = stats.chi2_contingency(table)
    assert two.pvalue > P_MIN, two


def test_generate_seed_none_draws_from_the_default_generator():
    m = tiny_gpt()
    p = np.random.default_rng(4).integers(0, 1024, (1, 7)).astype(np.int32)
    kw = dict(max_new_tokens=16, do_sample=True, temperature=1.5,
              device="cpu")
    ptt.seed(11)
    a = generate(m, p, **kw)
    b = generate(m, p, **kw)          # the generator moved on
    ptt.seed(11)
    c = generate(m, p, **kw)          # the same seed: the same draws
    assert torch.equal(a, c) and not torch.equal(a, b)
    # greedy touches no generator
    state = default_generator().get_state()
    generate(m, p, max_new_tokens=4, device="cpu")
    after = default_generator().get_state()
    assert state[0] == after[0] and all(
        torch.equal(state[1][k], after[1][k]) for k in state[1])
