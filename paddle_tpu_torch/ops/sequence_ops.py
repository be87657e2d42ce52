"""Sequence and decoding ops (counterpart of
paddle_tpu/ops/sequence_ops.py): CTC loss, viterbi decode,
gather_tree, top-p sampling, edit distance and class-center sampling.

The reference writes each recurrence as a ``lax.scan`` over time; the
port runs the same recurrence as a loop of whole-batch torch ops on the
inputs' device (T steps of [B, S] work each, no read-back), so the
arithmetic, the masking past each length and the tie rules (first
maximum) are the reference's. ``edit_distance``'s inner scan over the
reference's columns is the closed form of its recurrence, a running
minimum (``cummin``), exact on these small integers.

The random ops take a ``torch.Generator`` (``generator=``) where the
reference takes a ``jax.random`` key; a ``seed`` makes a generator of
its own on the inputs' device, as the reference makes a key from it.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["ctc_loss", "viterbi_decode", "gather_tree", "top_p_sampling",
           "edit_distance", "class_center_sample"]

_NEG = -1e30


@register_op("ctc_loss", amp_policy="black")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss by the log-space alpha recursion (sequence_ops.py:29).
    log_probs [T, B, C] (normalised here by log_softmax), labels [B, L],
    input_lengths and label_lengths [B]."""
    log_probs = torch.log_softmax(log_probs.to(torch.float32), dim=-1)
    T, B, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    lab_len = label_lengths.long()
    in_len = input_lengths.long()
    s_len = 2 * lab_len + 1
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    neg1 = torch.full((B, 1), _NEG, device=dev)
    neg2 = torch.full((B, 2), _NEG, device=dev)

    def emit(t):
        return log_probs[t].gather(1, ext)

    e0 = emit(0)
    alpha = torch.full((B, S), _NEG, device=dev)
    alpha[:, 0] = e0[:, 0]
    alpha[:, 1] = torch.where(lab_len > 0, e0[:, 1],
                              torch.full_like(e0[:, 1], _NEG))
    for t in range(1, T):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        a = torch.logaddexp(alpha, prev1)
        a = torch.where(can_skip, torch.logaddexp(a, prev2), a)
        new = a + emit(t)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = alpha.gather(1, (s_len - 1)[:, None])[:, 0]
    last2 = alpha.gather(1, torch.clamp_min(s_len - 2, 0)[:, None])[:, 0]
    ll = torch.logaddexp(last, torch.where(lab_len > 0, last2,
                                           torch.full_like(last2, _NEG)))
    loss = -ll
    if norm_by_times:
        loss = loss / torch.clamp_min(in_len.to(torch.float32), 1.0)
    if reduction == "mean":
        # the reference divides by the label length before averaging
        return torch.mean(
            loss / torch.clamp_min(lab_len.to(torch.float32), 1.0))
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@register_op("viterbi_decode")
def viterbi_decode(potentials, transition, lengths,
                   include_bos_eos_tag=True):
    """CRF viterbi decode (sequence_ops.py:95). potentials [B, T, N],
    transition [N, N], lengths [B]; returns (scores [B], paths [B, T]
    int32, 0 past each length)."""
    B, T, N = potentials.shape
    lengths = lengths.long()
    trans = transition.to(torch.float32)
    pots = potentials.to(torch.float32)
    dev = pots.device
    # tag N-2 is BOS, N-1 EOS (the reference's convention)
    score = pots[:, 0] + trans[N - 2][None, :] if include_bos_eos_tag \
        else pots[:, 0]
    ident = torch.arange(N, device=dev)[None, :].expand(B, N)
    backs = []
    for t in range(1, T):
        cand = score[:, :, None] + trans[None, :, :]       # [B, from, to]
        best, back = torch.max(cand, dim=1)
        best = best + pots[:, t]
        live = (t < lengths)[:, None]
        score = torch.where(live, best, score)
        backs.append(torch.where(live, back, ident))
    final = score + trans[:, N - 1][None, :] if include_bos_eos_tag \
        else score
    best_score, tag = torch.max(final, dim=1)
    path = [tag]
    for back in reversed(backs):
        tag = back.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    paths = torch.stack(path[::-1], dim=1)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    return best_score, torch.where(mask, paths, 0).to(torch.int32)


@register_op("gather_tree")
def gather_tree(ids, parents):
    """The beam-search ancestry backtrace (sequence_ops.py:147): ids and
    parents [max_time, batch, beam]."""
    T, B, W = ids.shape
    beam = torch.arange(W, device=ids.device).expand(B, W)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].gather(1, beam.long()).long()
    return torch.stack(out, dim=0)


def _seeded(seed, generator, device):
    if seed is not None and seed >= 0:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator


@register_op("top_p_sampling", random=True)
def top_p_sampling(x, ps, seed=None, generator=None):
    """Nucleus sampling (sequence_ops.py:165): x [B, V] probabilities, ps
    [B] thresholds; the smallest prefix of the sorted probabilities
    whose mass exceeds ps (at least one token), sampled by Gumbel-max.
    Returns (the sampled probabilities [B, 1], ids [B, 1] int32)."""
    B, V = x.shape
    g = _seeded(seed, generator, x.device)
    probs = x.to(torch.float32)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep = (csum - sorted_p) < ps[:, None]
    masked = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    u = torch.rand(masked.shape, generator=g, device=x.device)
    u = u * (1.0 - 1e-20) + 1e-20
    gumbel = -torch.log(-torch.log(u))
    score = torch.where(keep, torch.log(torch.clamp_min(masked, 1e-30))
                        + gumbel, torch.full_like(masked, -torch.inf))
    pick = torch.argmax(score, dim=-1)
    ids = order.gather(1, pick[:, None])
    return probs.gather(1, ids), ids.to(torch.int32)


@register_op("edit_distance")
def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized=True):
    """Levenshtein distance (sequence_ops.py:192): hyps [B, L1], refs
    [B, L2], optional lengths [B]. Returns (distance [B, 1] float32,
    sequence_num [1] int32)."""
    B, L1 = hyps.shape
    L2 = refs.shape[1]
    dev = hyps.device
    if hyp_lengths is None:
        hyp_lengths = torch.full((B,), L1, dtype=torch.long, device=dev)
    if ref_lengths is None:
        ref_lengths = torch.full((B,), L2, dtype=torch.long, device=dev)
    hyp_lengths, ref_lengths = hyp_lengths.long(), ref_lengths.long()
    cols = torch.arange(L2 + 1, dtype=torch.float32, device=dev)
    row = cols.expand(B, L2 + 1)
    for i in range(L1):
        sub_cost = (refs != hyps[:, min(i, L1 - 1)][:, None]).to(
            torch.float32)
        base = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub_cost)
        first = torch.full((B, 1), float(i + 1), device=dev)
        # new[j] = min(base[j], new[j-1] + 1), new[0] = i + 1: a running
        # minimum of (value - column) plus the column
        c = torch.cat([first, base - cols[1:]], dim=1)
        new = torch.cummin(c, dim=1).values + cols
        row = torch.where((i < hyp_lengths)[:, None], new, row)
    dist = row.gather(1, ref_lengths[:, None])[:, 0]
    if normalized:
        dist = dist / torch.clamp_min(ref_lengths.to(torch.float32), 1.0)
    return dist[:, None], torch.tensor([B], dtype=torch.int32, device=dev)


@register_op("class_center_sample", random=True)
def class_center_sample(label, num_classes, num_samples, seed=None,
                        generator=None):
    """Partial-FC class-center sampling (sequence_ops.py:244): every
    positive class (in class order), then random negatives, exactly
    num_samples of them; labels remapped into the sampled index space.
    Returns (remapped labels, sampled classes), both int32."""
    dev = label.device
    g = _seeded(seed, generator, dev)
    label = label.long()
    pos = torch.zeros((num_classes,), dtype=torch.bool, device=dev)
    pos[label] = True
    noise = torch.rand((num_classes,), generator=g, device=dev)
    rank_key = torch.where(pos, torch.full_like(noise, -1.0), noise)
    order = torch.argsort(rank_key, stable=True)
    sampled = order[:num_samples]
    inv = torch.full((num_classes,), -1, dtype=torch.int32, device=dev)
    inv[sampled] = torch.arange(num_samples, dtype=torch.int32, device=dev)
    return inv[label], sampled.to(torch.int32)
