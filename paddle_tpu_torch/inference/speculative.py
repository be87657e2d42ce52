"""Speculative decoding for the paged serving engine (counterpart of
paddle_tpu/inference/speculative.py; the same proposers, config and
acceptance rule).

Decode is bandwidth-bound: every step streams the weights and the
KV pool to emit ONE token per sequence. Speculative decoding spends the
idle arithmetic on tokens: a cheap *draft proposer* guesses k
continuation tokens per sequence, ONE packed verify wave scores all
k+1 positions against the paged pool, the longest matching draft
prefix commits in bulk, and the first rejected position rolls the KV
lease back in `PagedKVCache.truncate`: pages past the accepted length
are unref'd, and only fully-accepted blocks ever enter the
prefix-cache hash index.

Two built-in proposers need no second engine:

  * `NgramProposer`: prompt-lookup / n-gram drafting: match the last
    n tokens of the request's own prompt+output against its earlier
    context and propose the continuation after the most recent match.
    Host-side numpy, and effective on repetitive traffic (code,
    templated few-shot answers, self-repeating greedy loops).
  * `DraftModelProposer`: greedy drafting with any smaller model that
    shares the tokenizer, through the port's dense
    `models.generation.generate` on the drafting model's device.
    (Handing it the target model itself is the 100%-acceptance oracle
    the conformance tests pin.)

Verification is greedy-only: acceptance compares drafts against the
target model's argmax, which keeps the greedy stream (`LLMEngine`
refuses `speculative_config` with `do_sample=True` rather than change
the sampling distribution).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

__all__ = ["DraftProposer", "NgramProposer", "DraftModelProposer",
           "SpeculativeConfig", "accept_drafts"]


class DraftProposer:
    """Pluggable draft source for speculative decoding.

    One method: `propose(context, k)` gets the sequence's FULL current
    token context (prompt + generated, int32 1-D numpy) and returns up
    to `k` int32 draft tokens continuing it (an empty array is always
    legal — that sequence simply decodes one token this step). Called
    on the host once per sequence per engine step, so proposers must be
    cheap relative to a device step."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NgramProposer(DraftProposer):
    """Prompt-lookup (n-gram) drafting: self-drafting from the
    request's own tokens, no second model.

    The last `n` tokens (n from `max_n` down to `min_n`) are matched
    against every earlier position of the context; on a hit, the
    tokens FOLLOWING the most recent earlier occurrence are proposed.
    A repetitive context — templated few-shot prompts, code, a greedy
    loop that entered a cycle — makes the continuation after the match
    an excellent guess; a miss proposes nothing and costs nothing."""

    def __init__(self, min_n: int = 1, max_n: int = 4):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got ({min_n}, {max_n})")
        self.min_n = int(min_n)
        self.max_n = int(max_n)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).reshape(-1)
        L = len(ctx)
        empty = np.zeros((0,), np.int32)
        if k <= 0 or L < 2:
            return empty
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pattern = ctx[L - n:]
            # candidate start positions of an EARLIER occurrence whose
            # continuation exists: match at pos means ctx[pos:pos+n] ==
            # pattern with pos+n < L (pos = L-n is the suffix itself)
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:-1], n) if L - 1 >= n else None
            if windows is None or not len(windows):
                continue
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            if not len(hits):
                continue
            # prefer the MOST RECENT match that still has k
            # continuation tokens (recency tracks the current phase of
            # a repetition); fall back to the earliest match, whose
            # continuation is the longest available
            pos = int(hits[0])
            for h in hits[::-1]:
                if h + n + k <= L:
                    pos = int(h)
                    break
            start = pos + n
            return ctx[start:start + k].copy()
        return empty


class DraftModelProposer(DraftProposer):
    """Greedy draft-model proposer: any (smaller) causal LM sharing
    the target's tokenizer drafts k tokens through the dense
    `generate()` path, on the drafting model's own device. Draft quality only affects speed, never
    outputs — a rejected draft costs its verify slot and nothing else.

    max_model_len caps the context fed to the draft model (the TAIL of
    the context is kept — recent tokens carry the signal); defaults to
    the draft model's own max_position_embeddings minus the draft
    budget."""

    def __init__(self, model, max_model_len: Optional[int] = None):
        self.model = model
        self._cap = int(max_model_len
                        or model.config.max_position_embeddings)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        from ..models.generation import generate
        ctx = np.asarray(context, np.int32).reshape(-1)
        if k <= 0 or not len(ctx):
            return np.zeros((0,), np.int32)
        keep = max(1, self._cap - k)
        ctx = ctx[-keep:]
        out = generate(self.model, ctx[None], max_new_tokens=k,
                       device=self.model.device)
        arr = out.cpu().numpy().astype(np.int32)
        return arr[0, len(ctx):len(ctx) + k].copy()


@dataclasses.dataclass
class SpeculativeConfig:
    """`LLMEngine(speculative_config=SpeculativeConfig(...))` knobs.

    proposer: "ngram" (default, self-drafting prompt-lookup),
        "draft_model" (greedy small-model drafting via `draft_model`),
        or any `DraftProposer` instance.
    num_speculative_tokens: max drafts verified per sequence per step.
        The verify step leases k+1 tokens of headroom, capped at the
        request's admission-validated token budget — speculation can
        never hold pages a request was not already entitled to, so
        worst-case pool pressure is unchanged; with k+1 <=
        decode_chunk even the per-step transient lease never exceeds
        the chunked path's.
    ngram_min / ngram_max: `NgramProposer` match-window bounds.
    draft_model: the drafting model for proposer="draft_model"."""

    proposer: Union[str, DraftProposer] = "ngram"
    num_speculative_tokens: int = 3
    ngram_min: int = 1
    ngram_max: int = 4
    draft_model: object = None

    def build_proposer(self) -> DraftProposer:
        if isinstance(self.proposer, DraftProposer):
            return self.proposer
        if self.proposer == "ngram":
            return NgramProposer(self.ngram_min, self.ngram_max)
        if self.proposer == "draft_model":
            if self.draft_model is None:
                raise ValueError(
                    "SpeculativeConfig(proposer='draft_model') needs "
                    "draft_model=<a causal LM sharing the tokenizer>")
            return DraftModelProposer(self.draft_model)
        raise ValueError(
            f"unknown proposer {self.proposer!r}: pass 'ngram', "
            "'draft_model', or a DraftProposer instance")

    def __post_init__(self):
        if int(self.num_speculative_tokens) < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        self.num_speculative_tokens = int(self.num_speculative_tokens)


def accept_drafts(drafts: np.ndarray, targets: np.ndarray) -> int:
    """Longest accepted draft prefix under greedy verification.

    `targets[j]` is the target model's argmax at position j of the
    verify window (position 0 scores the last committed token, so
    `targets[j]` is what greedy decode would emit AFTER j accepted
    drafts). Draft j is accepted iff every earlier draft was and
    `drafts[j] == targets[j]`. Returns the number of accepted drafts
    `a`; the engine then commits `targets[:a+1]` — the a matching
    drafts plus the verify pass's bonus token — so every step emits at
    least one token and the committed stream is exactly the greedy
    stream."""
    drafts = np.asarray(drafts).reshape(-1)
    targets = np.asarray(targets).reshape(-1)
    a = 0
    while a < len(drafts) and a < len(targets) \
            and int(drafts[a]) == int(targets[a]):
        a += 1
    return a
