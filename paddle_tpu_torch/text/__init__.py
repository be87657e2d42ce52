"""paddle.text (counterpart of paddle_tpu/text/__init__.py).

`ViterbiDecoder` holds a CRF transition matrix and decodes with the
port's `ops.viterbi_decode` (ops/sequence_ops.py, tensor ops on the
device of its inputs); the dataset zoo parses the reference's local
archives (datasets.py)."""
from __future__ import annotations

from ..nn.layer import Layer
from ..ops import viterbi_decode
from . import datasets
from .datasets import Imdb, Imikolov, UCIHousing

__all__ = ["viterbi_decode", "ViterbiDecoder", "datasets", "Imdb",
           "Imikolov", "UCIHousing"]


class ViterbiDecoder(Layer):
    """Holds the transition matrix; forward decodes (reference :18-29,
    after python/paddle/text/viterbi_decode.py:99). Returns (scores
    [B], paths [B, T] int32, 0 past each length)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
