"""Attention-bias classes of memory_efficient_attention (counterpart of
paddle_tpu/incubate/nn/attn_bias.py, the xformers-style taxonomy). Each
class materialises itself as an additive float mask (-1e30 where a
position is masked); memory_efficient_attention also recognises the
causal and block-diagonal classes and keeps them on the flash path
(B1: causal, or segment ids) without materialising them."""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...core.device import default_torch_device
from ...core.tensor import Tensor

__all__ = ["AttentionBias", "LowerTriangularMask",
           "LowerTriangularMaskWithTensorBias", "SeqLenInfo", "segment_ids",
           "BlockDiagonalMask", "BlockDiagonalCausalMask"]

NEG = -1e30


def _device(device):
    return default_torch_device() if device is None else torch.device(device)


class AttentionBias(ABC):
    @abstractmethod
    def materialize(self, shape, dtype=torch.float32, *, device=None):
        """Additive bias broadcastable to [b, h, sq, sk], on `device`
        (None: the eager default place)."""


class LowerTriangularMask(AttentionBias):
    """Causal mask: q row i sees k columns <= i + sk - sq."""

    def materialize(self, shape, dtype=torch.float32, *, device=None):
        sq, sk = shape[-2], shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=_device(device)).tril(sk - sq)
        return torch.where(keep, 0.0, NEG).to(dtype)


class LowerTriangularMaskWithTensorBias(LowerTriangularMask):
    """Causal plus an additive tensor bias (ALiBi slopes, say)."""

    def __init__(self, bias):
        self._bias = bias

    def materialize(self, shape, dtype=torch.float32, *, device=None):
        base = super().materialize(shape, dtype, device=device)
        b = self._bias._data if isinstance(self._bias, Tensor) else \
            torch.as_tensor(self._bias)
        return base + b.to(base.device, dtype)


@dataclass
class SeqLenInfo:
    """Cumulative packing offsets of block-diagonal masks."""
    seqstart: List[int]

    @classmethod
    def from_seqlens(cls, seqlens):
        starts = [0]
        for s in seqlens:
            starts.append(starts[-1] + int(s))
        return cls(seqstart=starts)

    @property
    def seqlens(self):
        return [b - a for a, b in zip(self.seqstart, self.seqstart[1:])]


def segment_ids(starts, total, *, device=None):
    """int32 [total]: each packed position's sequence index. The packing
    must cover the tensor exactly (a short list would give the tail
    tokens segment 0 and leak attention across sequences)."""
    if starts[-1] != total:
        raise ValueError(
            f"seqlens sum to {starts[-1]} but the packed sequence "
            f"length is {total}")
    seg = np.zeros((total,), np.int32)
    for i, (a, b) in enumerate(zip(starts, starts[1:])):
        seg[a:b] = i
    return torch.from_numpy(seg).to(_device(device))


class BlockDiagonalMask(AttentionBias):
    """Packed variable-length sequences: a token attends within its own
    sequence only."""

    def __init__(self, q_seqinfo: SeqLenInfo,
                 k_seqinfo: Optional[SeqLenInfo] = None):
        self.q_seqinfo = q_seqinfo
        self.k_seqinfo = k_seqinfo or q_seqinfo

    @classmethod
    def from_seqlens(cls, q_seqlen, kv_seqlen=None):
        qs = SeqLenInfo.from_seqlens(q_seqlen)
        ks = SeqLenInfo.from_seqlens(kv_seqlen) if kv_seqlen else None
        return cls(qs, ks)

    def _segs(self, sq, sk, device):
        return (segment_ids(self.q_seqinfo.seqstart, sq, device=device),
                segment_ids(self.k_seqinfo.seqstart, sk, device=device))

    def _block_keep(self, sq, sk, device=None):
        qseg, kseg = self._segs(sq, sk, device)
        return qseg[:, None] == kseg[None, :]

    def materialize(self, shape, dtype=torch.float32, *, device=None):
        keep = self._block_keep(shape[-2], shape[-1], device)
        return torch.where(keep, 0.0, NEG).to(dtype)

    def make_causal(self):
        return BlockDiagonalCausalMask(self.q_seqinfo, self.k_seqinfo)


class BlockDiagonalCausalMask(BlockDiagonalMask):
    """Block-diagonal and causal within each sequence: q local position
    i of a block sees kv local positions <= i of the same block (equal
    to a global diagonal only when the q and kv packings coincide)."""

    def materialize(self, shape, dtype=torch.float32, *, device=None):
        sq, sk = shape[-2], shape[-1]
        qseg, kseg = self._segs(sq, sk, device)
        dev = qseg.device
        qstart = torch.tensor(self.q_seqinfo.seqstart, device=dev)
        kstart = torch.tensor(self.k_seqinfo.seqstart, device=dev)
        qlocal = torch.arange(sq, device=dev) - qstart[qseg.long()]
        klocal = torch.arange(sk, device=dev) - kstart[kseg.long()]
        keep = (qseg[:, None] == kseg[None, :]) & \
            (klocal[None, :] <= qlocal[:, None])
        return torch.where(keep, 0.0, NEG).to(dtype)
