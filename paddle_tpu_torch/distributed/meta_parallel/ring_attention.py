"""Ring attention: sequence-parallel attention for long context
(counterpart of paddle_tpu/distributed/meta_parallel/ring_attention.py).

In the reference each device of the mesh's sequence axis holds one
chunk of Q, K and V; K and V blocks rotate around the ring (``ppermute``)
while every device accumulates its Q chunk's attention with flash
attention's online-softmax update. The single controller here walks the
same ring: the sequence is cut into the axis's n chunks, and at step j
chunk i of Q meets the K/V chunk (i - j) mod n that the ring has brought
it, every chunk at once, with the same update (`_block_update`). Causal
masking is by global positions: chunk j adds to chunk i fully when
j < i, triangularly when j == i, and not at all when j > i (those steps
run and add zero, as the reference's do for SPMD uniformity). The
reference's computation is jnp, not a kernel, so this stays plain torch;
autograd differentiates the loop. With observability on it keeps the
reference's count-only ``ppermute`` record.
"""
from __future__ import annotations

import math

import torch

from ...observability import comms as _comms
from ...observability import metrics as _om
from ...ops.registry import register_op
from ..topology import PartitionSpec as P
from ..topology import place

__all__ = ["ring_flash_attention", "ring_attention_impl", "RingAttention"]

_NEG_INF = -1e30


def _block_update(q, k, v, acc, m, l, q_pos, k_pos, sm_scale, causal):
    """One online-softmax accumulation of q against a (k, v) block, over
    the chunks at once. q: [b, n, sq, h, d]; k / v: [b, n, sk, h, d];
    acc f32 [b, n, h, sq, d]; m / l: [b, n, h, sq]; q_pos [n, sq], k_pos
    [n, sk] global positions."""
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = q_pos[:, :, None] >= k_pos[:, None, :]        # [n, sq, sk]
        s = torch.where(mask[None, :, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # a fully masked row (no valid key yet) keeps exp stable
    finite = torch.isfinite(m_new)
    safe_m = torch.where(finite, m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(finite[..., None], p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = alpha * l + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bnhqk,bnkhd->bnhqd", p, v.float())
    return acc_new, m_new, l_new


def ring_attention_impl(q, k, v, mesh=None, axis: str = "sep",
                        causal: bool = True, softmax_scale=None):
    """Ring attention on torch tensors [batch, seq, heads, head_dim]
    over `mesh`'s `axis` (a `RankMesh`)."""
    if mesh is None:
        raise ValueError(
            "ring attention needs a mesh with the sequence axis "
            f"({axis!r})")
    n = mesh.shape[axis]
    b, s, h, d = q.shape
    if s % n:
        raise ValueError(f"seq {s} not divisible by {axis} size {n}")
    if _om._ENABLED:
        # count-only, as the reference's: n steps, each rotating every
        # device's K and V blocks once
        kv_bytes = (k.numel() + v.numel()) * k.element_size() // n
        _comms.count("ppermute", axis, kv_bytes * n, n=2 * n)
    sm_scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(d)
    s_loc = s // n
    qc = q.reshape(b, n, s_loc, h, d)
    kc = k.reshape(b, n, s_loc, h, d)
    vc = v.reshape(b, n, s_loc, h, d)
    chunk = torch.arange(n, device=q.device)
    pos = torch.arange(s_loc, device=q.device)
    q_pos = chunk[:, None] * s_loc + pos[None, :]
    acc = torch.zeros((b, n, h, s_loc, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, n, h, s_loc), -math.inf, device=q.device)
    l = torch.zeros((b, n, h, s_loc), device=q.device)
    for step in range(n):
        # chunk i holds the K/V chunk (i - step) mod n at this step
        src = (chunk - step) % n
        k_pos = src[:, None] * s_loc + pos[None, :]
        acc, m, l = _block_update(qc, kc[:, src], vc[:, src], acc, m, l,
                                  q_pos, k_pos, sm_scale, causal)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l[..., None]).to(q.dtype)      # [b, n, h, sq, d]
    out = out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d)
    return place(out, mesh, P(None, axis, None, None))


@register_op("ring_flash_attention")
def ring_flash_attention(q, k, v, mesh=None, axis: str = "sep",
                         causal: bool = True, softmax_scale=None):
    """Sequence-parallel attention over `mesh[axis]`.

    q, k, v: [batch, seq, heads, head_dim] Tensors or arrays, the
    sequence divisible by the axis size. Returns the output in the same
    layout, its placement split on the sequence axis. A registered op,
    so the eager API records its backward; torch-level callers use
    `ring_attention_impl`."""
    return ring_attention_impl(q, k, v, mesh=mesh, axis=axis,
                               causal=causal, softmax_scale=softmax_scale)


class RingAttention:
    """A layer-style wrapper of the sep-parallel attention (in place of
    the model's SDPA when fleet's sep axis is above 1)."""

    def __init__(self, mesh=None, axis="sep", causal=True):
        if mesh is None:
            from ..topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            mesh = hcg.mesh if hcg is not None else None
        if mesh is None:
            raise ValueError(
                "RingAttention needs a mesh: pass one or call "
                "fleet.init(strategy) with a sep axis first")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: "
                             f"{tuple(mesh.shape)}")
        self.mesh = mesh
        self.axis = axis
        self.causal = causal

    def __call__(self, q, k, v):
        return ring_flash_attention(q, k, v, self.mesh, self.axis,
                                    self.causal)
