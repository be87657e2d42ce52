"""The expert-parallel MoE layer (counterpart of
paddle_tpu/distributed/meta_parallel/moe_layer.py).

GShard's capacity-factor dispatch, as the reference computes it: top-k
routing of each token over the gate's softmax, a position in each
expert's buffer by a running count over (token, choice) pairs, a token
past the expert's capacity dropped, the kept gates renormalised, then a
dense [tokens, experts, capacity] one-hot dispatch and combine around
the stacked experts' FFN. Two details follow the reference exactly:
the experts' GELU is the tanh approximation (``jax.nn.gelu``'s default),
and among equal gate probabilities the lower expert index ranks first
(``jax.lax.top_k``'s order; here a stable descending sort).

With one controller the expert weights are whole on the device and
their ``P("mp", ...)`` placement is recorded at mp > 1. In
process-group mode at mp > 1 (the expert all-to-all) the layer raises
``NotImplementedError``: ROADMAP item 26b2.
"""
from __future__ import annotations

import math

import torch

from ...nn.layer import Layer
from ...ops.registry import register_op
from ..topology import PartitionSpec as P
from ..topology import get_hybrid_communicate_group, place

__all__ = ["MoELayer"]


def _route(x, gate_w, top_k, capacity_factor):
    """The routing of `x` [tokens, d] by the gate `gate_w` [d, experts]:
    (probs [t, e] f32, topv [t, k], topi [t, k], pos [t, k] the slot in
    the expert's buffer, keep [t, k] within capacity, gates [t, k] the
    kept probabilities renormalised, cap)."""
    t = x.shape[0]
    e = gate_w.shape[1]
    cap = int(math.ceil(top_k * capacity_factor * t / e))
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[:, :top_k], order.indices[:, :top_k]
    onehot = torch.nn.functional.one_hot(topi, e).to(torch.int32)
    pos_in_expert = (torch.cumsum(onehot.reshape(t * top_k, e), dim=0)
                     - 1).reshape(t, top_k, e)
    pos = (pos_in_expert * onehot).sum(-1)
    keep = pos < cap
    gates = topv * keep.to(topv.dtype)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi, pos, keep, gates, cap


@register_op("moe_gshard_dispatch")
def _moe_forward(x, gate_w, w1, b1, w2, b2, top_k=2, capacity_factor=1.5,
                 train=True):
    """[tokens, d] -> top-k routing -> each expert's FFN -> combine.
    Returns (out, aux_loss)."""
    e = gate_w.shape[1]
    probs, _topv, topi, pos, keep, gates, cap = _route(
        x, gate_w, top_k, capacity_factor)
    onehot = torch.nn.functional.one_hot
    disp = None
    comb = None
    for k in range(top_k):
        sel = onehot(topi[:, k], e).to(x.dtype) * keep[:, k:k + 1].to(
            x.dtype)
        # a slot past the capacity is all zeros (jax.nn.one_hot's rule)
        poh = onehot(pos[:, k].long().clamp(max=cap), cap + 1)[:, :cap].to(
            x.dtype)
        d_k = sel[:, :, None] * poh[:, None, :]
        c_k = (gates[:, k:k + 1] * sel.float())[:, :, None] * \
            poh.float()[:, None, :]
        disp = d_k if disp is None else disp + d_k
        comb = c_k if comb is None else comb + c_k
    expert_in = torch.einsum("tec,td->ecd", disp, x)
    h = torch.einsum("ecd,edf->ecf", expert_in, w1) + b1[:, None, :]
    h = torch.nn.functional.gelu(h, approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
    out = torch.einsum("tec,ecd->td", comb.to(x.dtype), expert_out)
    # GShard's load-balance auxiliary loss
    me = probs.mean(0)
    ce = onehot(topi[:, 0], e).float().mean(0)
    aux = (me * ce).sum() * e
    return out, aux.to(x.dtype)


class MoELayer(Layer):
    """A GShard MoE FFN: the reference's MoELayer (d_model, experts,
    top_k), its experts stacked on a leading expert axis."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.5, gate="gshard", group=None,
                 recompute_interval=0):
        super().__init__()
        hcg = get_hybrid_communicate_group()
        mp = hcg.get_model_parallel_world_size() if hcg is not None else 1
        if mp > 1 and hcg.get_model_parallel_group()._torch_group \
                is not None:
            raise NotImplementedError(
                "MoELayer at mp > 1 with a torch.distributed process group "
                "(the expert all-to-all) is not ported: ROADMAP item 26b2")
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.gate_weight = self.create_parameter((d_model, num_experts))
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden))
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        is_bias=True)
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model))
        self.b2 = self.create_parameter((num_experts, d_model),
                                        is_bias=True)
        if mp > 1 and num_experts % mp == 0:
            for p, spec in ((self.w1, P("mp", None, None)),
                            (self.b1, P("mp", None)),
                            (self.w2, P("mp", None, None)),
                            (self.b2, P("mp", None))):
                place(p, hcg.mesh, spec)
        self.aux_loss = None

    def forward(self, x):
        """`x` a Tensor (the eager API: Tensors out, `aux_loss` a
        Tensor) or a torch tensor (torch tensors out)."""
        shape = list(x.shape)
        names = ("gate_weight", "w1", "b1", "w2", "b2")
        if isinstance(x, torch.Tensor):
            params = [self._parameters[n] for n in names]
        else:
            params = [getattr(self, n) for n in names]
        out, aux = _moe_forward(
            x.reshape([-1, self.d_model]), *params, top_k=self.top_k,
            capacity_factor=self.capacity_factor, train=self.training)
        self.aux_loss = aux
        return out.reshape(shape)
