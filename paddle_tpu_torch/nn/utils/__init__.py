"""nn.utils (counterpart of paddle_tpu/nn/utils/__init__.py): the
weight-norm and spectral-norm reparameterisations of a layer's weight,
the gradient clips, and parameters to and from one vector.

They take the port's ``Layer``s (and the models' ``Layer`` children) and
parameters given as Parameters (Tensors) or torch tensors. A
reparameterised layer's ``forward`` is wrapped: it derives the weight
from the new parameters, and its own forward reads it under the old
name (``_parameters[name]``, for that call only); ``layer.<name>``
holds the last derived value. Gradients reach the new parameters
through torch autograd, eagerly as in a compiled step (the reference's
eager tape does not see through the derivation, ROADMAP Queue C)."""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from ... import ops  # at call time: ops imports nn first
from ..clip import clip_grad_norm_ as _clip_grad_norm
from ..layer import Parameter

__all__ = ["spectral_norm", "weight_norm", "remove_weight_norm",
           "clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters"]


def _torch(t):
    return t._data if isinstance(t, Tensor) else t


def _l2(x, axes=None, keepdim=False):
    """sqrt(sum(x * x)) over `axes` (all by default), as jnp.linalg.norm
    of a vector (or a Frobenius norm) computes it."""
    sq = x * x
    return torch.sqrt(sq.sum() if axes is None else sq.sum(axes, keepdim))


def _wrap_forward(layer, name, derive):
    """Replace layer.forward by one that derives `name`'s value first
    (``derive()``), lets the layer's own forward read it, and keeps it
    as ``layer.<name>``. Returns the original forward."""
    real_forward = layer.forward

    def hooked(*args, **kwargs):
        w = derive()
        object.__setattr__(layer, name, Tensor._wrap(w.detach()))
        layer._parameters[name] = w
        try:
            return real_forward(*args, **kwargs)
        finally:
            del layer._parameters[name]

    object.__setattr__(layer, "forward", hooked)
    return real_forward


def _drop(layer, name):
    """Take parameter `name` out of `layer` (its wrapper too)."""
    layer._parameters.pop(name, None)
    layer.__dict__.get("_wrappers", {}).pop(name, None)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Each forward divides `name` (now the trainable ``<name>_orig``) by
    its largest singular value over the axes other than `dim` (default
    0), estimated by power iteration in f32 from ``<name>_u``, which
    persists across calls (first ones / sqrt(h)), as in the reference
    (nn/utils/__init__.py:16)."""
    dim = 0 if dim is None else dim
    orig = layer._parameters[name]
    layer.add_parameter(name + "_orig", Parameter._of(orig))
    _drop(layer, name)

    def derive():
        w = layer._parameters[name + "_orig"]
        mat = w.movedim(dim, 0)
        mat = mat.reshape(mat.shape[0], -1).float()
        u = layer.__dict__.get(name + "_u")
        if u is None:
            u = torch.ones(mat.shape[0], device=mat.device) / np.sqrt(
                mat.shape[0])
        for _ in range(max(n_power_iterations, 1)):
            v = mat.T @ u
            v = v / torch.clamp_min(_l2(v), eps)
            u = mat @ v
            u = u / torch.clamp_min(_l2(u), eps)
        object.__setattr__(layer, name + "_u", u.detach())
        sigma = u @ mat @ v
        return (w.float() / torch.clamp_min(sigma, eps)).to(w.dtype)

    _wrap_forward(layer, name, derive)
    return layer


def _weight_norm_axes(ndim, dim):
    return tuple(range(ndim)) if dim is None else tuple(
        i for i in range(ndim) if i != dim % ndim)


def weight_norm(layer, name="weight", dim=0):
    """w = g * v / |v| (nn/utils/__init__.py:58): the new parameters
    ``<name>_g`` (the norm over every axis but `dim`; a scalar with
    dim=None) and ``<name>_v`` (the weight) replace `name`."""
    w = layer._parameters[name]
    axes = _weight_norm_axes(w.dim(), dim)
    with torch.no_grad():
        g = _l2(w.float(), axes, keepdim=True).to(w.dtype)
        v = w.detach().clone()
    layer.add_parameter(name + "_g", Parameter._of(torch.nn.Parameter(g)))
    layer.add_parameter(name + "_v", Parameter._of(torch.nn.Parameter(v)))
    _drop(layer, name)

    def derive():
        v_ = layer._parameters[name + "_v"]
        g_ = layer._parameters[name + "_g"]
        vf = v_.float()
        return (vf / torch.clamp_min(_l2(vf, axes, keepdim=True), 1e-12)
                * g_.float()).to(v_.dtype)

    object.__setattr__(layer, "_wn_orig_forward",
                       _wrap_forward(layer, name, derive))
    return layer


def remove_weight_norm(layer, name="weight"):
    """A plain trainable `name` again, from g and v, and the layer's own
    forward back (:88); a layer without weight_norm is returned as it
    is."""
    if "_wn_orig_forward" not in layer.__dict__:
        return layer
    del layer.__dict__["_wn_orig_forward"]
    del layer.__dict__["forward"]
    v = layer._parameters[name + "_v"]
    g = layer._parameters[name + "_g"]
    vf = v.detach().float()
    axes = tuple(i for i in range(vf.dim()) if g.shape[i] == 1) \
        if g.dim() == vf.dim() else tuple(range(vf.dim()))
    w = (vf / torch.clamp_min(_l2(vf, axes, keepdim=True), 1e-12)
         * g.detach().float()).to(v.dtype)
    _drop(layer, name + "_g")
    _drop(layer, name + "_v")
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter._of(torch.nn.Parameter(w)))
    return layer


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """nn.clip's clip_grad_norm_ (one implementation, as in the
    reference); with `error_if_nonfinite` a non-finite total raises
    RuntimeError (a host read). The total is a Tensor when the
    parameters are Tensors, else a torch tensor."""
    if isinstance(parameters, (torch.Tensor, Tensor)):
        parameters = [parameters]
    parameters = list(parameters)
    total = _clip_grad_norm(parameters, max_norm, norm_type=norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("gradient norm is non-finite")
    return Tensor._wrap(total, stop_gradient=True) \
        if any(isinstance(p, Tensor) for p in parameters) else total


def clip_grad_value_(parameters, clip_value):
    """Each gradient clamped to [-clip_value, clip_value] in place."""
    for p in parameters:
        g = _torch(p).grad
        if g is not None:
            g.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters):
    """The parameters flattened and concatenated (recorded, as the
    reference's concat op is)."""
    parameters = list(parameters)
    if any(isinstance(p, Tensor) for p in parameters):
        return ops.manipulation.concat(
            [ops.manipulation.reshape(p, (-1,)) for p in parameters])
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters):
    """Consecutive slices of `vec` written into the parameters (reshaped
    and cast to each), in place and unrecorded."""
    vec = _torch(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            d = _torch(p)
            n = d.numel()
            d.copy_(vec[offset:offset + n].reshape(d.shape))
            offset += n
