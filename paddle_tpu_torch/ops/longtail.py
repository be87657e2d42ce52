"""The long-tail ops (counterpart of paddle_tpu/ops/longtail.py): the
splits and stacks, the index ops, the ``*_scatter`` ops, the special
functions, histograms and distances, the complex views, the linear
algebra tail and the YAML ops of the reference's second batch.

Each op computes the reference's function with torch on its inputs'
device: the reference's jnp expressions where torch has no op of the
same definition (``frexp``, ``auc_op``, ``histogramdd``,
``multigammaln``, the p=2 ``cdist``), torch's own op where it has one.
Gradients come from torch.autograd, except for ``gammainc`` /
``gammaincc`` with respect to their first argument, which torch does
not differentiate: ``_IncGamma`` gives it by a central difference in
float64 (JAX differentiates it by a series; the two agree to ~1e-8
relative).

``geqrf`` is LAPACK's on the CPU and cuSOLVER's on the card (the
reference calls LAPACK through a host callback); ``take`` checks its
bounds on every call in mode "raise" (the reference's eager check,
:124), reading two scalars back. ``rnnt_loss_op`` (:389) is the one of
``nn.functional``.
"""
from __future__ import annotations

import itertools as _it
import math

import numpy as np
import torch

from ..core.tensor import Tensor
from ..nn.cnn_ops import _jnp_linspace
from ..nn.functional import rnnt_loss_op  # noqa: F401
from ._util import dt as _dt
from .registry import register_op

__all__ = [
    "tensor_split", "hsplit", "vsplit", "dsplit", "column_stack",
    "row_stack", "hstack", "vstack", "dstack", "unflatten", "take",
    "block_diag", "cartesian_prod", "combinations", "diagonal_scatter",
    "select_scatter", "slice_scatter", "sinc", "signbit", "isposinf",
    "isneginf", "isreal", "positive", "negative", "sgn", "float_power",
    "vander", "gammaln", "gammainc", "gammaincc", "multigammaln",
    "histogram_bin_edges", "histogramdd", "pdist", "cdist", "polar",
    "view_as_complex", "view_as_real", "cond", "matrix_exp", "addbmm",
    "baddbmm", "cholesky_inverse", "geqrf", "orgqr", "reverse",
    "mean_all", "numel", "shape_op", "fill", "fill_diagonal_tensor",
    "view_dtype", "accuracy_op", "auc_op", "rnnt_loss_op",
    "assign_value", "check_numerics", "full_batch_size_like",
    "index_select_strided", "trans_layout", "squared_l2_norm", "frexp",
]


# ---------------- manipulation ----------------
def tensor_split(x, num_or_indices, axis=0):
    """Uneven splits allowed (longtail.py:39): a Tensor's pieces are
    Tensors (views of it, so a gradient reaches it), a torch tensor's
    torch tensors."""
    arr = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    if isinstance(num_or_indices, int):
        pieces = torch.tensor_split(arr, num_or_indices, dim=axis)
    else:
        pieces = torch.tensor_split(arr, [int(i) for i in num_or_indices],
                                    dim=axis)
    if not isinstance(x, Tensor):
        return list(pieces)
    return [Tensor._wrap(p, stop_gradient=x.stop_gradient) for p in pieces]


def hsplit(x, num_or_indices):
    if x.ndim < 1:
        raise ValueError("hsplit expects ndim >= 1")
    return tensor_split(x, num_or_indices, axis=0 if x.ndim == 1 else 1)


def vsplit(x, num_or_indices):
    if x.ndim < 2:
        raise ValueError("vsplit expects ndim >= 2")
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices):
    if x.ndim < 3:
        raise ValueError("dsplit expects ndim >= 3")
    return tensor_split(x, num_or_indices, axis=2)


@register_op("column_stack")
def column_stack(x):
    return torch.column_stack(tuple(x))


@register_op("row_stack")
def row_stack(x):
    return torch.vstack(tuple(x))


@register_op("hstack")
def hstack(x):
    return torch.hstack(tuple(x))


@register_op("vstack")
def vstack(x):
    return torch.vstack(tuple(x))


@register_op("dstack")
def dstack(x):
    return torch.dstack(tuple(x))


@register_op("unflatten")
def unflatten(x, axis, shape):
    """`axis` expanded into `shape` (at most one -1)."""
    axis = axis % x.dim()
    shape = [int(s) for s in shape]
    if shape.count(-1) > 1:
        raise ValueError("unflatten shape may contain at most one -1")
    return x.reshape(list(x.shape[:axis]) + shape
                     + list(x.shape[axis + 1:]))


def _take_check(x, index, mode):
    """The reference's eager bounds check of mode "raise" (:124): two
    scalars read back, no copy of the index."""
    if mode != "raise" or index.numel() == 0:
        return
    n = x.numel()
    lo, hi = int(index.min()), int(index.max())
    if lo < -n or hi >= n:
        raise IndexError(
            f"take(mode='raise'): index out of range for input with "
            f"{n} elements (got range [{lo}, {hi}])")


@register_op("take")
def take(x, index, mode="raise"):
    """Flat-index gather with raise / wrap / clip; a negative index
    counts from the end except in "wrap"."""
    if not isinstance(index, torch.Tensor):
        index = torch.as_tensor(np.asarray(index), device=x.device)
    _take_check(x, index, mode)
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return flat[idx]


@register_op("block_diag")
def block_diag(inputs):
    return torch.block_diag(*[torch.atleast_2d(a) for a in inputs])


@register_op("cartesian_prod")
def cartesian_prod(x):
    grids = torch.meshgrid(*list(x), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


@register_op("combinations")
def combinations(x, r=2, with_replacement=False):
    n = x.shape[0]
    gen = (_it.combinations_with_replacement(range(n), r)
           if with_replacement else _it.combinations(range(n), r))
    idx = torch.as_tensor(np.array(list(gen), np.int64).reshape(-1, r),
                          device=x.device)
    return x[idx]


@register_op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    """y written onto a diagonal of x (a copy)."""
    axis1, axis2 = axis1 % x.dim(), axis2 % x.dim()
    xm = torch.movedim(x, (axis1, axis2), (-2, -1)).clone()
    n1, n2 = xm.shape[-2], xm.shape[-1]
    dev = x.device
    if offset >= 0:
        i = torch.arange(max(min(n1, n2 - offset), 0), device=dev)
        j = i + offset
    else:
        j = torch.arange(max(min(n1 + offset, n2), 0), device=dev)
        i = j - offset
    xm[..., i, j] = y.to(x.dtype)
    return torch.movedim(xm, (-2, -1), (axis1, axis2))


@register_op("select_scatter")
def select_scatter(x, values, axis, index):
    out = x.clone()
    idx = [slice(None)] * x.dim()
    idx[axis % x.dim()] = index
    out[tuple(idx)] = values.to(x.dtype) if isinstance(
        values, torch.Tensor) else values
    return out


@register_op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides):
    out = x.clone()
    idx = [slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[a % x.dim()] = slice(s, e, st)
    out[tuple(idx)] = value.to(x.dtype) if isinstance(
        value, torch.Tensor) else value
    return out


@register_op("reverse")
def reverse(x, axis):
    """The legacy reverse op (flip)."""
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, dims=tuple(axis))


# ---------------- math ----------------
@register_op("sinc")
def sinc(x):
    return torch.sinc(x)


@register_op("signbit")
def signbit(x):
    return torch.signbit(x)


@register_op("isposinf")
def isposinf(x):
    return torch.isposinf(x)


@register_op("isneginf")
def isneginf(x):
    return torch.isneginf(x)


@register_op("isreal")
def isreal(x):
    return torch.isreal(x)


@register_op("positive")
def positive(x):
    return +x


@register_op("negative")
def negative(x):
    return -x


@register_op("sgn")
def sgn(x):
    """Complex-aware sign: x / |x| (0 at 0), the sign of a real x."""
    if x.is_complex():
        mag = torch.abs(x)
        safe = torch.where(mag == 0, torch.ones_like(mag), mag)
        return torch.where(mag == 0, torch.zeros_like(x), x / safe)
    return torch.sign(x)


@register_op("float_power")
def float_power(x, y):
    """x ** y in the widest float the reference has (float32 without
    x64, complex64 for a complex operand)."""
    cplx = x.is_complex() or (isinstance(y, torch.Tensor) and y.is_complex())
    d = torch.complex64 if cplx else torch.float32
    yy = y.to(d) if isinstance(y, torch.Tensor) else y
    return torch.pow(x.to(d), yy)


@register_op("vander")
def vander(x, n=None, increasing=False):
    """Columns x^(n-1) .. x^0 (x^0 .. x^(n-1) when `increasing`), as
    powers (jnp.vander's rendering)."""
    n = x.shape[-1] if n is None else int(n)
    iota = torch.arange(n, device=x.device).to(x.dtype)
    if not increasing:
        iota = (n - 1) - iota
    return torch.pow(x[..., None], iota)


@register_op("gammaln", amp_policy="black")
def gammaln(x):
    return torch.lgamma(x)


class _IncGamma(torch.autograd.Function):
    """P(a, x) (`upper` False) or Q(a, x), regularized: torch's value and
    x-gradient, and the a-gradient (which torch does not give) by a
    central difference in float64."""

    @staticmethod
    def forward(ctx, a, x, upper):
        fn = torch.special.gammaincc if upper else torch.special.gammainc
        ctx.save_for_backward(a, x)
        ctx.fn = fn
        return fn(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        fn = ctx.fn
        ga = gx = None
        if ctx.needs_input_grad[0]:
            a64, x64 = a.double(), x.double()
            h = 1e-4 * torch.clamp_min(a64.abs(), 1.0)
            d = (fn(a64 + h, x64) - fn(a64 - h, x64)) / (2 * h)
            ga = (g * d.to(g.dtype)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            # dP/dx = x^(a-1) e^-x / Gamma(a); dQ/dx its negative
            dx = torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))
            gx = (g * (-dx if fn is torch.special.gammaincc
                       else dx)).sum_to_size(x.shape)
        return ga, gx, None


@register_op("gammainc", amp_policy="black")
def gammainc(x, y):
    """P(x, y), the regularized lower incomplete gamma function."""
    return _IncGamma.apply(x, y, False)


@register_op("gammaincc", amp_policy="black")
def gammaincc(x, y):
    return _IncGamma.apply(x, y, True)


@register_op("multigammaln", amp_policy="black")
def multigammaln(x, p):
    """log of the multivariate gamma function (jax.scipy's form: no
    domain check, so no read-back)."""
    j = torch.arange(p, dtype=x.dtype, device=x.device) / 2
    return torch.lgamma(x.unsqueeze(-1) - j).sum(-1) \
        + 0.25 * p * (p - 1) * math.log(math.pi)


def _bin_edges(x, bins, rng):
    """jnp.histogram_bin_edges: `bins` + 1 edges over `rng` (None: x's
    range), a zero-width range widened by 0.5 each side."""
    d = x.dtype if x.is_floating_point() else torch.float32
    if rng is None:
        lo, hi = x.min().to(d), x.max().to(d)
    else:
        lo = torch.as_tensor(rng[0], dtype=d, device=x.device)
        hi = torch.as_tensor(rng[1], dtype=d, device=x.device)
    flat = hi == lo
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    return _jnp_linspace(lo, hi, int(bins) + 1, x.device).to(d)


@register_op("histogram_bin_edges")
def histogram_bin_edges(x, bins=100, min=0, max=0):
    rng = None if (min == 0 and max == 0) else (min, max)
    return _bin_edges(x, bins, rng)


@register_op("histogramdd")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    """jnp.histogramdd over x [N, D]: (hist, *edges); a sample on the
    last edge falls in the last bin."""
    n, d = x.shape
    if isinstance(bins, int):
        bins = [bins] * d
    idx_by_dim, edges = [], []
    for i in range(d):
        b = _bin_edges(x[:, i], bins[i], None if ranges is None
                       else ranges[i])
        col = x[:, i].to(b.dtype).contiguous()
        bi = torch.searchsorted(b, col, right=True)
        bi = torch.where(col == b[-1], bi - 1, bi)
        idx_by_dim.append(bi)
        edges.append(b)
    nbins = [len(b) + 1 for b in edges]
    xy = torch.zeros_like(idx_by_dim[0])
    for bi, nb in zip(idx_by_dim, nbins):
        xy = xy * nb + torch.clamp(bi, 0, nb - 1)
    hd = weights.dtype if weights is not None else torch.int32
    hist = torch.zeros(int(np.prod(nbins)), dtype=hd, device=x.device)
    hist = hist.index_add(0, xy, weights if weights is not None
                          else torch.ones_like(xy, dtype=hd))
    hist = hist.reshape(nbins)[(slice(1, -1),) * d]
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for i, b in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(b).reshape(shape)
    return (hist, *edges)


def _minkowski(diff, p, axis):
    ad = torch.abs(diff)
    if p == 0:
        return torch.sum((ad != 0).to(diff.dtype), dim=axis)
    if p == float("inf"):
        return torch.amax(ad, dim=axis)
    if p == 1.0:
        return torch.sum(ad, dim=axis)
    if p == 2.0:
        return torch.sqrt(torch.sum(ad * ad, dim=axis))
    return torch.sum(ad ** p, dim=axis) ** (1.0 / p)


@register_op("pdist")
def pdist(x, p=2.0):
    """The condensed pairwise distance vector."""
    i, j = np.triu_indices(x.shape[0], k=1)
    i = torch.as_tensor(i, device=x.device)
    j = torch.as_tensor(j, device=x.device)
    return _minkowski(x[i] - x[j], p, axis=-1)


@register_op("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """[.., P, M] x [.., R, M] -> [.., P, R] p-norm distances; p=2 by
    ||a||^2 + ||b||^2 - 2ab unless the mode forbids the product."""
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        y2 = torch.sum(y * y, dim=-1, keepdim=True)
        xy = torch.matmul(x, y.transpose(-1, -2))
        sq = x2 - 2.0 * xy + y2.transpose(-1, -2)
        return torch.sqrt(torch.clamp_min(sq, 0.0))
    diff = x[..., :, None, :] - y[..., None, :, :]
    return _minkowski(diff, p, axis=-1)


# ---------------- complex ----------------
@register_op("polar")
def polar(abs, angle):
    out = torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))
    return out.to(torch.complex64 if abs.dtype == torch.float32
                  else torch.complex128)


def view_as_complex(x):
    from . import as_complex
    return as_complex(x)


def view_as_real(x):
    from . import as_real
    return as_real(x)


# ---------------- linalg ----------------
@register_op("linalg_cond", amp_policy="black")
def cond(x, p=None):
    """The condition number (2-norm by default)."""
    if p is None or p == 2 or p == -2:
        s = torch.linalg.svdvals(x)
        if p == -2:
            return s[..., -1] / s[..., 0]
        return s[..., 0] / s[..., -1]
    if p in ("fro", "nuc", 1, -1, np.inf, -np.inf, float("inf")):
        return (torch.linalg.matrix_norm(x, ord=p)
                * torch.linalg.matrix_norm(torch.linalg.inv(x), ord=p))
    raise ValueError(f"unsupported p for cond: {p!r}")


@register_op("matrix_exp", amp_policy="black")
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


@register_op("addbmm")
def addbmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.sum(torch.matmul(x, y), dim=0)


@register_op("baddbmm")
def baddbmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@register_op("cholesky_inverse", amp_policy="black")
def cholesky_inverse(x, upper=False):
    """The inverse of A from its Cholesky factor, by two triangular
    solves against I."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    w = torch.linalg.solve_triangular(x, eye, upper=upper)
    if upper:       # A = U^T U, A^-1 = U^-1 U^-T
        return torch.matmul(w, w.transpose(-1, -2))
    return torch.matmul(w.transpose(-1, -2), w)


@register_op("geqrf", amp_policy="black")
def geqrf(x):
    """The raw Householder QR factors (a, tau)."""
    a, tau = torch.geqrf(x)
    return a, tau


def orgqr(x, tau):
    """Alias of householder_product."""
    from . import householder_product
    return householder_product(x, tau)


# ---------------- misc YAML ops ----------------
@register_op("mean_all")
def mean_all(x):
    """The legacy mean op: the mean over every element."""
    return torch.mean(x)


@register_op("numel")
def numel(x):
    """The element count as a 0-d int32 tensor."""
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@register_op("shape_op")
def shape_op(x):
    """The shape as an int32 vector."""
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@register_op("fill")
def fill(x, value):
    """A tensor of x's shape and dtype filled with `value` (functional:
    eager in-place callers rebind)."""
    return torch.full(x.shape, value, dtype=x.dtype, device=x.device)


@register_op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    """y written onto the (dim1, dim2) diagonal of x."""
    return diagonal_scatter.raw_fn(x, y, offset=offset, axis1=dim1,
                                   axis2=dim2)


def view_dtype(x, dtype):
    """x's bytes reinterpreted as `dtype`."""
    arr = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    return Tensor._wrap(arr.view(_dt(dtype)))


@register_op("accuracy_op")
def accuracy_op(x, label, k=1):
    """Top-k accuracy of scores x [N, C] against labels [N] or [N, 1]."""
    lbl = label.reshape(-1).long()
    kk = int(min(k, x.shape[-1]))
    topk = torch.topk(x, kk, dim=-1).indices
    hit = torch.any(topk == lbl[:, None], dim=-1)
    return torch.mean(hit.to(torch.float32))


@register_op("auc_op")
def auc_op(predict, label):
    """Binary ROC-AUC by the rank statistic, midranks for ties (a tied
    positive/negative pair scores 0.5)."""
    score = (predict[..., -1] if predict.dim() > 1
             else predict).reshape(-1).contiguous()
    y = label.reshape(-1).to(torch.float32)
    srt = torch.sort(score).values
    lo = torch.searchsorted(srt, score, right=False).to(torch.float32)
    hi = torch.searchsorted(srt, score, right=True).to(torch.float32)
    ranks = (lo + hi + 1.0) / 2.0
    npos = torch.sum(y)
    nneg = y.shape[0] - npos
    u = torch.sum(ranks * y) - npos * (npos + 1) / 2.0
    none = npos * nneg == 0
    denom = torch.where(none, torch.ones_like(npos), npos * nneg)
    return torch.where(none, torch.full_like(u, 0.5), u / denom)


@register_op("assign_value")
def assign_value(shape, dtype, values):
    """A constant tensor on the default place."""
    from ..core.device import default_torch_device
    return torch.as_tensor(np.array(values).reshape(shape),
                           device=default_torch_device()).to(_dt(dtype))


@register_op("check_numerics", cacheable=False)
def check_numerics(x, message=""):
    """Raises on a NaN or an Inf in x (one scalar read back), else
    returns x."""
    if (x.is_floating_point() or x.is_complex()) and not bool(
            torch.isfinite(x).all()):
        raise FloatingPointError(
            f"check_numerics: NaN or Inf found. {message}")
    return x


@register_op("full_batch_size_like")
def full_batch_size_like(input, shape, value, input_dim_idx=0,
                         output_dim_idx=0, dtype=None):
    """`shape` filled with `value`, its batch dim taken from input."""
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    d = _dt(dtype) if dtype is not None else input.dtype
    return torch.full(shape, value, dtype=d, device=input.device)


@register_op("index_select_strided")
def index_select_strided(x, index, axis=0):
    """index_select (buffers are dense here too)."""
    return torch.index_select(x, axis, index.long())


@register_op("trans_layout")
def trans_layout(x, perm):
    return x.permute(list(perm))


@register_op("squared_l2_norm")
def squared_l2_norm(x):
    """sum(x^2) in float32 as a [1] tensor of x's dtype."""
    return torch.sum(torch.square(x.to(torch.float32))).reshape(1).to(
        x.dtype)


@register_op("frexp")
def frexp(x):
    """(mantissa in [0.5, 1), int32 exponent), 0 giving (0, 0): the
    reference's formula (float32, scaled by exp2 in two halves)."""
    xf = x.to(torch.float32)
    zero = xf == 0
    e = torch.where(zero, torch.zeros_like(xf), torch.floor(torch.log2(
        torch.abs(torch.where(zero, torch.ones_like(xf), xf)))) + 1)
    e1 = torch.trunc(e / 2)
    e2 = e - e1
    m = torch.where(zero, torch.zeros_like(xf),
                    xf * torch.exp2(-e1) * torch.exp2(-e2))
    fix = torch.abs(m) >= 1.0
    m = torch.where(fix, m / 2, m)
    e = torch.where(fix, e + 1, e)
    fix2 = (torch.abs(m) < 0.5) & (m != 0)
    m = torch.where(fix2, m * 2, m)
    e = torch.where(fix2, e - 1, e)
    return m.to(x.dtype), e.to(torch.int32)
