"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py).

``matmul`` is the nn functional's (``nn/functional.py``): mixed inputs
promote, bf16/f16 products accumulate in f32 and round once, as the
reference computes them (:22-31). The decompositions and solvers are
torch.linalg's; those whose CUDA kernel the card lacks for a dtype run
as torch runs them. ``lu`` returns 1-based pivots as the reference's
does."""
from __future__ import annotations

import torch

from ..nn.functional import matmul
from ._util import floatlike, pair, promote, promote_all
from .registry import register_op

__all__ = ["matmul", "mm", "bmm", "dot", "inner", "outer", "addmm", "mv",
           "t", "cross", "norm", "vector_norm", "matrix_norm", "dist",
           "histogram", "bincount", "matrix_power", "cholesky",
           "cholesky_solve", "inverse", "pinv", "solve", "triangular_solve",
           "lstsq", "qr", "svd", "svdvals", "eig", "eigh", "eigvals",
           "eigvalsh", "det", "slogdet", "matrix_rank", "lu", "corrcoef",
           "cov", "kron", "multi_dot", "trace", "diagonal", "diag_embed",
           "householder_product", "einsum", "p_norm", "lu_unpack",
           "spectral_norm"]


@register_op("mm", amp_policy="white")
def mm(x, y):
    x, y = promote(x, y)
    return torch.matmul(x, y)


@register_op("bmm", amp_policy="white")
def bmm(x, y):
    x, y = promote(x, y)
    return torch.matmul(x, y)


@register_op("dot")
def dot(x, y):
    x, y = promote(x, y)
    return torch.sum(x * y, dim=-1)


@register_op("inner")
def inner(x, y):
    x, y = pair(x, y)
    return torch.inner(x, y)


@register_op("outer")
def outer(x, y):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op("addmm", amp_policy="white")
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(*promote(x, y))


@register_op("mv")
def mv(x, vec):
    return torch.matmul(*promote(x, vec))


@register_op("t")
def t(x):
    """x.T: every axis reversed (rank 0 and 1 unchanged)."""
    return x.permute(*range(x.dim() - 1, -1, -1)) if x.dim() >= 2 else x


@register_op("cross")
def cross(x, y, axis=9):
    x, y = promote(x, y)
    if axis == 9:
        return torch.linalg.cross(x, y, dim=-1)
    return torch.linalg.cross(x, y, dim=axis)


def _axis(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@register_op("norm")
def norm(x, p=None, axis=None, keepdim=False):
    x = floatlike(x)
    if isinstance(axis, (list, tuple)) and not axis:
        # jnp.linalg.norm refuses an empty axis list, as the reference
        raise ValueError(
            "Improper number of axes for norm: axis=(). Pass one axis to "
            "compute a vector-norm, or two axes to compute a matrix-norm.")
    if p is None or p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        ax = _axis(axis)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(x, "fro", dim=ax,
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(x, 2, dim=ax, keepdim=keepdim)
    if p in ("inf", float("inf")):
        p = float("inf")
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    ax = _axis(axis)
    if isinstance(ax, tuple) and len(ax) == 2:
        return torch.linalg.matrix_norm(x, p, dim=ax, keepdim=keepdim)
    return torch.linalg.vector_norm(x, p, dim=ax, keepdim=keepdim)


@register_op("vector_norm")
def vector_norm(x, p=2.0, axis=None, keepdim=False):
    return torch.linalg.vector_norm(floatlike(x), p, dim=_axis(axis),
                                    keepdim=keepdim)


@register_op("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(floatlike(x), p, keepdim=keepdim)


@register_op("dist")
def dist(x, y, p=2.0):
    x, y = promote(x, y)
    return torch.linalg.vector_norm((x - y).reshape(-1), p)


@register_op("histogram")
def histogram(input, bins=100, min=0, max=0, weight=None):
    x = input.reshape(-1).float()
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    if weight is None:
        return torch.histc(x, bins=int(bins), min=lo, max=hi)
    edges = torch.linspace(lo, hi, int(bins) + 1, device=x.device)
    idx = torch.clamp(torch.bucketize(x, edges, right=True) - 1, 0,
                      int(bins) - 1)
    keep = (x >= lo) & (x <= hi)
    w = torch.where(keep, weight.reshape(-1).float(), 0.0)
    return torch.zeros(int(bins), device=x.device).index_add(0, idx, w)


@register_op("bincount")
def bincount(x, weights=None, minlength=0):
    """Integer weights keep their dtype, as jnp.bincount keeps it
    (torch.bincount returns a float for any weights)."""
    if weights is not None and not (weights.is_floating_point()
                                    or weights.is_complex()):
        xl = x.reshape(-1).long()
        n = max(int(minlength), int(xl.max()) + 1 if xl.numel() else 0)
        return torch.zeros(n, dtype=weights.dtype, device=x.device) \
            .scatter_add_(0, xl, weights.reshape(-1))
    return torch.bincount(x.long(), weights=weights, minlength=minlength)


@register_op("matrix_power")
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


# --- decompositions / solvers ---
@register_op("cholesky")
def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


@register_op("cholesky_solve")
def cholesky_solve(x, y, upper=False):
    """Solve A z = x for A = L L^T given its factor y, by two triangular
    solves as the reference does (the gradient reaches only the factor's
    triangle)."""
    low = y.transpose(-1, -2) if upper else y
    z = torch.linalg.solve_triangular(low, x, upper=False)
    return torch.linalg.solve_triangular(low.transpose(-1, -2), z,
                                         upper=True)


@register_op("inverse")
def inverse(x):
    return torch.linalg.inv(x)


@register_op("pinv")
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@register_op("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


@register_op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != transpose, unitriangular=unitriangular)


@register_op("lstsq")
def lstsq(x, y, rcond=None):
    drv = "gelsd" if x.device.type == "cpu" else "gels"
    r = torch.linalg.lstsq(x, y, rcond=rcond, driver=drv)
    # the residuals of every system, as jnp returns them (torch, as
    # numpy, returns none for an under-determined or rank-deficient one)
    resid = (y - torch.matmul(x, r.solution)).square().sum(-2 if y.dim()
                                                         > 1 else -1)
    return r.solution, resid, r.rank, r.singular_values


@register_op("qr")
def qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r")[1]
    return tuple(torch.linalg.qr(x, mode=mode))


@register_op("svd")
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@register_op("svdvals")
def svdvals(x):
    return torch.linalg.svdvals(x)


@register_op("eig")
def eig(x):
    return tuple(torch.linalg.eig(x))


@register_op("eigh")
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@register_op("eigvals")
def eigvals(x):
    return torch.linalg.eigvals(x)


@register_op("eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register_op("det")
def det(x):
    return torch.linalg.det(x)


@register_op("slogdet")
def slogdet(x):
    s, logabs = torch.linalg.slogdet(x)
    return s, logabs


@register_op("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


@register_op("lu")
def lu(x, pivot=True):
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_, piv


@register_op("corrcoef")
def corrcoef(x, rowvar=True):
    return torch.corrcoef(floatlike(x) if rowvar else floatlike(x).T)


@register_op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = floatlike(x) if rowvar else floatlike(x).T
    return torch.cov(x, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@register_op("kron")
def kron(x, y):
    return torch.kron(*pair(x, y))


@register_op("multi_dot")
def multi_dot(x):
    return torch.linalg.multi_dot(list(x))


@register_op("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.sum(torch.diagonal(x, offset, axis1, axis2), dim=-1)


@register_op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@register_op("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@register_op("householder_product")
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@register_op("einsum_op")
def _einsum(equation, operands):
    return torch.einsum(equation, *promote_all(list(operands)))


def einsum(equation, *operands):
    return _einsum(equation, list(operands))


@register_op("p_norm")
def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
           asvector=False):
    """The porder-norm along `axis` in f32, cast back to x's dtype
    (ref: phi/kernels/gpu/p_norm_kernel.cu)."""
    if asvector:
        x = x.reshape(-1)
        axis = 0
    xf = x.float()
    if porder == float("inf"):
        out = torch.amax(torch.abs(xf), dim=axis, keepdim=keepdim)
    elif porder == float("-inf"):
        out = torch.amin(torch.abs(xf), dim=axis, keepdim=keepdim)
    elif porder == 0:
        out = torch.sum((xf != 0).float(), dim=axis, keepdim=keepdim)
    else:
        out = torch.sum(torch.abs(xf) ** porder, dim=axis,
                        keepdim=keepdim) ** (1.0 / porder)
    return out.to(x.dtype)


@register_op("lu_unpack")
def lu_unpack(x, pivots, unpack_ludata=True, unpack_pivots=True):
    """lu()'s compact output as (P, L, U), pivots 1-based."""
    P, L, U = torch.lu_unpack(x, pivots.to(torch.int32))
    return P, L, U


@register_op("spectral_norm")
def spectral_norm(weight, u=None, v=None, dim=0, power_iters=1, eps=1e-12):
    """Power-iteration spectral normalization (ref:
    phi/kernels/impl/spectral_norm_kernel_impl.h)."""
    w = torch.movedim(weight, dim, 0)
    mat = w.reshape(w.shape[0], -1).float()
    h, wdim = mat.shape
    u = (torch.ones(h, device=mat.device) / h ** 0.5 if u is None
         else u.float().reshape(h))
    v = (torch.ones(wdim, device=mat.device) / wdim ** 0.5 if v is None
         else v.float().reshape(wdim))
    for _ in range(power_iters if power_iters > 1 else 1):
        v = mat.T @ u
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
        u = mat @ v
        u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
    sigma = u @ mat @ v
    out = (mat / torch.clamp_min(sigma, eps)).reshape(w.shape)
    return torch.movedim(out, 0, dim).to(weight.dtype)
