"""paddle_tpu_torch.sparse: COO and CSR sparse tensors (counterpart of
paddle_tpu/sparse/__init__.py).

``SparseCooTensor`` holds indices [sparse_dim, nnz] (int64 inside,
int32 from ``indices()`` as the reference gives them), values [nnz,
*dense dims] and a shape; ``SparseCsrTensor`` crows, cols and values,
a batched CSR ([B, S, S]) with per-batch rows, as the reference keeps
them. Made from a dense tensor, the stored entries are its nonzero sites
in row-major order (``torch.nonzero``, the order of the reference's
``BCOO.fromdense``), zeros dropped; a hybrid COO (``sparse_dim`` below
the rank) keeps a site where any of its trailing values is nonzero.

``matmul`` / ``mv`` are sparse times dense, giving dense
(``torch.sparse.mm`` for a 2-D sparse operand, else a dense product);
``masked_matmul`` samples a dense product at the mask's entries;
``addmm`` follows. The elementwise ops, ``transpose`` and ``reshape``
densify and sparsify again in the input's format, as the reference does.
Values keep their autograd history: ``to_dense()`` of a result of the
sparse nn layers is the recorded dense tensor it was made from, and of
any other the values scattered into zeros (recorded), so gradients flow
through stacked sparse layers. The creation functions put their results
on ``place`` (None: the values' device, else the eager default place,
the card unless ``set_device("cpu")``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import _parse, default_torch_device
from ..core.tensor import Tensor

__all__ = [
    "sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
    "SparseCsrTensor", "matmul", "masked_matmul", "mv", "addmm", "add",
    "subtract", "multiply", "divide", "is_same_shape", "transpose",
    "reshape", "coalesce",
]


def _torch(x, device=None):
    """x as a torch tensor (a Tensor's own; an array on `device`, else
    the default place)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x), device=device or
                        default_torch_device())
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _scatter_dense(shape, index, values):
    """Zeros of `shape` with `values` added at `index` (a tuple of index
    tensors; duplicates add up, as a BCOO's todense sums them)."""
    out = values.new_zeros(tuple(shape))
    return out.index_put(index, values, accumulate=True)


class SparseCooTensor:
    """indices [sparse_dim, nnz] and values [nnz, *dense dims]."""

    def __init__(self, indices, values, shape):
        self._idx = indices.long()
        self._vals = values
        self._shape = tuple(int(s) for s in shape)
        self._dense = None        # the recorded dense tensor, if any
        self._mm = None           # the coalesced torch COO of matmul

    # ---- the Tensor surface ----
    def is_sparse(self):
        return True

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._vals.dtype

    def nnz(self):
        return int(self._idx.shape[1])

    def indices(self):
        return Tensor._wrap(self._idx.to(torch.int32))

    def values(self):
        return Tensor._wrap(self._vals)

    def _todense(self):
        if self._dense is not None:
            return self._dense
        return _scatter_dense(self._shape, tuple(self._idx), self._vals)

    def to_dense(self):
        return Tensor._wrap(self._todense())

    def to_sparse_csr(self):
        return _dense_to_csr(self._todense())

    def coalesce(self):
        c = torch.sparse_coo_tensor(self._idx, self._vals, self._shape,
                                    check_invariants=False).coalesce()
        return SparseCooTensor(c.indices(), c.values(), self._shape)

    def numpy(self):
        return self.to_dense().numpy()

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={dtypes._name(self.dtype)})")

    # elementwise on the stored values only (zeros stay zeros), as the
    # reference's unary family
    def _map_values(self, fn):
        return SparseCooTensor(self._idx, fn(self._vals), self._shape)

    def abs(self):
        return self._map_values(torch.abs)

    def sin(self):
        return self._map_values(torch.sin)

    def tanh(self):
        return self._map_values(torch.tanh)

    def sqrt(self):
        return self._map_values(torch.sqrt)

    def square(self):
        return self._map_values(torch.square)

    def neg(self):
        return self._map_values(torch.neg)

    def astype(self, dtype):
        d = dtypes.to_dtype(dtype)
        return self._map_values(lambda v: v.to(d))

    def relu(self):
        return self._map_values(torch.relu)


class SparseCsrTensor:
    """crows, cols and values; a batched CSR keeps them per batch
    ([B, S + 1], [B, nnz], [B, nnz])."""

    def __init__(self, crows, cols, values, shape):
        self._crows = crows.long()
        self._cols = cols.long()
        self._vals = values
        self._shape = tuple(int(s) for s in shape)

    def is_sparse(self):
        return True

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._vals.dtype

    def nnz(self):
        return int(self._cols.shape[-1])

    def crows(self):
        return Tensor._wrap(self._crows.to(torch.int32))

    def cols(self):
        return Tensor._wrap(self._cols.to(torch.int32))

    def values(self):
        return Tensor._wrap(self._vals)

    def _entries(self):
        """(index tuple into the dense shape, values) of the stored
        entries; a batch's entries past its row count are padding."""
        crows, cols, vals = self._crows, self._cols, self._vals
        if len(self._shape) == 2:
            s = self._shape[0]
            rows = torch.repeat_interleave(
                torch.arange(s, device=crows.device), torch.diff(crows))
            return (rows, cols[:rows.shape[0]]), vals[:rows.shape[0]]
        b, s = self._shape[0], self._shape[1]
        counts = torch.diff(crows, dim=-1)                    # [B, S]
        live = (torch.arange(cols.shape[-1], device=cols.device)[None, :]
                < crows[:, -1:])                              # [B, nnz]
        bidx = torch.repeat_interleave(
            torch.arange(b, device=cols.device), crows[:, -1])
        rows = torch.repeat_interleave(
            torch.arange(s, device=cols.device).repeat(b), counts.reshape(-1))
        return (bidx, rows, cols[live]), vals[live]

    def _todense(self):
        index, vals = self._entries()
        return _scatter_dense(self._shape, index, vals)

    def to_dense(self):
        return Tensor._wrap(self._todense())

    def to_sparse_coo(self, sparse_dim=None):
        return _dense_to_coo(self._todense())

    def numpy(self):
        return self.to_dense().numpy()

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={dtypes._name(self.dtype)})")


def _dense_to_coo(dense, sparse_dim=None) -> SparseCooTensor:
    """The nonzero sites of `dense` (a torch tensor) in row-major order;
    with sparse_dim below the rank a site is kept when any of its
    trailing values is nonzero (a hybrid COO)."""
    nd = dense.dim()
    sd = nd if sparse_dim is None else int(sparse_dim)
    nz = dense != 0
    if sd < nd:
        nz = nz.flatten(sd).any(-1)
    idx = torch.nonzero(nz).t()
    return SparseCooTensor(idx, dense[tuple(idx)], dense.shape)


def _dense_to_csr(dense) -> SparseCsrTensor:
    if dense.dim() != 2:
        raise ValueError("bcsr_fromdense: must have 2 sparse dimensions.")
    nz = torch.nonzero(dense != 0)
    rows, cols = nz[:, 0], nz[:, 1]
    counts = torch.bincount(rows, minlength=dense.shape[0])
    crows = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SparseCsrTensor(crows, cols, dense[rows, cols], dense.shape)


def _values(values, dtype, device):
    v = _torch(values, device)
    if device is not None:
        v = v.to(device)
    if dtype is not None:
        v = v.to(dtypes.to_dtype(dtype))
    return v


def _place(place):
    return None if place is None else _parse(place).torch_device()


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True) -> SparseCooTensor:
    """A COO tensor of indices [sparse_dim, nnz] and values [nnz, ...],
    kept as given (duplicates too; ``coalesce`` sums them). Without a
    shape, each sparse dim is its largest index + 1. `stop_gradient` is
    taken and not used, as in the reference: the values keep their own."""
    dev = _place(place)
    vals = _values(values, dtype, dev)
    idx = _torch(indices, vals.device).to(vals.device).long()
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.max(dim=1).values.tolist())
        shape = shape + tuple(vals.shape[1:])
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      place=None, stop_gradient=True) -> SparseCsrTensor:
    """A CSR tensor; a batched one ([B, S, S]) takes Paddle's flat crows
    [B * (S + 1)] and cols [B * nnz]."""
    dev = _place(place)
    vals = _values(values, dtype, dev)
    crows = _torch(crows, vals.device).to(vals.device).long()
    cols = _torch(cols, vals.device).to(vals.device).long()
    if len(shape) == 3 and crows.dim() == 1:
        b, s = int(shape[0]), int(shape[1])
        crows = crows.reshape(b, s + 1)
        cols = cols.reshape(b, -1)
        vals = vals.reshape((b, -1) + tuple(vals.shape[1:])) \
            if vals.dim() > 1 else vals.reshape(b, -1)
    return SparseCsrTensor(crows, cols, vals, shape)


def _sp(x):
    if isinstance(x, (SparseCooTensor, SparseCsrTensor)):
        return x
    raise TypeError(f"expected a sparse tensor, got {type(x)}")


def _as_coo(sx) -> SparseCooTensor:
    """A COO view of either format (a CSR through dense, as the
    reference goes)."""
    if isinstance(sx, SparseCooTensor):
        return sx
    return _dense_to_coo(sx._todense())


def _torch_coo(sx: SparseCooTensor):
    """The coalesced torch COO of a 2-D COO tensor, made once."""
    if sx._mm is None:
        sx._mm = torch.sparse_coo_tensor(sx._idx, sx._vals, sx._shape,
                                         check_invariants=False).coalesce()
    return sx._mm


def matmul(x, y, name=None):
    """sparse @ dense -> dense Tensor."""
    sx = _sp(x)
    yd = _torch(y, sx._vals.device)
    if isinstance(sx, SparseCsrTensor):
        sx = _as_coo(sx) if len(sx._shape) == 2 else sx
    if isinstance(sx, SparseCooTensor) and len(sx._shape) == 2 \
            and sx._idx.shape[0] == 2:
        sp = _torch_coo(sx)
        if yd.dim() == 1:
            return Tensor._wrap(torch.sparse.mm(sp, yd[:, None])[:, 0])
        return Tensor._wrap(torch.sparse.mm(sp, yd))
    return Tensor._wrap(torch.matmul(sx._todense(), yd))


def mv(x, vec, name=None):
    return matmul(x, vec, name=name)


def masked_matmul(x, y, mask, name=None):
    """dense @ dense, sampled at the mask's entries (SDDMM): a COO with
    the mask's indices."""
    m = _as_coo(_sp(mask))
    dense = torch.matmul(_torch(x, m._vals.device), _torch(y, m._vals.device))
    rows, cols = m._idx[0], m._idx[1]
    return SparseCooTensor(m._idx, dense[rows, cols], m._shape)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y), x sparse."""
    prod = matmul(x, y)._data
    return Tensor._wrap(beta * _torch(input, prod.device) + alpha * prod)


def _like_input(x, dense):
    """Sparsified again in the input's format."""
    return _dense_to_csr(dense) if isinstance(x, SparseCsrTensor) \
        else _dense_to_coo(dense)


def _ewise(x, y, fn):
    sx, sy = _sp(x), _sp(y)
    if sx.shape != sy.shape:
        raise ValueError("shapes must match")
    return _like_input(sx, fn(sx._todense(), sy._todense()))


def add(x, y, name=None):
    return _ewise(x, y, torch.add)


def subtract(x, y, name=None):
    return _ewise(x, y, torch.subtract)


def multiply(x, y, name=None):
    return _ewise(x, y, torch.multiply)


def divide(x, y, name=None):
    return _ewise(x, y, torch.divide)


def is_same_shape(x, y):
    return list(x.shape) == list(y.shape)


def transpose(x, perm, name=None):
    sx = _sp(x)
    return _like_input(sx, sx._todense().permute(*perm))


def reshape(x, shape, name=None):
    sx = _sp(x)
    return _like_input(sx, sx._todense().reshape(tuple(shape)))


def coalesce(x, name=None):
    return _sp(x).coalesce()


from . import nn  # noqa: E402,F401  (after the classes nn imports)
