"""paddle.sparse.nn.functional (counterpart of
paddle_tpu/sparse/nn/functional.py): the convolutions, max_pool3d and
attention computed dense, as the reference computes them, with each
op's site rule at the sparse boundary:
- a submanifold convolution (``subm_*``) keeps the input's sites and
  forces a pad of k // 2 and stride 1, so the output shape is the
  input's;
- a regular convolution's active sites are those a convolution of ones
  over the input's site mask reaches;
- a site is active where any of its channels is nonzero;
- a pooled site is active where any site of its window is (an OR).
The dense convolution is the port's ``conv3d`` / ``conv2d`` op (cuDNN on
the card, NDHWC / NHWC), so the weights and a stack of sparse layers
train through torch.autograd; ReLU and max_pool3d keep the tape too
(the reference's cut it, ROADMAP Queue C). ``attention`` masks a dense
softmax(QK^T / sqrt(d))V by the CSR layout, which it expands on the
device."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor

__all__ = ["conv3d", "subm_conv3d", "conv2d", "subm_conv2d", "max_pool3d",
           "relu", "attention"]


def _coo(x):
    from .. import SparseCooTensor
    if not isinstance(x, SparseCooTensor):
        raise TypeError(f"expected SparseCooTensor, got {type(x).__name__}")
    return x


def _resparsify(dense, site_mask):
    """dense [N, *spatial, C] and a bool site mask [N, *spatial] -> a
    COO of sparse_dim 1 + len(spatial) and dense channels, keeping the
    recorded dense tensor for to_dense()."""
    from .. import SparseCooTensor
    idx = torch.nonzero(site_mask).t()
    out = SparseCooTensor(idx, dense[tuple(idx)], dense.shape)
    out._dense = dense
    return out


def _site_mask(dense):
    return (dense != 0).any(-1)


def _norm(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)[:nd]


def _pads(padding, nd):
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    if isinstance(padding, (list, tuple)) and padding and \
            isinstance(padding[0], int):
        return [(p, p) for p in padding]
    return [tuple(p) for p in padding]


def _raw(t):
    return t._data if isinstance(t, Tensor) else t


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             subm=False):
    from ...nn import cnn_ops
    dense = _coo(x)._todense()                       # [N, *spatial, C]
    w = _raw(weight)
    b = _raw(bias)
    if subm:
        pads = [(k // 2, (k - 1) - k // 2) for k in w.shape[:nd]]
        st = (1,) * nd
    else:
        st = _norm(stride, nd)
        pads = _pads(padding, nd)
    dl = _norm(dilation, nd)
    # the sparse weight's [k..., in / groups, out] as the dense op's
    # [out, in / groups, k...]
    w_dense = w.permute(*((nd + 1, nd) + tuple(range(nd))))
    conv = cnn_ops.conv3d if nd == 3 else cnn_ops.conv2d
    fmt = "NDHWC" if nd == 3 else "NHWC"
    out = conv(dense, w_dense, b, stride=list(st), padding=pads,
               dilation=list(dl), groups=groups, data_format=fmt)
    with torch.no_grad():
        mask = _site_mask(dense)
        if not subm:
            # a site is active when an active input site falls in its
            # receptive field
            act = mask.to(torch.float32).unsqueeze(1)
            ones = act.new_ones((1, 1) + tuple(w.shape[:nd]))
            reach = cnn_ops._conv(act, ones, None, st, pads, dl, 1,
                                  "NCDHW" if nd == 3 else "NCHW")
            mask = reach[:, 0] > 0
    masked = out * mask.unsqueeze(-1).to(out.dtype)
    return _resparsify(masked, mask)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NDHWC", name=None):
    """x [N, D, H, W, C] COO, weight [kd, kh, kw, C / groups, M]."""
    if data_format != "NDHWC":
        raise ValueError("sparse conv3d supports NDHWC only (ref parity)")
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3)


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", key=None, name=None):
    """Submanifold: the output's sites are the input's."""
    if data_format != "NDHWC":
        raise ValueError("sparse subm_conv3d supports NDHWC only")
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    subm=True)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NHWC", name=None):
    if data_format != "NHWC":
        raise ValueError("sparse conv2d supports NHWC only")
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2)


def subm_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NHWC", key=None, name=None):
    if data_format != "NHWC":
        raise ValueError("sparse subm_conv2d supports NHWC only")
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    subm=True)


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format="NDHWC", name=None):
    """The max over the active sites of each window; a window with no
    active site gives an inactive site."""
    if data_format != "NDHWC":
        raise ValueError("sparse max_pool3d supports NDHWC only")
    dense = _coo(x)._todense()
    mask = _site_mask(dense)
    ks = _norm(kernel_size, 3)
    st = _norm(stride if stride is not None else kernel_size, 3)
    pads = [v for lo, hi in reversed(_pads(padding, 3)) for v in (lo, hi)]
    neg = torch.tensor(-math.inf, dtype=dense.dtype, device=dense.device)
    masked = torch.where(mask.unsqueeze(-1), dense, neg).movedim(-1, 1)
    out = TF.max_pool3d(TF.pad(masked, pads, value=-math.inf), ks, st)
    with torch.no_grad():
        m = TF.pad(mask.to(torch.float32).unsqueeze(1), pads)
        out_mask = TF.max_pool3d(m, ks, st)[:, 0] > 0
    out = torch.where(out_mask.unsqueeze(-1), out.movedim(1, -1),
                      torch.zeros((), dtype=dense.dtype,
                                  device=dense.device))
    return _resparsify(out, out_mask)


def relu(x, name=None):
    return _coo(x).relu()


def _csr_allow(mask, bh, s):
    """The CSR layout of `mask` ([bh, s, s]) as a dense bool [bh, s, s]."""
    crows = mask._crows.reshape(bh, s + 1)
    cols = mask._cols.reshape(bh, -1)
    dev = cols.device
    counts = torch.diff(crows, dim=-1)
    live = torch.arange(cols.shape[-1], device=dev)[None, :] < crows[:, -1:]
    b_idx = torch.repeat_interleave(torch.arange(bh, device=dev),
                                    crows[:, -1])
    rows = torch.repeat_interleave(torch.arange(s, device=dev).repeat(bh),
                                   counts.reshape(-1))
    allow = torch.zeros((bh, s, s), dtype=torch.bool, device=dev)
    allow[b_idx, rows, cols[live]] = True
    return allow


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """softmax(QK^T / sqrt(d))V with the scores restricted to
    sparse_mask's CSR layout ([batch * heads, seq, seq]); a row with no
    allowed score gives zeros."""
    from .. import SparseCsrTensor
    q, k, v = _raw(query), _raw(key), _raw(value)
    b, h, s, d = q.shape
    if not isinstance(sparse_mask, SparseCsrTensor):
        raise TypeError("sparse_mask must be a SparseCsrTensor")
    allow = _csr_allow(sparse_mask, b * h, s).reshape(b, h, s, s)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=scores.device)
    scores = torch.where(allow, scores, neg)
    if attn_mask is not None:
        scores = scores + _raw(attn_mask).to(scores.dtype)
    if key_padding_mask is not None:
        scores = scores + _raw(key_padding_mask)[:, None, None, :].to(
            scores.dtype)
    any_valid = scores.amax(-1, keepdim=True) > neg / 2
    p = torch.softmax(scores, dim=-1)
    p = torch.where(any_valid, p, torch.zeros_like(p)).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return Tensor._wrap(out) if isinstance(query, Tensor) else out
