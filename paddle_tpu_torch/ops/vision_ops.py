"""The vision and detection ops (counterpart of
paddle_tpu/ops/vision_ops.py): depthwise and deformable convolution,
the max pools with indices and unpool3d, RoI max and position-sensitive
pooling, prior boxes, YOLO box decoding, matrix and multiclass NMS,
RPN proposals and FPN level assignment.

Contracts are the reference's: static-shape outputs padded with -1 (or
0) and per-image counts where the CUDA kernels it replaces return
ragged results, and the same tie rules. Its ``lax.top_k`` keeps equal
values in index order; ``_top_k`` (a stable descending sort) does the
same on both devices.

Where the reference's rendering would not fit a card's memory at COCO
widths, the port computes the same values another way:

- ``roi_pool`` takes each bin's maximum from a 2-D sparse table of the
  map (the maximum of the four power-of-two blocks that cover the bin)
  instead of masking the whole map once per bin: the same maximum,
  exactly, in O(C H W log H log W) to build and 4 reads an output;
- ``psroi_pool`` sums each bin from a float64 integral image (4 reads
  an output) instead of an einsum over the whole map per RoI; the sums
  round once to the input's type;
- the greedy NMS (``_greedy_nms_keep``) builds the IoU matrix of the
  candidates once and walks it in the reference's order, one row a step
  for every image and class at once, on the device and with no
  read-back (the reference's ``fori_loop`` computes one IoU row a step).

``fold``, ``unpool`` and ``conv3d_transpose`` are nn.functional's
(nn/cnn_ops.py) and are re-exported here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..nn.cnn_ops import (_conv, _conv_padding, _norm_tuple,  # noqa: F401
                          conv3d_transpose, fold, grid_sample, unpool)
from .registry import register_op

__all__ = ["depthwise_conv2d", "conv3d_transpose", "deformable_conv",
           "fold", "max_pool2d_with_index", "unpool", "roi_pool",
           "psroi_pool", "prior_box", "yolo_box", "matrix_nms",
           "multiclass_nms", "max_pool3d_with_index", "unpool3d",
           "generate_proposals", "distribute_fpn_proposals"]

# kBBoxClipDefault = log(1000 / 16) caps the decoded box's w and h
_BBOX_CLIP_DEFAULT = float(np.log(1000.0 / 16.0))


def _top_k(x, k):
    """(values, indices) of the k largest along the last axis, equal
    values in index order (lax.top_k's rule)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ======================= conv variants =======================
@register_op("depthwise_conv2d", amp_policy="white")
def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     data_format="NCHW"):
    """A convolution with groups == in_channels."""
    channels = x.shape[-1 if data_format[-1] == "C" else 1]
    return _conv(x, weight, bias, stride, padding, dilation, channels,
                 data_format)


@register_op("deformable_conv", amp_policy="white")
def deformable_conv(x, offset, weight, mask=None, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1):
    """Deformable convolution v1 / v2 (vision_ops.py:78): each of the
    kh * kw taps one bilinear ``grid_sample`` of x at (base + tap +
    offset), then one product with the weight. x [N, C, H, W]; offset
    [N, 2 * dg * kh * kw, Ho, Wo]; mask (v2) [N, dg * kh * kw, Ho, Wo];
    weight [Co, C / groups, kh, kw]."""
    N, C, H, W = x.shape
    Co, _, kh, kw = weight.shape
    stride = _norm_tuple(stride, 2)
    dilation = _norm_tuple(dilation, 2)
    pad = _conv_padding(padding, 2)
    Ho = (H + pad[0][0] + pad[0][1] - dilation[0] * (kh - 1) - 1) \
        // stride[0] + 1
    Wo = (W + pad[1][0] + pad[1][1] - dilation[1] * (kw - 1) - 1) \
        // stride[1] + 1
    dg = deformable_groups
    per_g = C // dg
    dev = x.device
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    base_y = (torch.arange(Ho, device=dev) * stride[0] - pad[0][0])[:, None]
    base_x = (torch.arange(Wo, device=dev) * stride[1] - pad[1][0])[None, :]
    xg = x.reshape(N * dg, per_g, H, W)
    cols = []
    for t in range(kh * kw):
        ky, kx = t // kw, t % kw
        py = base_y + ky * dilation[0] + off[:, :, t, 0]
        px = base_x + kx * dilation[1] + off[:, :, t, 1]
        # normalised to [-1, 1] for grid_sample (align_corners=True)
        gy = 2.0 * py / max(H - 1, 1) - 1.0
        gx = 2.0 * px / max(W - 1, 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1).reshape(N * dg, Ho, Wo, 2)
        samp = grid_sample.raw_fn(xg, grid.to(x.dtype), mode="bilinear",
                                  padding_mode="zeros", align_corners=True)
        samp = samp.reshape(N, dg, per_g, Ho, Wo)
        if mask is not None:
            m = mask.reshape(N, dg, kh * kw, Ho, Wo)[:, :, t]
            samp = samp * m[:, :, None]
        cols.append(samp.reshape(N, C, Ho, Wo))
    col = torch.stack(cols, dim=2)                  # [N, C, kh*kw, Ho, Wo]
    colg = col.reshape(N, groups, (C // groups) * kh * kw, Ho * Wo)
    wg = weight.reshape(groups, Co // groups, (C // groups) * kh * kw)
    out = torch.einsum("gok,ngkp->ngop", wg.float(), colg.float())
    out = out.reshape(N, Co, Ho, Wo).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(1, Co, 1, 1)
    return out


# ======================= pools with indices =======================
def _neg_fill(x):
    return -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min


@register_op("max_pool2d_with_index")
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    """Max pool and the flat H * W index of each maximum in the unpadded
    input (the first of equal maxima; feeds unpool)."""
    if isinstance(padding, str):
        raise ValueError(
            "max_pool2d_with_index needs explicit integer padding (the "
            "index contract is defined on the unpadded input); use "
            "max_pool2d for 'same'/'valid'")
    kh, kw = _norm_tuple(kernel_size, 2)
    sh, sw = _norm_tuple(stride if stride is not None else kernel_size, 2)
    pad = _conv_padding(padding, 2)
    N, C, H, W = x.shape
    xp = torch.nn.functional.pad(
        x, [pad[1][0], pad[1][1], pad[0][0], pad[0][1]], value=_neg_fill(x))
    patches = xp.unfold(2, kh, sh).unfold(3, kw, sw)   # [N,C,Ho,Wo,kh,kw]
    Ho, Wo = patches.shape[2:4]
    out, arg = patches.reshape(N, C, Ho, Wo, kh * kw).max(dim=-1)
    dev = x.device
    rows = (torch.arange(Ho, device=dev) * sh)[:, None, None, None] \
        + torch.arange(kh, device=dev)[None, None, :, None]
    colx = (torch.arange(Wo, device=dev) * sw)[None, :, None, None] \
        + torch.arange(kw, device=dev)[None, None, None, :]
    grid = ((rows - pad[0][0]) * W + (colx - pad[1][0])).reshape(
        Ho, Wo, kh * kw)
    idx = grid.expand(N, C, Ho, Wo, kh * kw).gather(-1, arg[..., None])
    return out, idx[..., 0].to(torch.int32)


@register_op("max_pool3d_with_index")
def max_pool3d_with_index(x, kernel_size, stride=None, padding=0):
    """The 3-D max pool with the flat D * H * W index of each maximum in
    the unpadded input (feeds unpool3d)."""
    if isinstance(padding, str):
        raise ValueError(
            "max_pool3d_with_index needs explicit integer padding (the "
            "index contract is defined on the unpadded input); use "
            "max_pool3d for 'same'/'valid'")
    kd, kh, kw = _norm_tuple(kernel_size, 3)
    sd, sh, sw = _norm_tuple(stride if stride is not None else kernel_size,
                             3)
    pad = _conv_padding(padding, 3)
    N, C, D, H, W = x.shape
    xp = torch.nn.functional.pad(
        x, [pad[2][0], pad[2][1], pad[1][0], pad[1][1], pad[0][0],
            pad[0][1]], value=_neg_fill(x))
    patches = xp.unfold(2, kd, sd).unfold(3, kh, sh).unfold(4, kw, sw)
    Do, Ho, Wo = patches.shape[2:5]
    k3 = kd * kh * kw
    out, arg = patches.reshape(N, C, Do, Ho, Wo, k3).max(dim=-1)
    dev = x.device
    zz = (torch.arange(Do, device=dev) * sd)[:, None, None, None, None,
                                             None] \
        + torch.arange(kd, device=dev)[None, None, None, :, None, None]
    yy = (torch.arange(Ho, device=dev) * sh)[None, :, None, None, None,
                                             None] \
        + torch.arange(kh, device=dev)[None, None, None, None, :, None]
    xx = (torch.arange(Wo, device=dev) * sw)[None, None, :, None, None,
                                             None] \
        + torch.arange(kw, device=dev)[None, None, None, None, None, :]
    grid = (((zz - pad[0][0]) * H + (yy - pad[1][0])) * W
            + (xx - pad[2][0])).reshape(Do, Ho, Wo, k3)
    idx = grid.expand(N, C, Do, Ho, Wo, k3).gather(-1, arg[..., None])
    return out, idx[..., 0].to(torch.int32)


@register_op("unpool3d")
def unpool3d(x, indices, kernel_size=2, stride=None, padding=0,
             output_size=None):
    """max_unpool3d: each pooled value written at its flat D * H * W
    index of a zero [N, C, D, H, W]."""
    N, C, Do, Ho, Wo = x.shape
    if output_size is None:
        kd, kh, kw = _norm_tuple(kernel_size, 3)
        sd, sh, sw = _norm_tuple(
            stride if stride is not None else kernel_size, 3)
        pad = _conv_padding(padding, 3)
        D = (Do - 1) * sd - pad[0][0] - pad[0][1] + kd
        H = (Ho - 1) * sh - pad[1][0] - pad[1][1] + kh
        W = (Wo - 1) * sw - pad[2][0] - pad[2][1] + kw
    else:
        D, H, W = output_size[-3:]
    flat = torch.zeros((N, C, D * H * W), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(),
                        x.reshape(N, C, -1))
    return flat.reshape(N, C, D, H, W)


# ======================= roi pooling =======================
def _img_of_roi(boxes_num, N, R, device):
    """The image of each of R RoIs from the counts an image (None: all
    on image 0), as jnp.repeat with total_repeat_length gives it (RoIs
    past the counts' sum on the last image); no read-back."""
    if boxes_num is None:
        return torch.zeros((R,), dtype=torch.long, device=device)
    ends = torch.cumsum(boxes_num.long(), 0)
    idx = torch.searchsorted(ends, torch.arange(R, device=device),
                             right=True)
    return torch.clamp_max(idx, N - 1)


def _bins(lo0, extent, n, size, floor_first):
    """[R, n] (lo, hi) of the reference's quantised bins clipped to
    [0, size]: lo = lo0 + floor(i * extent / n), hi = lo0 + ceil((i + 1)
    * extent / n) (roi_pool), or floor / ceil of lo0 + i * extent / n
    (psroi_pool), in float32 as the reference computes them."""
    i = torch.arange(n, dtype=torch.float32, device=lo0.device)[None, :]
    e, l0 = extent[:, None], lo0[:, None]
    # a divisor on the device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which can round a quotient
    # that is an integer (a bin edge) to just below it
    n = torch.full((), float(n), device=lo0.device)
    if floor_first:
        lo = l0 + torch.floor(i * e / n)
        hi = l0 + torch.ceil((i + 1) * e / n)
    else:
        lo = torch.floor(l0 + i * e / n)
        hi = torch.ceil(l0 + (i + 1) * e / n)
    return (torch.clamp(lo, 0, size).long(), torch.clamp(hi, 0, size).long())


def _floor_log2(n, device):
    """floor(log2(v)) for v in 0..n (0 for 0) as a lookup tensor."""
    v = np.zeros(n + 1, np.int64)
    v[2:] = np.floor(np.log2(np.arange(2, n + 1))).astype(np.int64)
    return torch.as_tensor(v, device=device)


def _sparse_table(x):
    """x [N, C, H, W] as [N, LH, LW, H, W, C]: entry (a, b, h, w) the
    maximum of x over rows [h, h + 2^a) and columns [w, w + 2^b) (-inf
    where the block runs off the map; a query never reads those)."""
    N, C, H, W = x.shape
    lh, lw = H.bit_length(), W.bit_length()
    neg = _neg_fill(x)
    rows = [x.permute(0, 2, 3, 1)]                     # [N, H, W, C]
    for a in range(1, lh):
        prev, s = rows[-1], 1 << (a - 1)
        shifted = torch.cat([prev[:, s:], torch.full_like(prev[:, :s], neg)],
                            1)
        rows.append(torch.maximum(prev, shifted))
    table = []
    for r in rows:
        cols = [r]
        for b in range(1, lw):
            prev, s = cols[-1], 1 << (b - 1)
            shifted = torch.cat(
                [prev[:, :, s:], torch.full_like(prev[:, :, :s], neg)], 2)
            cols.append(torch.maximum(prev, shifted))
        table.append(torch.stack(cols, 1))             # [N, LW, H, W, C]
    return torch.stack(table, 1)                       # [N, LH, LW, H, W, C]


# RoIs a chunk of roi_pool's table reads, roi_align's samples and
# psroi_pool's integral-image reads: bounds the temporaries of one
# chunk to chunk x oh x ow x 4 x C elements
_ROI_CHUNK = 256


@register_op("roi_pool")
def roi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0):
    """RoI max pooling with the reference's quantised bins (vision_ops.py
    :254): bin (i, j) of a RoI the maximum of x over its rows [y_lo,
    y_hi) and columns [x_lo, x_hi), 0 where the bin is empty. x [N, C,
    H, W]; boxes [R, 4] (x1, y1, x2, y2); boxes_num [N] RoIs an image
    (None: all on image 0). Returns [R, C, oh, ow]."""
    oh, ow = _norm_tuple(output_size, 2)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    img = _img_of_roi(boxes_num, N, R, dev)
    scaled = torch.round(boxes * spatial_scale)
    x1, y1 = scaled[:, 0], scaled[:, 1]
    rw = torch.clamp_min(scaled[:, 2] - x1 + 1, 1.0)
    rh = torch.clamp_min(scaled[:, 3] - y1 + 1, 1.0)
    ylo, yhi = _bins(y1, rh, oh, H, True)              # [R, oh]
    xlo, xhi = _bins(x1, rw, ow, W, True)              # [R, ow]
    table = _sparse_table(x)
    LH, LW = table.shape[1:3]
    flat = table.reshape(-1, C)
    lg_h, lg_w = _floor_log2(H, dev), _floor_log2(W, dev)
    ny = torch.clamp_min(yhi - ylo, 0)
    nx = torch.clamp_min(xhi - xlo, 0)
    a, b = lg_h[ny], lg_w[nx]                          # [R, oh], [R, ow]
    # the two row blocks and two column blocks that cover each bin
    ys = torch.clamp(torch.stack([ylo, yhi - 2 ** a], -1), 0, H - 1)
    xs = torch.clamp(torch.stack([xlo, xhi - 2 ** b], -1), 0, W - 1)
    base = (img[:, None, None] * LH + a[:, :, None]) * LW + b[:, None, :]
    idx = ((base[:, :, :, None, None] * H + ys[:, :, None, :, None]) * W
           + xs[:, None, :, None, :])                  # [R, oh, ow, 2, 2]
    empty = (ny[:, :, None] == 0) | (nx[:, None, :] == 0)
    out = []
    for s in range(0, R, _ROI_CHUNK):
        v = flat[idx[s:s + _ROI_CHUNK].reshape(-1)].reshape(
            -1, oh, ow, 4, C).amax(dim=3)
        v = torch.where(empty[s:s + _ROI_CHUNK, :, :, None],
                        torch.zeros_like(v), v)
        out.append(v.permute(0, 3, 1, 2))
    if not out:
        return x.new_zeros((0, C, oh, ow))
    return torch.cat(out, 0)


@register_op("psroi_pool")
def psroi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0):
    """Position-sensitive RoI average pooling (vision_ops.py:300):
    output channel c at bin (i, j) the mean of input channel c * oh * ow
    + i * ow + j over the bin (0 where it is empty). Returns [R, C /
    (oh * ow), oh, ow]."""
    oh, ow = _norm_tuple(output_size, 2)
    N, C, H, W = x.shape
    Co = C // (oh * ow)
    R = boxes.shape[0]
    dev = x.device
    img = _img_of_roi(boxes_num, N, R, dev)
    scaled = boxes * spatial_scale
    x1, y1 = scaled[:, 0], scaled[:, 1]
    rw = torch.clamp_min(scaled[:, 2] - x1, 0.1)
    rh = torch.clamp_min(scaled[:, 3] - y1, 0.1)
    ylo, yhi = _bins(y1, rh, oh, H, False)
    xlo, xhi = _bins(x1, rw, ow, W, False)
    ny = torch.clamp_min(yhi - ylo, 0)
    nx = torch.clamp_min(xhi - xlo, 0)
    # the integral image in float64: S[h, w] = sum of x[:h, :w]
    s = torch.nn.functional.pad(
        x.double().cumsum(2).cumsum(3), [1, 0, 1, 0])  # [N, C, H+1, W+1]
    flat = s.reshape(-1)
    ch = (torch.arange(Co, device=dev)[:, None, None] * (oh * ow)
          + torch.arange(oh, device=dev)[None, :, None] * ow
          + torch.arange(ow, device=dev)[None, None, :])  # [Co, oh, ow]
    out = []
    for s0 in range(0, R, _ROI_CHUNK):
        sl = slice(s0, s0 + _ROI_CHUNK)
        plane = (img[sl, None, None, None] * C + ch[None]) * (H + 1)

        def at(yy, xx):
            return flat[((plane + yy[:, None, :, None]) * (W + 1)
                         + xx[:, None, None, :])]

        tot = (at(yhi[sl], xhi[sl]) - at(ylo[sl], xhi[sl])
               - at(yhi[sl], xlo[sl]) + at(ylo[sl], xlo[sl]))
        cnt = torch.clamp_min(ny[sl][:, :, None] * nx[sl][:, None, :], 1)
        out.append((tot.to(x.dtype) / cnt[:, None].to(x.dtype)))
    if not out:
        return x.new_zeros((0, Co, oh, ow))
    return torch.cat(out, 0)


# ======================= anchors / decode =======================
@register_op("prior_box")
def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False):
    """SSD prior boxes [fh, fw, P, 4] and their variances (anchor math
    only)."""
    fh, fw = input.shape[-2:]
    ih, iw = image.shape[-2:]
    step_h = steps[1] if steps[1] > 0 else ih / fh
    step_w = steps[0] if steps[0] > 0 else iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes_per = []
    for ms in min_sizes:
        boxes_per.append((ms, ms))
        if min_max_aspect_ratios_order and max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            boxes_per.append((float(np.sqrt(ms * mx)),) * 2)
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            boxes_per.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes and not min_max_aspect_ratios_order:
            mx = max_sizes[min_sizes.index(ms)]
            boxes_per.append((float(np.sqrt(ms * mx)),) * 2)
    dev = input.device
    wh = torch.as_tensor(np.asarray(boxes_per, np.float32), device=dev)
    cx = (torch.arange(fw, device=dev) + offset) * step_w
    cy = (torch.arange(fh, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy.float(), cx.float(), indexing="ij")
    c = torch.stack([cxg, cyg], -1)[:, :, None, :]     # [fh, fw, 1, 2]
    half = wh[None, None] / 2.0
    size = torch.tensor([iw, ih], dtype=torch.float32, device=dev)
    out = torch.cat([(c - half) / size, (c + half) / size], -1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(out.shape)
    return out, var


@register_op("yolo_box")
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """YOLOv3 head predictions decoded to boxes [N, na * H * W, 4] and
    scores [N, na * H * W, class_num] (elementwise math only; a box
    whose confidence is at most conf_thresh is zero)."""
    N, _, H, W = x.shape
    na = len(anchors) // 2
    dev = x.device
    aw = torch.tensor(anchors[0::2], dtype=torch.float32, device=dev)
    ah = torch.tensor(anchors[1::2], dtype=torch.float32, device=dev)
    attrs = 5 + class_num + (1 if iou_aware else 0)
    p = x.reshape(N, na, attrs, H, W)
    if iou_aware:
        ioup = torch.sigmoid(p[:, :, 0])
        p = p[:, :, 1:]
    gx = torch.arange(W, dtype=torch.float32, device=dev)
    gy = torch.arange(H, dtype=torch.float32, device=dev)
    bx = (torch.sigmoid(p[:, :, 0]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gx[None, None, None, :]) / W
    by = (torch.sigmoid(p[:, :, 1]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gy[None, None, :, None]) / H
    in_w = downsample_ratio * W
    in_h = downsample_ratio * H
    bw = torch.exp(p[:, :, 2]) * aw[None, :, None, None] / in_w
    bh = torch.exp(p[:, :, 3]) * ah[None, :, None, None] / in_h
    conf = torch.sigmoid(p[:, :, 4])
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * ioup ** iou_aware_factor
    cls = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    keep = conf > conf_thresh
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros_like(x1)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1)          # [N, na, H, W, 4]
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    cls = torch.where(keep[:, :, None], cls, torch.zeros_like(cls))
    boxes = boxes.reshape(N, na * H * W, 4)
    scores = cls.permute(0, 1, 3, 4, 2).reshape(N, na * H * W, class_num)
    return boxes, scores


def _iou_matrix(a, b, normalized=True):
    """[..., Na, 4] x [..., Nb, 4] (x1, y1, x2, y2) -> [..., Na, Nb] IoU;
    normalized=False adds the reference's +1 pixel correction. The
    reference's arithmetic in its order, one [..., Na, Nb] tensor an
    operation (no pairs of coordinates)."""
    off = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = torch.clamp_min(ax2 - ax1 + off, 0) * \
        torch.clamp_min(ay2 - ay1 + off, 0)
    area_b = torch.clamp_min(bx2 - bx1 + off, 0) * \
        torch.clamp_min(by2 - by1 + off, 0)
    w = torch.minimum(ax2[..., :, None], bx2[..., None, :]) \
        - torch.maximum(ax1[..., :, None], bx1[..., None, :])
    w = torch.clamp_min(w + off, 0.0)
    h = torch.minimum(ay2[..., :, None], by2[..., None, :]) \
        - torch.maximum(ay1[..., :, None], by1[..., None, :])
    h = torch.clamp_min(h + off, 0.0)
    inter = w * h
    return inter / torch.clamp_min(
        area_a[..., :, None] + area_b[..., None, :] - inter, 1e-10)


@register_op("matrix_nms")
def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=100, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, normalized=True):
    """SOLOv2 matrix NMS (vision_ops.py:453): each box's score decayed by
    its IoU with higher-scoring boxes of its class, one dense IoU
    matrix an image. bboxes [N, M, 4], scores [N, C, M]. Returns
    ([N, keep_top_k, 6] rows (class, score, box), -1 padded, and the
    count an image)."""
    N, C, M = scores.shape
    dev = scores.device
    k = min(nms_top_k, M)
    cls_sc, cls_ord = _top_k(scores, k)                # [N, C, k]
    flat_sc = cls_sc.reshape(N, C * k)
    cls_of = torch.arange(C * k, device=dev) // k
    box_of = cls_ord.reshape(N, C * k)
    top_sc, top_i = _top_k(flat_sc, C * k)
    tcls = cls_of[top_i]                               # [N, C*k]
    tbox = bboxes.gather(1, box_of.gather(1, top_i)[..., None].expand(
        -1, -1, 4))                                    # [N, C*k, 4]
    valid = top_sc > score_threshold
    iou = _iou_matrix(tbox, tbox, normalized)
    same = tcls[:, :, None] == tcls[:, None, :]
    n = iou.shape[-1]
    ar = torch.arange(n, device=dev)
    higher = (ar[:, None] > ar[None, :])[None] & valid[:, None, :]
    sh = same & higher
    if use_gaussian:
        def f(t):
            return torch.exp(-(t ** 2) / gaussian_sigma)
    else:
        def f(t):
            return 1.0 - t
    cmax = torch.amax(torch.where(sh, iou, torch.zeros_like(iou)), dim=2)
    ratio = f(iou) / torch.clamp_min(f(cmax)[:, None, :], 1e-10)
    decay = torch.amin(torch.where(sh, ratio, torch.full_like(ratio,
                                                              math.inf)),
                       dim=2)
    decay = torch.where(torch.isinf(decay), torch.ones_like(decay),
                        torch.clamp_max(decay, 1.0))
    neg = torch.full_like(top_sc, -1.0)
    dec_sc = torch.where(valid, top_sc * decay, neg)
    dec_sc = torch.where(dec_sc > post_threshold, dec_sc, neg)
    kk = min(keep_top_k, dec_sc.shape[1])
    out_sc, keep = _top_k(dec_sc, kk)
    return _nms_rows(out_sc, tcls.gather(1, keep),
                     tbox.gather(1, keep[..., None].expand(-1, -1, 4)),
                     keep_top_k)


def _nms_rows(out_sc, cls, box, keep_top_k):
    """([N, keep_top_k, 6] rows (class, score, box), each row with a
    score at most 0 all -1, and the live count an image)."""
    ok = out_sc > 0
    m1 = torch.full_like(out_sc, -1.0)
    out = torch.cat([
        torch.where(ok, cls.to(torch.float32), m1)[..., None],
        torch.where(ok, out_sc, m1)[..., None],
        torch.where(ok[..., None], box, torch.full_like(box, -1.0))], -1)
    kk = out.shape[1]
    if kk < keep_top_k:
        out = torch.cat([out, out.new_full((out.shape[0], keep_top_k - kk,
                                            6), -1.0)], 1)
    return out, ok.sum(1).to(torch.int32)


def _greedy_nms_keep(boxes, live, thresh, normalized=True, eta=1.0):
    """Greedy NMS over score-descending candidates boxes [B, k, 4] (a
    batch of independent sets): the keep mask [B, k]. `live` marks the
    candidates in play. Candidate i, if still kept, suppresses every
    later one whose IoU with it exceeds the threshold; with eta < 1 the
    threshold then decays by eta while above 0.5 (the reference's
    adaptive NMS). The IoU matrix is built once and walked row by row
    on the device, every set at once, with no read-back."""
    B, k = boxes.shape[:2]
    later = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu(1)
    # the IoU matrix in chunks of sets, its temporaries ~2^26 elements
    step = max(1, (1 << 26) // max(k * k, 1))
    iou = torch.cat([_iou_matrix(boxes[s:s + step], boxes[s:s + step],
                                 normalized) for s in range(0, B, step)]) \
        if B else boxes.new_zeros((0, k, k))
    keep = live.clone()
    if eta >= 1.0:
        # row i of every set contiguous: [k, B, k]
        over = ((iou > thresh) & later).transpose(0, 1).contiguous()
        for i in range(k - 1):
            keep &= ~(over[i] & keep[:, i:i + 1])
        return keep
    thr = torch.full((B, 1), float(thresh), dtype=torch.float32,
                     device=boxes.device)
    for i in range(k):
        ki = keep[:, i:i + 1]
        sup = (iou[:, i] > thr) & ki & later[i]
        thr = torch.where((thr > 0.5) & ki, thr * eta, thr)
        keep &= ~sup
    return keep


@register_op("multiclass_nms")
def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=100,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=-1):
    """Per-class greedy NMS (vision_ops.py:505) with the fixed [N,
    keep_top_k, 6] output (class, score, box), -1 padded, and the count
    an image. bboxes [N, M, 4], scores [N, C, M]."""
    N, C, M = scores.shape
    k = min(nms_top_k, M)
    top_sc, order = _top_k(scores, k)                  # [N, C, k]
    b = bboxes.gather(1, order.reshape(N, C * k)[..., None].expand(
        -1, -1, 4)).reshape(N * C, k, 4)
    keep = _greedy_nms_keep(b, (top_sc > score_threshold).reshape(N * C, k),
                            nms_threshold, normalized,
                            eta=nms_eta).reshape(N, C, k)
    per_cls = torch.where(keep, top_sc, torch.full_like(top_sc, -1.0))
    if background_label >= 0:
        per_cls[:, background_label] = -1.0
    flat_sc = per_cls.reshape(N, C * k)
    flat_ord = order.reshape(N, C * k)
    cls_of = torch.arange(C * k, device=scores.device) // k
    kk = min(keep_top_k, C * k)
    out_sc, sel = _top_k(flat_sc, kk)
    sel_box = bboxes.gather(1, flat_ord.gather(1, sel)[..., None].expand(
        -1, -1, 4))
    return _nms_rows(out_sc, cls_of[sel], sel_box, keep_top_k)


@register_op("generate_proposals")
def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False):
    """RPN proposals (vision_ops.py:639): per image the top pre_nms_top_n
    anchors decoded with their variances, clipped to the image, those
    under min_size dropped, greedy NMS, then the top post_nms_top_n
    survivors, padded with zero rows (scores 0) to post_nms_top_n.
    scores [N, A, H, W], bbox_deltas [N, 4A, H, W], img_size [N, 2] (h,
    w), anchors and variances [H, W, A, 4]. Returns (rois [N, m, 4],
    probs [N, m], the live count an image)."""
    if eta < 1.0:
        raise ValueError("generate_proposals does not support adaptive "
                         "NMS (eta < 1.0), matching the reference")
    min_size = max(float(min_size), 1.0)
    n, a, h, w = scores.shape
    anc = anchors.reshape(-1, 4)
    var = variances.reshape(-1, 4)
    off = 1.0 if pixel_offset else 0.0
    s_flat = scores.permute(0, 2, 3, 1).reshape(n, -1)   # [N, H*W*A]
    d_flat = bbox_deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    total = s_flat.shape[1]
    k = total if pre_nms_top_n <= 0 else min(pre_nms_top_n, total)
    top_s, order = _top_k(s_flat, k)                   # [N, k]
    anc_k, var_k = anc[order], var[order]              # [N, k, 4]
    d_k = d_flat.gather(1, order[..., None].expand(-1, -1, 4))
    aw = anc_k[..., 2] - anc_k[..., 0] + off
    ah = anc_k[..., 3] - anc_k[..., 1] + off
    acx = anc_k[..., 0] + aw * 0.5
    acy = anc_k[..., 1] + ah * 0.5
    cx = var_k[..., 0] * d_k[..., 0] * aw + acx
    cy = var_k[..., 1] * d_k[..., 1] * ah + acy
    bw = torch.exp(torch.clamp_max(var_k[..., 2] * d_k[..., 2],
                                   _BBOX_CLIP_DEFAULT)) * aw
    bh = torch.exp(torch.clamp_max(var_k[..., 3] * d_k[..., 3],
                                   _BBOX_CLIP_DEFAULT)) * ah
    im = img_size.to(scores.dtype)
    imh, imw = im[:, 0:1], im[:, 1:2]
    zero = torch.zeros_like(cx)
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - bw * 0.5, zero), imw - off),
        torch.minimum(torch.maximum(cy - bh * 0.5, zero), imh - off),
        torch.minimum(torch.maximum(cx + bw * 0.5 - off, zero), imw - off),
        torch.minimum(torch.maximum(cy + bh * 0.5 - off, zero), imh - off)],
        -1)
    ws = boxes[..., 2] - boxes[..., 0] + off
    hs = boxes[..., 3] - boxes[..., 1] + off
    valid = (ws >= min_size) & (hs >= min_size)
    ninf = torch.full_like(top_s, -math.inf)
    top_s = torch.where(valid, top_s, ninf)
    keep = _greedy_nms_keep(boxes, top_s > -math.inf, nms_thresh,
                            normalized=not pixel_offset)
    kept_s = torch.where(keep, top_s, ninf)
    m = min(post_nms_top_n, k)
    out_s, sel = _top_k(kept_s, m)
    out_b = boxes.gather(1, sel[..., None].expand(-1, -1, 4))
    live = out_s > -math.inf
    out_b = out_b * live[..., None].to(out_b.dtype)
    out_s = torch.where(live, out_s, torch.zeros_like(out_s))
    return out_b, out_s, live.to(torch.int32).sum(1).to(torch.int32)


@register_op("distribute_fpn_proposals")
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None,
                             pixel_offset=False):
    """RoIs assigned to FPN levels by scale (vision_ops.py:719): level =
    floor(refer_level + log2(sqrt(area) / refer_scale)), clipped to
    [min_level, max_level]. Returns each level's [R, 4] RoIs (that
    level's in input order first, then zero rows), the counts [L] and
    restore_index [R, 1] (each input RoI's row in the levels'
    concatenation)."""
    r = fpn_rois.shape[0]
    dev = fpn_rois.device
    off = 1.0 if pixel_offset else 0.0
    ws = fpn_rois[:, 2] - fpn_rois[:, 0] + off
    hs = fpn_rois[:, 3] - fpn_rois[:, 1] + off
    scale = torch.sqrt(torch.clamp_min(ws * hs, 1e-12))
    # a divisor on the device (see _bins): a RoI of exactly refer_scale
    # times a power of two stays on its level on the card
    ref = torch.full((), float(refer_scale), device=dev)
    lvl = torch.floor(refer_level + torch.log2(scale / ref + 1e-12))
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    ar = torch.arange(r, device=dev)
    if rois_num is not None:
        live = ar < torch.sum(rois_num.to(torch.int32))
    else:
        live = torch.ones((r,), dtype=torch.bool, device=dev)
    lvl = torch.where(live, lvl, torch.full_like(lvl, max_level + 1))
    multi_rois, multi_nums = [], []
    pos = torch.zeros((r,), dtype=torch.int32, device=dev)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    for level in range(min_level, max_level + 1):
        mask = lvl == level
        cnt = mask.to(torch.int32).sum().to(torch.int32)
        order = torch.argsort(torch.where(mask, ar, torch.full_like(ar, r + 1)),
                              stable=True)
        packed = fpn_rois[order] * (ar < cnt)[:, None].to(fpn_rois.dtype)
        multi_rois.append(packed)
        multi_nums.append(cnt)
        rank = torch.cumsum(mask.to(torch.int32), 0).to(torch.int32) - 1
        pos = torch.where(mask, base + rank, pos)
        base = base + cnt
    return (*multi_rois, torch.stack(multi_nums), pos[:, None])
