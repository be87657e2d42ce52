"""Vision ops (counterpart of paddle_tpu/vision/ops.py): ``nms``,
``roi_align``, ``box_coder``, ``deform_conv2d``, ``read_file``,
``decode_jpeg`` and ``yolo_loss``.

``nms`` is eager with a dynamic output, as the reference's: it reads
one flag back a candidate (a sync on the card, not a fallback) and
skips the candidates already suppressed. ``roi_align`` samples the
channels-last map a chunk of RoIs at a time, so its temporaries stay a
small multiple of its output. ``yolo_loss`` scatters each ground truth
into a map with one spare anchor slot that takes the ground truths the
reference's scatter drops (out of bounds), then slices it off.
``decode_jpeg`` imports PIL when called, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..ops.registry import register_op
from ..ops.vision_ops import _img_of_roi

__all__ = ["nms", "roi_align", "box_coder", "deform_conv2d", "read_file",
           "decode_jpeg", "yolo_loss"]

# RoIs a chunk of roi_align samples (its four gathers' temporaries are
# chunk x oh x ow x C elements each)
_ALIGN_CHUNK = 256


@register_op("nms")
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS in score order (input order without scores): the kept
    candidates' indices (int64)."""
    n = boxes.shape[0]
    dev = boxes.device
    order = torch.arange(n, device=dev) if scores is None else \
        torch.argsort(-scores, stable=True)
    b = boxes[order]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    ar = torch.arange(n, device=dev)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(n):
        if not bool(keep[i]):
            continue
        xx1 = torch.maximum(x1[i], x1)
        yy1 = torch.maximum(y1[i], y1)
        xx2 = torch.minimum(x2[i], x2)
        yy2 = torch.minimum(y2[i], y2)
        inter = torch.clamp_min(xx2 - xx1, 0) * torch.clamp_min(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas - inter + 1e-10)
        keep &= ~((iou > iou_threshold) & (ar > i))
    kept = order[torch.nonzero(keep)[:, 0]]
    if top_k is not None:
        kept = kept[:top_k]
    return kept.to(torch.int64)


@register_op("roi_align")
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign (vision/ops.py:46): one bilinear sample at each bin's
    centre (the reference takes and ignores sampling_ratio), neighbours
    clamped to the map. x [N, C, H, W], boxes [R, 4], boxes_num [N].
    Returns [R, C, oh, ow]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = x.shape
    R = boxes.shape[0]
    dev = x.device
    batch_idx = _img_of_roi(boxes_num, n, R, dev)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    rw = torch.clamp_min(x2 - x1, 1e-3)
    rh = torch.clamp_min(y2 - y1, 1e-3)
    ys = (torch.arange(oh, device=dev) + 0.5) / oh
    xs = (torch.arange(ow, device=dev) + 0.5) / ow
    gy = y1[:, None] + rh[:, None] * ys[None, :]       # [R, oh]
    gx = x1[:, None] + rw[:, None] * xs[None, :]       # [R, ow]
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y1_ = torch.clamp(y0 + 1, 0, h - 1)
    x1_ = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(gy - y0, 0, 1)[:, :, None, None]  # [R, oh, 1, 1]
    wx = torch.clamp(gx - x0, 0, 1)[:, None, :, None]  # [R, 1, ow, 1]
    flat = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    row = batch_idx * h

    def at(yy, xx, s):
        idx = ((row[s, None, None] + yy[s, :, None]) * w + xx[s, None, :])
        return flat[idx.reshape(-1)].reshape(idx.shape + (c,))

    out = []
    for s0 in range(0, R, _ALIGN_CHUNK):
        s = slice(s0, s0 + _ALIGN_CHUNK)
        v = (at(y0, x0, s) * (1 - wy[s]) * (1 - wx[s])
             + at(y0, x1_, s) * (1 - wy[s]) * wx[s]
             + at(y1_, x0, s) * wy[s] * (1 - wx[s])
             + at(y1_, x1_, s) * wy[s] * wx[s])
        out.append(v.permute(0, 3, 1, 2))
    if not out:
        return x.new_zeros((0, c, oh, ow))
    return torch.cat(out, 0)


@register_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True):
    pw = prior_box[:, 2] - prior_box[:, 0]
    ph = prior_box[:, 3] - prior_box[:, 1]
    px = prior_box[:, 0] + pw / 2
    py = prior_box[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0]
        th = target_box[:, 3] - target_box[:, 1]
        tx = target_box[:, 0] + tw / 2
        ty = target_box[:, 1] + th / 2
        out = torch.stack([(tx - px) / pw, (ty - py) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=1)
        if prior_box_var is not None:
            out = out / prior_box_var
        return out
    if code_type == "decode_center_size":
        # deltas [M, 4] or [N, M, 4] against priors [M, 4]
        tb = target_box if target_box.dim() == 3 else target_box[None]
        if prior_box_var is not None:
            tb = tb * prior_box_var
        cx = tb[..., 0] * pw + px
        cy = tb[..., 1] * ph + py
        w = torch.exp(tb[..., 2]) * pw
        h = torch.exp(tb[..., 3]) * ph
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          dim=-1)
        return out if target_box.dim() == 3 else out[0]
    raise NotImplementedError(code_type)


@register_op("deformable_conv")
def deform_conv2d(x, offset, weight, mask=None, bias=None, stride=1,
                  padding=0, dilation=1, deformable_groups=1, groups=1):
    """Deformable convolution v1 / v2 (vision/ops.py:124): the sampled
    im2col by a gather and bilinear weights (a tap outside the image
    contributes 0), then one grouped product with the weight, in
    float32. x [N, Cin, H, W]; offset [N, 2 * dg * kh * kw, Ho, Wo]
    (y, x pairs); mask [N, dg * kh * kw, Ho, Wo] (None: v1); weight
    [Cout, Cin / groups, kh, kw]."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    d = (dilation, dilation) if isinstance(dilation, int) else \
        tuple(dilation)
    N, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    Ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    Wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    dg = deformable_groups
    K = kh * kw
    dev = x.device
    off = offset.reshape(N, dg, K, 2, Ho, Wo).to(torch.float32)
    gy = torch.arange(Ho, device=dev) * s[0] - p[0]
    gx = torch.arange(Wo, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    base_y = (ky[:, None, None, None] + gy[None, None, :, None]).expand(
        kh, kw, Ho, Wo).reshape(K, Ho, Wo)
    base_x = (kx[None, :, None, None] + gx[None, None, None, :]).expand(
        kh, kw, Ho, Wo).reshape(K, Ho, Wo)
    sy = base_y[None, None] + off[:, :, :, 0]          # [N, dg, K, Ho, Wo]
    sx = base_x[None, None] + off[:, :, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    cg = Cin // dg
    xs = x.reshape(N, dg, cg, H * W).to(torch.float32)
    vals = 0.0
    for dy_, wy_ in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
        for dx_, wx_ in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            ok = (dy_ >= 0) & (dy_ < H) & (dx_ >= 0) & (dx_ < W)
            iy = torch.clamp(dy_, 0, H - 1).long()
            ix = torch.clamp(dx_, 0, W - 1).long()
            idx = (iy * W + ix).reshape(N, dg, 1, K * Ho * Wo)
            g = xs.gather(3, idx.expand(N, dg, cg, K * Ho * Wo)).reshape(
                N, dg, cg, K, Ho, Wo)
            vals = vals + g * (wy_ * wx_ * ok)[:, :, None]
    if mask is not None:
        vals = vals * mask.reshape(N, dg, 1, K, Ho, Wo)
    cols = vals.reshape(N, groups, (Cin // groups) * K, Ho * Wo)
    wf = weight.to(torch.float32).reshape(groups, Cout // groups,
                                          (Cin // groups) * K)
    out = torch.einsum("gok,ngkp->ngop", wf, cols).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, Cout, 1, 1)
    return out.to(x.dtype)


def read_file(filename, name=None):
    """A file's bytes as a uint8 1-D Tensor on the default place."""
    from ..core.device import default_torch_device
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).copy()
    return Tensor._wrap(torch.from_numpy(data).to(default_torch_device()))


def decode_jpeg(x, mode="unchanged", name=None):
    """A JPEG byte Tensor decoded on the host (PIL) to [C, H, W] uint8,
    on the bytes' device."""
    import io as _io

    from PIL import Image
    data = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    img = Image.open(_io.BytesIO(bytes(data.cpu().numpy().astype(
        np.uint8))))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, dtype=np.uint8)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return Tensor._wrap(torch.from_numpy(arr.copy()).to(data.device))


def _bce(logit, target):
    return torch.clamp_min(logit, 0) - logit * target + \
        torch.log1p(torch.exp(-torch.abs(logit)))


@register_op("yolo_loss")
def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, scale_x_y=1.0):
    """YOLOv3 loss (vision/ops.py:229): x [N, S * (5 + C), H, W], gt_box
    [N, B, 4] normalised (cx, cy, w, h), gt_label [N, B]. Each ground
    truth is matched to its best anchor by shape IoU over all anchors;
    one whose anchor is not in anchor_mask (or whose box is empty)
    trains nothing. Returns the loss an image [N]."""
    N, _, H, W = x.shape
    S = len(anchor_mask)
    C = class_num
    B = gt_box.shape[1]
    dev = x.device
    x = x.reshape(N, S, 5 + C, H, W).to(torch.float32)
    tx, ty = x[:, :, 0], x[:, :, 1]
    tw, th = x[:, :, 2], x[:, :, 3]
    tobj = x[:, :, 4]
    tcls = x[:, :, 5:]
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    mask_idx = torch.tensor(anchor_mask, dtype=torch.long, device=dev)
    in_w = W * downsample_ratio
    in_h = H * downsample_ratio
    gtb = gt_box.to(torch.float32)
    gw, gh = gtb[..., 2], gtb[..., 3]
    valid = (gw > 0) & (gh > 0)
    gscore = torch.ones((N, B), dtype=torch.float32, device=dev) \
        if gt_score is None else gt_score.to(torch.float32)
    # the best anchor of each ground truth, by shape IoU
    aw = an_all[:, 0] / in_w
    ah = an_all[:, 1] / in_h
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None], ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    an_iou = inter / torch.clamp_min(union, 1e-10)     # [N, B, A]
    best = torch.argmax(an_iou, dim=-1)                # [N, B]
    in_mask = best[..., None] == mask_idx              # [N, B, S]
    mpos = torch.where(in_mask.any(-1), torch.argmax(in_mask.to(
        torch.int8), dim=-1), torch.full_like(best, -1))
    gi = torch.clamp((gtb[..., 0] * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gtb[..., 1] * H).to(torch.int32), 0, H - 1).long()
    live = valid & (mpos >= 0)
    # of ground truths that land on one cell and anchor the last one
    # writes the maps (the reference's scatter applies its updates in
    # order); the others and the dead go to the spare slot S, sliced off
    cell = (mpos * H + gj) * W + gi
    later = torch.ones((B, B), dtype=torch.bool, device=dev).triu(1)
    shadowed = ((cell[:, :, None] == cell[:, None, :]) & live[:, None, :]
                & later).any(-1)
    sm = torch.where(live & ~shadowed, mpos, torch.full_like(mpos, S))
    nidx = torch.arange(N, device=dev)[:, None].expand(N, B)

    def smap(vals):
        m = torch.zeros((N, S + 1, H, W), dtype=torch.float32, device=dev)
        m[nidx, sm, gj, gi] = vals.to(torch.float32)
        return m[:, :S]

    bi = torch.clamp(best, 0, an_all.shape[0] - 1)
    pw, ph = an_all[bi, 0], an_all[bi, 1]
    obj_map = smap(torch.where(live, gscore, torch.zeros_like(gscore)))
    tx_t = smap(gtb[..., 0] * W - gi)
    ty_t = smap(gtb[..., 1] * H - gj)
    tw_t = smap(torch.log(torch.clamp_min(
        gw * in_w / torch.clamp_min(pw, 1e-9), 1e-9)))
    th_t = smap(torch.log(torch.clamp_min(
        gh * in_h / torch.clamp_min(ph, 1e-9), 1e-9)))
    scale_t = smap(2.0 - gw * gh)
    lbl = torch.clamp(gt_label.long(), 0, C - 1)
    cls_t = torch.zeros((N, S + 1, H, W, C), dtype=torch.float32,
                        device=dev)
    cls_t[nidx, torch.where(live, mpos, torch.full_like(mpos, S)), gj, gi,
          lbl] = 1.0
    cls_t = cls_t[:, :S]
    pos = obj_map > 0
    posf = pos.to(torch.float32)
    loss_xy = (_bce(tx, tx_t) + _bce(ty, ty_t)) * scale_t * posf
    loss_wh = (torch.abs(tw - tw_t) + torch.abs(th - th_t)) * scale_t * posf
    smooth = 1.0 / max(C, 1) if (use_label_smooth and C > 1) else 0.0
    cls_target = cls_t * (1 - smooth) + smooth / max(C, 1) if smooth \
        else cls_t
    loss_cls = (_bce(tcls.permute(0, 1, 3, 4, 2), cls_target)
                * posf[..., None]).sum(-1)
    # objectness: a prediction whose IoU with any ground truth exceeds
    # ignore_thresh is not a negative
    grid_x = (torch.arange(W, device=dev)[None, None, None]
              + torch.sigmoid(tx)) / W
    grid_y = (torch.arange(H, device=dev)[None, None, :, None]
              + torch.sigmoid(ty)) / H
    pw_map = an_all[mask_idx, 0][None, :, None, None]
    ph_map = an_all[mask_idx, 1][None, :, None, None]
    pred_w = torch.exp(tw) * pw_map / in_w
    pred_h = torch.exp(th) * ph_map / in_h

    def box_iou(cx1, cy1, w1, h1, cx2, cy2, w2, h2):
        l1, r1 = cx1 - w1 / 2, cx1 + w1 / 2
        t1, b1 = cy1 - h1 / 2, cy1 + h1 / 2
        l2, r2 = cx2 - w2 / 2, cx2 + w2 / 2
        t2, b2 = cy2 - h2 / 2, cy2 + h2 / 2
        iw = torch.clamp_min(torch.minimum(r1, r2) - torch.maximum(l1, l2), 0)
        ih = torch.clamp_min(torch.minimum(b1, b2) - torch.maximum(t1, t2), 0)
        inter = iw * ih
        return inter / torch.clamp_min(w1 * h1 + w2 * h2 - inter, 1e-10)

    g = gtb[:, None, None, None]
    ious = box_iou(grid_x[..., None], grid_y[..., None], pred_w[..., None],
                   pred_h[..., None], g[..., 0], g[..., 1], g[..., 2],
                   g[..., 3])
    ious = torch.where(valid[:, None, None, None], ious,
                       torch.zeros_like(ious))
    ignore = (ious.amax(-1) > ignore_thresh) & ~pos
    loss_obj = _bce(tobj, obj_map) * torch.where(
        ignore, torch.zeros_like(tobj), torch.ones_like(tobj))
    loss_obj = torch.where(pos, loss_obj * obj_map, loss_obj)
    total = loss_xy + loss_wh + loss_cls + loss_obj
    return total.sum(dim=(1, 2, 3))
