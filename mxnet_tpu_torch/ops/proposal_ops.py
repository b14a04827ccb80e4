"""Region-proposal, SSD-training and deformable operators: counterpart of
``mxnet_tpu/ops/proposal_ops.py``.

- ``MultiBoxTarget``: SSD target assignment (each anchor's best ground
  truth above ``overlap_threshold``, plus each ground truth's best anchor,
  later boxes winning a shared anchor), with hard-negative mining ranked
  by the largest non-background probability (a stable sort).
- ``MultiBoxDetection``: decode, a background winner's score -1, class ids
  from the first foreground class, then :func:`.detection_ops.box_nms`
  with ``id_index=0``, ``background_id=-1``.
- ``Proposal`` / ``MultiProposal``: Faster R-CNN's RPN on batch rows
  (``cls_prob[:, Anum:]`` the foreground scores): anchors ratio-major then
  scale, the "+1" pixel convention in widths and ``min_size``, the top
  ``rpn_pre_nms_top_n`` in ``lax.top_k``'s order (ties: the lower index
  first), NMS, then the top ``rpn_post_nms_top_n``; suppressed rows are 0.
- ``PSROIPooling``, ``DeformablePSROIPooling``, ``RROIAlign``: bilinear
  samples averaged a bin (the reference's departures from MXNet 1.6: a
  fixed 2x2 grid for PSROIPooling, the integer-rounded corners of the
  deformable one); ``DeformableConvolution`` (v1) and
  ``ModulatedDeformableConvolution`` (v2): K*K bilinear samples (zero
  outside the map) then one product over the sampled columns;
  ``mrcnn_mask_target``.
"""
from __future__ import annotations

import math

import torch

from . import _jnp
from .core import _sort_idx
from .detection_ops import _channels_last, _div, _pooled_size, \
    _roi_blocks, box_nms, iou_corner, roi_align
from .registry import register
from .spatial_ops import sample_bilinear

__all__ = ["MultiBoxTarget", "MultiBoxDetection", "multibox_decode",
           "proposal_candidates", "proposal_select", "base_anchors",
           "Proposal", "MultiProposal", "PSROIPooling", "RROIAlign",
           "DeformablePSROIPooling", "DeformableConvolution",
           "ModulatedDeformableConvolution", "mrcnn_mask_target"]


def _center(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return b[..., 0] + w / 2, b[..., 1] + h / 2, w, h


def _full(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",
                                              "_npx_multibox_target"),
          n_out=3)
def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """``anchor (1, N, 4)``, ``label (B, M, 5)`` rows ``[cls, x1, y1, x2,
    y2]`` (pad rows cls -1), ``cls_pred (B, classes + 1, N)`` ->
    ``(box_target (B, N*4), box_mask (B, N*4), cls_target (B, N))``."""
    A = anchor.reshape(-1, 4)
    N = A.shape[0]
    B, M = label.shape[0], label.shape[1]
    acx, acy, aw, ah = _center(A)
    v0, v1, v2, v3 = (float(v) for v in variances)
    dev = label.device
    gt_valid = label[:, :, 0] >= 0
    gt_boxes = label[:, :, 1:5]
    iou = iou_corner(A[None], gt_boxes)                      # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, _full(-1.0, iou))
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)
    matched = best_iou > overlap_threshold
    best_anchor = torch.argmax(iou, dim=1)                   # (B, M)
    forced = torch.zeros((B, N), dtype=torch.bool, device=dev)
    forced_gt = best_gt.clone()
    rows = torch.arange(B, device=dev)
    for m in range(M):
        a_m, take = best_anchor[:, m], gt_valid[:, m]
        forced[rows, a_m] = forced[rows, a_m] | take
        forced_gt[rows, a_m] = torch.where(
            take, torch.full_like(a_m, m), forced_gt[rows, a_m])
    matched = matched | forced
    match_id = torch.where(forced, forced_gt, best_gt)
    g = torch.gather(gt_boxes, 1, match_id[:, :, None].expand(B, N, 4))
    gcx, gcy, gw, gh = _center(g)
    eps = 1e-8
    t = torch.stack([_div((gcx - acx) / (aw + eps), v0),
                     _div((gcy - acy) / (ah + eps), v1),
                     _div(torch.log(torch.clamp_min(gw / (aw + eps), eps)),
                          v2),
                     _div(torch.log(torch.clamp_min(gh / (ah + eps), eps)),
                          v3)], dim=-1)
    zero = _full(0.0, t)
    box_target = torch.where(matched[..., None], t, zero).reshape(B, -1)
    box_mask = torch.where(matched[..., None], torch.ones_like(t),
                           zero).reshape(B, -1)
    cls = torch.where(matched, torch.gather(label[:, :, 0], 1, match_id)
                      + 1.0, _full(0.0, label))
    if negative_mining_ratio > 0:
        neg_conf = torch.amax(cls_pred[:, 1:], dim=1)        # (B, N)
        ninf = _full(-math.inf, neg_conf)
        neg_score = torch.where(matched, ninf, torch.where(
            neg_conf > negative_mining_thresh, neg_conf, ninf))
        order = _sort_idx(-neg_score, 1)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=dev).expand(B, N).contiguous())
        num_pos = matched.sum(dim=1)
        num_neg = torch.clamp_min(
            _jnp.astype(negative_mining_ratio * num_pos.to(torch.float64),
                        torch.int32).long(),
            int(minimum_negative_samples))
        keep_neg = (rank < num_neg[:, None]) & torch.isfinite(neg_score)
        cls = torch.where(matched, cls, torch.where(
            keep_neg, _full(0.0, cls), _full(float(ignore_label), cls)))
    return box_target, box_mask, cls


def multibox_decode(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                    background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """``MultiBoxDetection``'s rows before NMS: ``(B, N, 6)`` ``[cls_id,
    score, x1, y1, x2, y2]``, -1 where the score is at most
    ``threshold``."""
    B, _, N = cls_prob.shape
    acx, acy, aw, ah = _center(anchor.reshape(-1, 4))
    v0, v1, v2, v3 = (float(v) for v in variances)
    score = torch.amax(cls_prob, dim=1)
    winner = torch.argmax(cls_prob, dim=1)
    cls_id = (winner - (winner > background_id).long()).to(cls_prob.dtype)
    score = torch.where(winner == background_id, _full(-1.0, score), score)
    p = loc_pred.reshape(B, N, 4)
    cx = p[..., 0] * v0 * aw + acx
    cy = p[..., 1] * v1 * ah + acy
    w = torch.exp(p[..., 2] * v2) * aw
    h = torch.exp(p[..., 3] * v3) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    det = torch.cat([cls_id[..., None], score[..., None], boxes], -1)
    return torch.where(score[..., None] > threshold, det, _full(-1.0, det))


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",
                                                 "_npx_multibox_detection"))
def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """``cls_prob (B, classes + 1, N)``, ``loc_pred (B, N*4)``, ``anchor
    (1, N, 4)`` -> ``(B, N, 6)`` rows, -1 where suppressed."""
    det = multibox_decode(cls_prob, loc_pred, anchor, clip, threshold,
                          background_id, variances)
    return box_nms.fn(det, overlap_thresh=nms_threshold,
                      valid_thresh=threshold, topk=nms_topk, coord_start=2,
                      score_index=1, id_index=0, background_id=-1,
                      force_suppress=force_suppress)


# ---- the RPN ---------------------------------------------------------------


def base_anchors(base_size, ratios, scales, dtype, device):
    """Faster R-CNN's anchors at one position, ratio-major then scale."""
    out = []
    cx = cy = (base_size - 1) / 2.0
    area = float(base_size * base_size)
    for r in ratios:
        ws = round((area / r) ** 0.5)
        hs = round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out.append([cx - (w - 1) / 2, cy - (h - 1) / 2,
                        cx + (w - 1) / 2, cy + (h - 1) / 2])
    return torch.tensor(out, dtype=torch.float64).to(dtype).to(device)


def _top_k(x, k):
    """``lax.top_k`` over a 1-D tensor: total order, ties the lower index
    first."""
    idx = _sort_idx(x, 0, descending=True, nan_last=False)[:k]
    return x[idx], idx


def proposal_candidates(score, deltas, im_info, base, stride, pre_nms,
                        min_size):
    """The RPN's rows before NMS: ``score (A, H, W)`` foreground
    probabilities and ``deltas (A*4, H, W)`` decoded, clipped to the image
    and filtered by ``min_size``, the top ``pre_nms`` as ``(k, 6)`` rows
    ``[0, score, x1, y1, x2, y2]`` (-1 where filtered)."""
    An, H, W = score.shape
    dt, dev = score.dtype, score.device
    sy = torch.arange(H, dtype=dt, device=dev) * stride
    sx = torch.arange(W, dtype=dt, device=dev) * stride
    shift = torch.stack(torch.broadcast_tensors(
        sx[None, :], sy[:, None], sx[None, :], sy[:, None]), -1)
    anchors = base[:, None, None, :] + shift[None]           # (A, H, W, 4)
    acx, acy, aw, ah = _center(anchors)
    d = deltas.reshape(An, 4, H, W)
    cx = d[:, 0] * aw + acx
    cy = d[:, 1] * ah + acy
    w = torch.exp(d[:, 2]) * aw
    h = torch.exp(d[:, 3]) * ah
    zero = _full(0.0, cx)
    xmax, ymax = im_info[1] - 1, im_info[0] - 1
    x1 = torch.minimum(torch.maximum(cx - (w - 1) / 2, zero), xmax)
    y1 = torch.minimum(torch.maximum(cy - (h - 1) / 2, zero), ymax)
    x2 = torch.minimum(torch.maximum(cx + (w - 1) / 2, zero), xmax)
    y2 = torch.minimum(torch.maximum(cy + (h - 1) / 2, zero), ymax)
    ms = min_size * im_info[2]
    ok = ((x2 - x1 + 1) >= ms) & ((y2 - y1 + 1) >= ms)
    flat_s = torch.where(ok, score, _full(-math.inf, score)).reshape(-1)
    flat_b = torch.stack([x1, y1, x2, y2], -1).reshape(-1, 4)
    k1 = min(pre_nms, flat_s.shape[0])
    top_s, idx = _top_k(flat_s, k1)
    det = torch.cat([torch.zeros((k1, 1), dtype=dt, device=dev),
                     top_s[:, None], flat_b[idx]], -1)
    return torch.where(torch.isfinite(top_s)[:, None], det, _full(-1.0, det))


def proposal_select(det, post_nms, nms_thresh):
    """NMS over :func:`proposal_candidates`' rows, then the top
    ``post_nms``: ``(boxes (post_nms, 4), scores (post_nms,))``, zero
    where suppressed."""
    k1 = det.shape[0]
    kept = box_nms.fn(det[None], overlap_thresh=nms_thresh,
                      valid_thresh=-1e30, topk=-1, coord_start=2,
                      score_index=1, id_index=-1)[0]
    ks = torch.where(kept[:, 1] > -1, kept[:, 1], _full(-math.inf, kept))
    fin_s, fidx = _top_k(ks, min(post_nms, k1))
    good = torch.isfinite(fin_s)
    return (torch.where(good[:, None], kept[fidx, 2:6], _full(0.0, kept)),
            torch.where(good, fin_s, _full(0.0, fin_s)))


def _proposals(cls_prob, bbox_pred, im_info, pre, post, threshold, min_size,
               scales, ratios, stride, iou_loss):
    if iou_loss:
        raise NotImplementedError("iou_loss decoding is not supported")
    Anum = len(scales) * len(ratios)
    base = base_anchors(stride, ratios, scales, cls_prob.dtype,
                        cls_prob.device)
    return [_proposal_one(cls_prob[b, Anum:], bbox_pred[b], im_info[b], base,
                          float(stride), int(pre), int(post),
                          float(threshold), float(min_size))
            for b in range(cls_prob.shape[0])]


def _proposal_one(score, deltas, im_info, base, stride, pre_nms, post_nms,
                  nms_thresh, min_size):
    return proposal_select(proposal_candidates(
        score, deltas, im_info, base, stride, pre_nms, min_size), post_nms,
        nms_thresh)


@register("_contrib_Proposal", aliases=("Proposal",), n_out=0)
def Proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """Batch 1: ``rois (post_nms, 5)`` ``[0, x1, y1, x2, y2]`` (and the
    scores ``(post_nms, 1)`` with ``output_score``)."""
    boxes, scores = _proposals(cls_prob[:1], bbox_pred[:1], im_info[:1],
                               rpn_pre_nms_top_n, rpn_post_nms_top_n,
                               threshold, rpn_min_size, scales, ratios,
                               feature_stride, iou_loss)[0]
    rois = torch.cat([torch.zeros((boxes.shape[0], 1), dtype=boxes.dtype,
                                  device=boxes.device), boxes], -1)
    return (rois, scores[:, None]) if output_score else (rois,)


@register("_contrib_MultiProposal", aliases=("MultiProposal",), n_out=0)
def MultiProposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                  scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                  feature_stride=16, output_score=False, iou_loss=False):
    """Every batch row: ``rois (B*post_nms, 5)``, the row in column 0."""
    per = _proposals(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                     rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                     ratios, feature_stride, iou_loss)
    boxes = torch.stack([p[0] for p in per])
    scores = torch.stack([p[1] for p in per])
    B, n = boxes.shape[:2]
    bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device) \
        .repeat_interleave(n)[:, None]
    rois = torch.cat([bidx, boxes.reshape(B * n, 4)], -1)
    return (rois, scores.reshape(B * n, 1)) if output_score else (rois,)


# ---- position-sensitive and rotated pooling --------------------------------


def _group_bins(p, g, device):
    gi = (torch.arange(p, device=device) * g) // p
    return gi[:, None] * g + gi[None, :]


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def PSROIPooling(data, rois, spatial_scale=1.0, output_dim=0, pooled_size=7,
                 group_size=0):
    """Bin ``(i, j)`` of the pooled ``p x p`` grid reads channel group
    ``(i*g//p, j*g//p)``; bins sampled on ROIAlign's 2x2 grid."""
    p = int(pooled_size)
    g = int(group_size) or p
    cdim = data.shape[1] // (g * g)
    pooled = roi_align.fn(data, rois, pooled_size=(p, p),
                          spatial_scale=float(spatial_scale), sample_ratio=2)
    grp = pooled.reshape(pooled.shape[0], cdim, g * g, p, p)
    bins = _group_bins(p, g, data.device)
    return torch.gather(grp, 2, bins.expand(grp.shape[0], cdim, 1, p, p))[
        :, :, 0]


def _sample_rois(data, bidx, xs, ys):
    """``data (N, C, H, W)`` sampled with zero padding at ``xs``, ``ys``
    ``(R, *S)`` of images ``bidx (R,)`` -> ``(R, C, *S)``."""
    N, C, H, W = data.shape
    flat = _channels_last(data)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    base = (bidx * H * W).reshape((-1,) + (1,) * (xs.dim() - 1))
    out = torch.zeros(tuple(xs.shape) + (C,), dtype=data.dtype,
                      device=data.device)
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xi, yi = x0 + dx, y0 + dy
            w = (1.0 - torch.abs(xs - xi)) * (1.0 - torch.abs(ys - yi))
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = base + torch.nan_to_num(torch.clamp(yi, 0, H - 1),
                                          nan=0.0).long() * W + \
                torch.nan_to_num(torch.clamp(xi, 0, W - 1), nan=0.0).long()
            w = torch.where(valid, w, _full(0.0, w))
            out = out + w[..., None] * flat[idx]
    return out.movedim(-1, 1)


@register("_contrib_RROIAlign", aliases=("RROIAlign",))
def RROIAlign(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sampling_ratio=2):
    """Rotated ROIAlign: ``rois (R, 6)`` ``[batch, cx, cy, w, h,
    degrees]``."""
    ph, pw = _pooled_size(pooled_size)
    sr = max(int(sampling_ratio), 1)
    dt, dev = data.dtype, data.device
    bidx = _jnp.clip_index(_jnp.astype(rois[:, 0], torch.int32),
                           data.shape[0])
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    w = torch.clamp_min(rois[:, 3] * spatial_scale, 1e-3)
    h = torch.clamp_min(rois[:, 4] * spatial_scale, 1e-3)
    th = rois[:, 5] * (math.pi / 180.0)
    yy = _div(torch.arange(ph * sr, dtype=dt, device=dev) + 0.5, ph * sr) \
        - 0.5
    xx = _div(torch.arange(pw * sr, dtype=dt, device=dev) + 0.5, pw * sr) \
        - 0.5
    gy = (yy[None, :] * h[:, None])[:, :, None].expand(-1, -1, pw * sr)
    gx = (xx[None, :] * w[:, None])[:, None, :].expand(-1, ph * sr, -1)
    ct, st = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    sx = cx[:, None, None] + gx * ct - gy * st
    sy = cy[:, None, None] + gx * st + gy * ct
    C = data.shape[1]
    out = []
    for a, b in _roi_blocks(rois.shape[0], C * ph * sr * pw * sr):
        val = _sample_rois(data, bidx[a:b], sx[a:b], sy[a:b])
        out.append(val.reshape(b - a, C, ph, sr, pw, sr).mean(dim=(3, 5)))
    return torch.cat(out) if out else torch.zeros((0, C, ph, pw), dtype=dt,
                                                  device=dev)


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), n_out=0)
def DeformablePSROIPooling(data, rois, trans=None, spatial_scale=1.0,
                           output_dim=0, group_size=1, pooled_size=7,
                           part_size=0, sample_per_part=2, trans_std=0.1,
                           no_trans=False):
    """Position-sensitive pooling whose bins shift by ``trans (R, 2*cls, p,
    p)`` times ``trans_std`` and the ROI's extent."""
    p = int(pooled_size)
    g = int(group_size) or p
    sr = max(int(sample_per_part), 1)
    N, C, H, W = data.shape
    cdim = C // (g * g)
    dt, dev = data.dtype, data.device
    R = rois.shape[0]
    bidx = _jnp.clip_index(_jnp.astype(rois[:, 0], torch.int32), N)
    x1 = torch.floor(rois[:, 1] + 0.5) * spatial_scale - 0.5
    y1 = torch.floor(rois[:, 2] + 0.5) * spatial_scale - 0.5
    w = torch.clamp_min((torch.floor(rois[:, 3] + 0.5) + 1.0) * spatial_scale
                        - 0.5 - x1, 0.1)
    h = torch.clamp_min((torch.floor(rois[:, 4] + 0.5) + 1.0) * spatial_scale
                        - 0.5 - y1, 0.1)
    bw, bh = _div(w, p), _div(h, p)
    iy = torch.arange(p, dtype=dt, device=dev)
    if no_trans or trans is None:
        offx = offy = torch.zeros((R, p, p), dtype=dt, device=dev)
    else:
        pt = trans.shape[-1]
        ti = torch.clamp(_jnp.astype(_div(iy * pt, p), torch.int32).long(),
                         0, pt - 1)
        offx = trans[:, 0][:, ti[:, None], ti[None, :]] * trans_std \
            * w[:, None, None]
        offy = trans[:, 1][:, ti[:, None], ti[None, :]] * trans_std \
            * h[:, None, None]
    s = _div(torch.arange(sr, dtype=dt, device=dev) + 0.5, sr)
    ys = y1[:, None, None, None, None] + (
        iy[:, None, None, None] + s[None, None, :, None]) \
        * bh[:, None, None, None, None] + offy[:, :, :, None, None]
    xs = x1[:, None, None, None, None] + (
        iy[None, :, None, None] + s[None, None, None, :]) \
        * bw[:, None, None, None, None] + offx[:, :, :, None, None]
    ys = torch.clamp(ys.expand(R, p, p, sr, sr), 0.0, H - 1.0)
    xs = torch.clamp(xs.expand(R, p, p, sr, sr), 0.0, W - 1.0)
    out = []
    for a, b in _roi_blocks(R, C * p * p * sr * sr):
        val = _sample_rois(data, bidx[a:b], xs[a:b], ys[a:b])
        val = val.reshape(b - a, C, p, p, sr * sr).mean(-1)
        grp = val.reshape(b - a, cdim, g * g, p, p)
        bins = _group_bins(p, g, dev)
        out.append(torch.gather(grp, 2, bins.expand(b - a, cdim, 1, p, p))[
            :, :, 0])
    return (torch.cat(out) if out else torch.zeros((0, cdim, p, p), dtype=dt,
                                                   device=dev),)


# ---- deformable convolution -----------------------------------------------


def _deform_conv(data, offset, mask, weight, bias, kernel, stride, pad,
                 dilate, num_group, num_deformable_group, no_bias):
    """K*K bilinear samples (times the mask for v2), then one product of
    the ``(C*K*K)`` columns with the weights."""
    B, C, H, W = data.shape
    O = weight.shape[0]
    KH, KW = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(pad[0]), int(pad[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    dg = int(num_deformable_group)
    if num_group != 1:
        raise NotImplementedError("num_group > 1 not supported")
    Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) // sw + 1
    off = offset.reshape(B, dg, KH * KW, 2, Ho, Wo)
    if mask is not None:
        mask = mask.reshape(B, dg, KH * KW, Ho, Wo)
    base_y = (torch.arange(Ho, dtype=data.dtype, device=data.device) * sh
              - ph)[:, None].expand(Ho, Wo)
    base_x = (torch.arange(Wo, dtype=data.dtype, device=data.device) * sw
              - pw)[None, :].expand(Ho, Wo)
    cg = C // dg
    cols = []
    for ky in range(KH):
        for kx in range(KW):
            tap = ky * KW + kx
            parts = []
            for g in range(dg):
                ys = base_y + ky * dh + off[:, g, tap, 0]
                xs = base_x + kx * dw + off[:, g, tap, 1]
                val = sample_bilinear(data[:, g * cg:(g + 1) * cg], xs, ys)
                if mask is not None:
                    val = val * mask[:, g, tap][:, None]
                parts.append(val)
            cols.append(torch.cat(parts, dim=1))
    col = torch.stack(cols, dim=2)                           # (B, C, KK, Ho, Wo)
    out = torch.einsum("bckhw,ock->bohw", col,
                       weight.reshape(O, C, KH * KW))
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def DeformableConvolution(data, offset, weight, bias=None, kernel=(3, 3),
                          stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                          num_filter=0, num_group=1, num_deformable_group=1,
                          no_bias=False, **_ignored):
    return _deform_conv(data, offset, None, weight, bias, kernel, stride, pad,
                        dilate, num_group, num_deformable_group, no_bias)


@register("_contrib_ModulatedDeformableConvolution",
          aliases=("ModulatedDeformableConvolution",))
def ModulatedDeformableConvolution(data, offset, mask, weight, bias=None,
                                   kernel=(3, 3), stride=(1, 1), pad=(0, 0),
                                   dilate=(1, 1), num_filter=0, num_group=1,
                                   num_deformable_group=1, no_bias=False,
                                   **_ignored):
    return _deform_conv(data, offset, mask, weight, bias, kernel, stride, pad,
                        dilate, num_group, num_deformable_group, no_bias)


@register("_contrib_mrcnn_mask_target", aliases=("mrcnn_mask_target",),
          n_out=2, differentiable=False)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets, num_rois=0,
                      num_classes=0, mask_size=(14, 14), sample_ratio=2):
    """Each roi's matched mask ROI-aligned to ``mask_size`` (zero outside
    ``[-1, H] x [-1, W]``) and a one-hot class volume: both ``(B, N, C,
    mh, mw)``."""
    B, N = rois.shape[:2]
    M, H, W = gt_masks.shape[1:]
    mh, mw = int(mask_size[0]), int(mask_size[1])
    C = int(num_classes)
    sr = int(sample_ratio)
    if sr <= 0:
        raise NotImplementedError(
            "sample_ratio=-1 (adaptive grid) is data-dependent; use a "
            "positive sampling ratio")
    dt, dev = rois.dtype, rois.device
    x1, y1, x2, y2 = (rois[..., i][..., None, None, None, None]
                      for i in range(4))
    bh = _div(torch.clamp_min(y2 - y1, 1.0), mh)
    bw = _div(torch.clamp_min(x2 - x1, 1.0), mw)
    py = torch.arange(mh, dtype=dt, device=dev)
    px = torch.arange(mw, dtype=dt, device=dev)
    s = _div(torch.arange(sr, dtype=dt, device=dev) + 0.5, sr)
    ys = (y1 + (py[:, None, None, None] + s[None, None, :, None]) * bh) \
        .expand(B, N, mh, mw, sr, sr)
    xs = (x1 + (px[None, :, None, None] + s[None, None, None, :]) * bw) \
        .expand(B, N, mh, mw, sr, sr)
    valid = (ys >= -1.0) & (ys <= H) & (xs >= -1.0) & (xs <= W)
    y = torch.clamp(ys, 0.0, H - 1.0)
    x = torch.clamp(xs, 0.0, W - 1.0)
    y0 = _jnp.astype(torch.floor(y), torch.int32).long()
    x0 = _jnp.astype(torch.floor(x), torch.int32).long()
    y1i = torch.clamp_max(y0 + 1, H - 1)
    x1i = torch.clamp_max(x0 + 1, W - 1)
    ly, lx = y - y0, x - x0
    flat = gt_masks.reshape(B, M * H * W)
    base = _jnp.clip_index(_jnp.astype(matches, torch.int32), M) \
        .reshape(B, N, 1, 1, 1, 1) * (H * W)

    def at(yi, xi):
        return torch.gather(flat, 1, (base + yi * W + xi).reshape(B, -1)) \
            .reshape(yi.shape)

    v = ((1 - ly) * (1 - lx) * at(y0, x0) + (1 - ly) * lx * at(y0, x1i)
         + ly * (1 - lx) * at(y1i, x0) + ly * lx * at(y1i, x1i))
    v = torch.where(valid, v, _full(0.0, v))
    sampled = v.reshape(B, N, mh, mw, sr * sr).mean(-1)
    mask_targets = sampled[:, :, None].expand(B, N, C, mh, mw)
    cls_ids = torch.arange(C, dtype=cls_targets.dtype, device=dev)
    onehot = (cls_targets[..., None] == cls_ids).to(gt_masks.dtype)
    return mask_targets, onehot[..., None, None].expand(B, N, C, mh, mw)
