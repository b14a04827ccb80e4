"""Detection operators: counterpart of ``mxnet_tpu/ops/detection_ops.py``.

``box_iou``, ``box_nms`` (alias ``box_non_maximum_suppression``),
``bipartite_matching``, ``box_encode``/``box_decode``, ``MultiBoxPrior``,
``ROIAlign``, ``BilinearResize2D``, ``AdaptiveAvgPooling2D``,
``boolean_mask`` and ``allclose``, as the reference computes them:

- **NMS.** Entries sort by score, descending and stable (invalid ones last,
  keyed ``+inf``), in the total order of the reference's sort, so ties keep
  index order. The IoU is the reference's ``_iou_corner``, op for op, so
  the keep set is the same set. Suppressed and invalid rows become -1; the
  output keeps the input's shape. The greedy sweep is not a loop over the
  rows: the keep set is the unique fixed point of ``keep = valid and not
  (some kept earlier row suppresses it)``, reached by iterating that rule
  from ``keep = valid`` (after t rounds the first t rows are final), one
  batched matrix product a round, until a round changes nothing. Rows past
  ``topk`` cannot be kept and cannot suppress, so the matrix holds only
  the first ``min(n, topk)`` sorted rows; it is built for as many images
  at a time as fit in :data:`NMS_BLOCK_BYTES`.
- **ROIAlign** follows the reference where it departs from MXNet 1.6:
  ``sample_ratio <= 0`` samples a fixed 2x2 grid a bin; ``aligned``
  shifts by half a pixel; ``position_sensitive`` takes channel
  ``c * ph * pw + iy * pw + ix`` for bin ``(c, iy, ix)``.
- **Resize and pooling**: ``BilinearResize2D`` is ``jax.image.resize``'s
  linear resize (antialiased when it shrinks, ``image_ops.resize_linear``);
  ``AdaptiveAvgPooling2D`` differences an integral image summed in XLA's
  order (``core.cumsum``).
- ``boolean_mask`` has a value-dependent shape: it runs eagerly and raises
  inside a ``CachedOp`` capture.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import _jnp
from .core import _block_scan, _sort_idx
from .image_ops import resize_linear
from .numpy_ops import eager_only
from .registry import register

__all__ = ["box_iou", "box_nms", "bipartite_matching", "box_encode",
           "box_decode", "multibox_prior", "roi_align",
           "bilinear_resize_2d", "adaptive_avg_pooling_2d", "boolean_mask",
           "allclose", "iou_corner", "nms_keep", "NMS_BLOCK_BYTES"]

_MIN = -3.4e38
NMS_BLOCK_BYTES = 1 << 30     # the suppression matrices built at once
NMS_CHECK_EVERY = 4           # fixed-point rounds between convergence checks


def _to_corner(b, fmt):
    if fmt == "corner":
        return b
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _from_corner(b, fmt):
    if fmt == "corner":
        return b
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def iou_corner(a, b):
    """``a (..., N, 4)``, ``b (..., M, 4)`` corner boxes -> ``(..., N, M)``
    IoU, op for op as the reference's ``_iou_corner``."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0.0) * \
        torch.clamp_min(a[..., 3] - a[..., 1], 0.0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0.0) * \
        torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union,
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    return iou_corner(_to_corner(lhs, format), _to_corner(rhs, format))


def _suppression(boxes, ids, overlap_thresh):
    """``(b, m, m)`` 1/0: row i suppresses a later row j."""
    m = boxes.shape[1]
    s = iou_corner(boxes, boxes) > overlap_thresh
    if ids is not None:
        s = s & (ids[:, :, None] == ids[:, None, :])
    later = torch.ones((m, m), dtype=torch.bool, device=boxes.device).triu(1)
    return (s & later).to(boxes.dtype if boxes.is_floating_point()
                          else torch.float32)


def nms_keep(boxes, valid, ids, overlap_thresh):
    """The greedy keep set over sorted rows: ``boxes (b, m, 4)`` corner,
    ``valid (b, m)``, ``ids (b, m)`` or None (every row one class). See the
    module's text for the fixed-point sweep."""
    b, m = valid.shape
    keep = torch.zeros_like(valid)
    per = max(1, NMS_BLOCK_BYTES // max(1, 4 * m * m))
    for s in range(0, b, per):
        e = min(b, s + per)
        sup = _suppression(boxes[s:e], None if ids is None else ids[s:e],
                           overlap_thresh)
        v = valid[s:e]
        k = v
        for rnd in range(m + 1):
            hit = torch.matmul(k.to(sup.dtype)[:, None, :], sup)[:, 0] > 0
            new = v & ~hit
            if (rnd + 1) % NMS_CHECK_EVERY == 0 or rnd == m:
                if torch.equal(new, k):
                    break
            k = new
        keep[s:e] = k
    return keep


@register("_contrib_box_nms", aliases=("box_nms",
                                       "_contrib_box_non_maximum_suppression"))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS over each batch row of ``data (..., N, K)``: rows sorted
    by score, suppressed and invalid ones -1."""
    shape = data.shape
    n, k = shape[-2], shape[-1]
    flat = data.reshape(-1, n, k)
    scores = flat[:, :, score_index]
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (flat[:, :, id_index] != background_id)
    inf = torch.full((), float("inf"), dtype=scores.dtype,
                     device=scores.device)
    order = _sort_idx(torch.where(valid, -scores, inf), 1)
    sorted_b = torch.gather(flat, 1, order[:, :, None].expand(-1, -1, k))
    sorted_valid = torch.gather(valid, 1, order)
    m = n if topk <= 0 else min(int(topk), n)
    boxes = _to_corner(sorted_b[:, :, coord_start:coord_start + 4], in_format)
    ids = None if (force_suppress or id_index < 0) else \
        sorted_b[:, :m, id_index]
    keep = torch.zeros_like(sorted_valid)
    keep[:, :m] = nms_keep(boxes[:, :m], sorted_valid[:, :m], ids,
                           overlap_thresh)
    out_b = sorted_b
    if out_format != in_format:
        out_b = out_b.clone()
        out_b[:, :, coord_start:coord_start + 4] = _from_corner(boxes,
                                                                out_format)
    out = torch.where(keep[:, :, None], out_b,
                      torch.full((), -1.0, dtype=out_b.dtype,
                                 device=out_b.device))
    return out.reshape(shape)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          n_out=2)
def bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy matching on ``(..., N, M)`` scores: ``(row -> col (..., N),
    col -> row (..., M))``, -1 unmatched."""
    shape = data.shape
    n, m = shape[-2], shape[-1]
    work = data.reshape(-1, n, m).clone()
    if is_ascend:
        work = -work
    thr = -threshold if is_ascend else threshold
    B = work.shape[0]
    rows = torch.full((B, n), -1.0, dtype=data.dtype, device=data.device)
    cols = torch.full((B, m), -1.0, dtype=data.dtype, device=data.device)
    bi = torch.arange(B, device=data.device)
    lowest = torch.full((), _MIN, dtype=work.dtype, device=work.device)
    for _ in range(n if topk <= 0 else min(int(topk), n)):
        idx = torch.argmax(work.reshape(B, -1), dim=1)
        i, j = idx // m, idx % m
        ok = work[bi, i, j] >= thr
        rows[bi, i] = torch.where(ok, j.to(rows.dtype), rows[bi, i])
        cols[bi, j] = torch.where(ok, i.to(cols.dtype), cols[bi, j])
        hit_r = ok[:, None] & (torch.arange(n, device=data.device) == i[:, None])
        hit_c = ok[:, None] & (torch.arange(m, device=data.device) == j[:, None])
        work = torch.where(hit_r[:, :, None] | hit_c[:, None, :], lowest, work)
    return rows.reshape(shape[:-1]), cols.reshape(shape[:-2] + (m,))


@register("_contrib_box_encode", aliases=("box_encode",))
def box_encode(samples, matches, anchors, refs, means=(0.0, 0.0, 0.0, 0.0),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD target encoding: ``(targets, masks)``."""
    shape4 = tuple(matches.shape) + (4,)
    idx = torch.clamp_min(matches, 0).long()[..., None].expand(shape4)
    matched = torch.gather(refs, 1, idx)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = matched[..., 2] - matched[..., 0]
    gh = matched[..., 3] - matched[..., 1]
    gx = (matched[..., 0] + matched[..., 2]) / 2
    gy = (matched[..., 1] + matched[..., 3]) / 2
    dt, dev = anchors.dtype, anchors.device
    means = torch.tensor(means, dtype=dt, device=dev)
    stds = torch.tensor(stds, dtype=dt, device=dev)
    t = torch.stack([(gx - ax) / torch.clamp_min(aw, 1e-12),
                     (gy - ay) / torch.clamp_min(ah, 1e-12),
                     torch.log(torch.clamp_min(gw, 1e-12) /
                               torch.clamp_min(aw, 1e-12)),
                     torch.log(torch.clamp_min(gh, 1e-12) /
                               torch.clamp_min(ah, 1e-12))], dim=-1)
    t = (t - means) / stds
    mask = (samples > 0.5).to(dt)[..., None]
    return t * mask, mask.expand(shape4).to(dt)


@register("_contrib_box_decode", aliases=("box_decode",))
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    a = _to_corner(anchors, format)
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    ax = (a[..., 0] + a[..., 2]) / 2
    ay = (a[..., 1] + a[..., 3]) / 2
    dx = data[..., 0] * std0 * aw + ax
    dy = data[..., 1] * std1 * ah + ay
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = torch.clamp_max(dw, clip)
        dh = torch.clamp_max(dh, clip)
    dw = torch.exp(dw) * aw / 2
    dh = torch.exp(dh) * ah / 2
    return torch.stack([dx - dw, dy - dh, dx + dw, dy + dh], dim=-1)


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",
                                             "multibox_prior",
                                             "_npx_multibox_prior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), steps=(-1.0, -1.0),
                   offsets=(0.5, 0.5), clip=False):
    """Anchors over ``data``'s ``(H, W)`` grid: ``(1, H*W*A, 4)``, ``A =
    len(sizes) + len(ratios) - 1``."""
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    sizes, ratios = list(sizes), list(ratios)
    whs = [(s * _np.sqrt(ratios[0]), s / _np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * _np.sqrt(r), sizes[0] / _np.sqrt(r))
            for r in ratios[1:]]
    whs = torch.tensor(_np.asarray(whs, _np.float32), device=dev)
    a = whs.shape[0]
    cxg = cx[None, :, None].expand(h, w, a)
    cyg = cy[:, None, None].expand(h, w, a)
    wg, hg = whs[:, 0].expand(h, w, a), whs[:, 1].expand(h, w, a)
    boxes = torch.stack([cxg - wg / 2, cyg - hg / 2,
                         cxg + wg / 2, cyg + hg / 2], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.reshape(1, h * w * a, 4)


ROI_BLOCK = 1 << 27           # gathered values a block of rois may hold


def _div(x, n):
    """``x / n`` for a Python number ``n``, as the CPU rounds it (on the
    card a division by a Python scalar multiplies by its reciprocal)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _channels_last(data):
    N, C, H, W = data.shape
    return data.permute(0, 2, 3, 1).reshape(N * H * W, C)


def _roi_blocks(R, per_roi):
    step = max(1, ROI_BLOCK // max(1, per_roi))
    return [(s, min(R, s + step)) for s in range(0, R, step)]


def _pooled_size(pooled_size):
    if isinstance(pooled_size, (tuple, list)):
        return int(pooled_size[0]), int(pooled_size[1])
    return int(pooled_size), int(pooled_size)


@register("_contrib_ROIAlign", aliases=("ROIAlign", "roi_align"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear ROI pooling: ``data (N, C, H, W)``, ``rois (R, 5)`` rows
    ``[batch, x1, y1, x2, y2]`` -> ``(R, C, ph, pw)`` (``(R, C/(ph*pw), ph,
    pw)`` when ``position_sensitive``)."""
    ph, pw = _pooled_size(pooled_size)
    n, c, hh, ww = data.shape
    sr = int(sample_ratio) if int(sample_ratio) > 0 else 2
    offset = 0.5 if aligned else 0.0
    if position_sensitive and c % (ph * pw) != 0:
        raise ValueError(
            "position_sensitive ROIAlign needs channels %% (ph*pw) == 0, "
            "got C=%d for pooled %dx%d" % (c, ph, pw))
    dt, dev = data.dtype, data.device
    bidx = _jnp.clip_index(_jnp.astype(rois[:, 0], torch.int32), n)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    floor_ = 1.0 if not aligned else 1e-6
    bw = _div(torch.clamp_min(x2 - x1, floor_), pw)
    bh = _div(torch.clamp_min(y2 - y1, floor_), ph)
    iy = torch.arange(ph, dtype=dt, device=dev)
    ix = torch.arange(pw, dtype=dt, device=dev)
    s = _div(torch.arange(sr, dtype=dt, device=dev) + 0.5, sr)
    ys = y1[:, None, None] + (iy[:, None] + s[None, :]) * bh[:, None, None]
    xs = x1[:, None, None] + (ix[:, None] + s[None, :]) * bw[:, None, None]
    ys = torch.clamp(ys, 0.0, hh - 1.0)          # (R, ph, sr)
    xs = torch.clamp(xs, 0.0, ww - 1.0)          # (R, pw, sr)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    y0i, x0i = _jnp.astype(y0, torch.int32).long(), \
        _jnp.astype(x0, torch.int32).long()
    y1i = torch.clamp_max(y0i + 1, hh - 1)
    x1i = torch.clamp_max(x0i + 1, ww - 1)
    flat = _channels_last(data)
    base = (bidx * hh * ww)[:, None, None, None, None]
    wy1b = wy1[:, :, :, None, None, None]
    wx1b = wx1[:, None, None, :, :, None]

    def gather(yi, xi, sl):
        idx = base[sl] + yi[sl][:, :, :, None, None] * ww + \
            xi[sl][:, None, None, :, :]
        return flat[idx]                          # (r, ph, sr, pw, sr, C)

    parts = []
    for a, b in _roi_blocks(rois.shape[0], ph * sr * pw * sr * c):
        sl = slice(a, b)
        wy, wx = wy1b[sl], wx1b[sl]
        val = (gather(y0i, x0i, sl) * (1 - wy) * (1 - wx)
               + gather(y0i, x1i, sl) * (1 - wy) * wx
               + gather(y1i, x0i, sl) * wy * (1 - wx)
               + gather(y1i, x1i, sl) * wy * wx)
        parts.append(val.mean(dim=(2, 4)).permute(0, 3, 1, 2))
    pooled = torch.cat(parts) if parts else torch.zeros(
        (0, c, ph, pw), dtype=dt, device=dev)
    if position_sensitive:
        c_out = c // (ph * pw)
        grp = pooled.reshape(-1, c_out, ph * pw, ph, pw)
        bins = (torch.arange(ph, device=dev)[:, None] * pw
                + torch.arange(pw, device=dev)[None, :])
        pooled = torch.gather(grp, 2, bins.expand(
            grp.shape[0], c_out, 1, ph, pw))[:, :, 0]
    return pooled


@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",
                                                "bilinear_resize_2d"))
def bilinear_resize_2d(data, height=None, width=None, scale_height=None,
                       scale_width=None, like=None, mode="size"):
    n, c, h, w = data.shape
    if like is not None or mode == "like":
        if like is None:
            raise ValueError("mode='like' requires the `like` tensor")
        height, width = like.shape[-2], like.shape[-1]
    elif height is None:
        if scale_height is None:
            raise ValueError("BilinearResize2D needs height/width, "
                             "scale_height/scale_width, or like=")
        height = int(round(h * scale_height))
        width = int(round(w * (scale_width if scale_width is not None
                               else scale_height)))
    elif width is None:
        raise ValueError("BilinearResize2D: height given without width")
    return resize_linear(data, (n, c, int(height), int(width)))


@register("_contrib_AdaptiveAvgPooling2D",
          aliases=("AdaptiveAvgPooling2D", "adaptive_avg_pool2d"))
def adaptive_avg_pooling_2d(data, output_size=(1, 1)):
    """Variable-window average pooling (torch's windows) from an integral
    image."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = data.shape
    if (oh, ow) == (1, 1):
        return data.mean(dim=(2, 3), keepdim=True)
    ii = torch.nn.functional.pad(
        _block_scan(_block_scan(data.float(), 2), 3), (1, 0, 1, 0))
    ys = (_np.arange(oh) * h) // oh
    ye = -(-(_np.arange(1, oh + 1) * h) // oh)
    xs = (_np.arange(ow) * w) // ow
    xe = -(-(_np.arange(1, ow + 1) * w) // ow)

    def at(r, q):
        return ii[:, :, torch.as_tensor(r, device=data.device)[:, None],
                  torch.as_tensor(q, device=data.device)[None, :]]

    out = at(ye, xe) - at(ys, xe) - at(ye, xs) + at(ys, xs)
    areas = torch.as_tensor(((ye - ys)[:, None] * (xe - xs)[None, :])
                            .astype(_np.float32), device=data.device)
    return (out / areas).to(data.dtype)


@register("_contrib_boolean_mask", aliases=("boolean_mask",),
          differentiable=False)
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero."""
    eager_only("boolean_mask")
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


@register("_contrib_allclose", aliases=("allclose",))
def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    """A 0-d float32 1/0."""
    dt = _jnp.result_dtype("promote", a, b)
    return torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all().to(torch.float32)
