"""``ops/proposal_ops.py`` of the port against the JAX package on the CPU:
``MultiBoxTarget``, ``MultiBoxDetection``, ``Proposal``, ``MultiProposal``,
``PSROIPooling``, ``RROIAlign``, ``DeformablePSROIPooling``, the
deformable convolutions (v1 and v2) and ``mrcnn_mask_target``, on the
same seeded numpy arrays (``_op_cases``).

Tolerances: ``MultiBoxTarget``'s class targets and every NMS keep set
(which rows are -1) bitwise; float outputs within 1e-5 of their largest
magnitude in float32, gradients alike (``jax.grad`` against autograd, the
same seeded cotangents).

The boxes that ``MultiBoxDetection`` and ``Proposal`` decode (with
``exp``, an ulp apart on the two sides) are drawn so that no IoU between
two of them lies within 1e-5 of the NMS threshold (``_op_cases.near``,
on a float64 replica of the decode): :data:`REDRAWN` counts the pairs
that were too near and redrawn, per op.
"""
import numpy as onp
import pytest

from _op_cases import (Case, assert_close, check, keep_rows, near,
                       near_pairs, reference_thunks)
from _parity import reference_results, result

RNG = onp.random.default_rng(19)
REDRAWN = {"multibox_detection": 0, "proposal": 0}
DET_THRESHOLD, RPN_THRESHOLD = 0.45, 0.7


def _f(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(onp.float32)


def _softmax(z, axis):
    e = onp.exp(z - z.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(onp.float32)


def _prior_boxes(h, w, sizes, ratios):
    """MultiBoxPrior's anchors (a float64 replica, for drawing inputs)."""
    cy = (onp.arange(h) + 0.5) / h
    cx = (onp.arange(w) + 0.5) / w
    whs = [(s * onp.sqrt(ratios[0]), s / onp.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * onp.sqrt(r), sizes[0] / onp.sqrt(r))
            for r in ratios[1:]]
    out = [[x - a / 2, y - b / 2, x + a / 2, y + b / 2]
           for y in cy for x in cx for a, b in whs]
    return onp.asarray(out, onp.float32)


MB_ANCHOR = _prior_boxes(4, 4, (0.3, 0.5), (1.0, 2.0, 0.5))[None]
MB_N = MB_ANCHOR.shape[1]
MB_LABEL = onp.array([[[1, 0.1, 0.1, 0.45, 0.5], [0, 0.5, 0.55, 0.9, 0.95],
                       [-1, 0, 0, 0, 0]],
                      [[2, 0.3, 0.2, 0.7, 0.6], [-1, 0, 0, 0, 0],
                       [-1, 0, 0, 0, 0]]], onp.float32)
MB_PRED = _softmax(_f(2, 4, MB_N), 1)


def _decode_det(loc):
    """MultiBoxDetection's boxes before NMS (a float64 replica)."""
    a = MB_ANCHOR[0].astype(onp.float64)
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    acx, acy = a[:, 0] + aw / 2, a[:, 1] + ah / 2
    p = loc.reshape(MB_N, 4).astype(onp.float64)
    cx, cy = p[:, 0] * 0.1 * aw + acx, p[:, 1] * 0.1 * ah + acy
    w, h = onp.exp(p[:, 2] * 0.2) * aw, onp.exp(p[:, 3] * 0.2) * ah
    return onp.clip(onp.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                               cy + h / 2], -1), 0, 1)


def _det_loc():
    loc = _f(2, MB_N * 4, scale=0.5)
    for b in range(2):
        while True:
            boxes = _decode_det(loc[b])
            bad = near(boxes, DET_THRESHOLD)
            if not len(bad):
                break
            REDRAWN["multibox_detection"] += len(
                near_pairs(boxes, DET_THRESHOLD)[0])
            for j in bad:
                loc[b, 4 * j:4 * j + 4] = _f(4, scale=0.5)
    return loc


MB_LOC = _det_loc()
RPN_A, RPN_H, RPN_W, RPN_S = 12, 5, 7, 16
RPN_INFO = onp.array([[RPN_H * RPN_S, RPN_W * RPN_S, 1.0],
                      [RPN_H * RPN_S - 10, RPN_W * RPN_S, 0.8]], onp.float32)


def _rpn_boxes(deltas, info):
    """Proposal's clipped boxes (a float64 replica, for drawing inputs)."""
    base = []
    for r in (0.5, 1, 2):
        ws = round((256.0 / r) ** 0.5)
        hs = round(ws * r)
        for s in (4, 8, 16, 32):
            w, h = ws * s, hs * s
            base.append([7.5 - (w - 1) / 2, 7.5 - (h - 1) / 2,
                         7.5 + (w - 1) / 2, 7.5 + (h - 1) / 2])
    base = onp.asarray(base)
    sy, sx = onp.meshgrid(onp.arange(RPN_H) * RPN_S,
                          onp.arange(RPN_W) * RPN_S, indexing="ij")
    anc = base[:, None, None, :] + onp.stack([sx, sy, sx, sy], -1)[None]
    aw, ah = anc[..., 2] - anc[..., 0], anc[..., 3] - anc[..., 1]
    acx, acy = anc[..., 0] + aw / 2, anc[..., 1] + ah / 2
    d = deltas.reshape(RPN_A, 4, RPN_H, RPN_W).astype(onp.float64)
    cx, cy = d[:, 0] * aw + acx, d[:, 1] * ah + acy
    w, h = onp.exp(d[:, 2]) * aw, onp.exp(d[:, 3]) * ah
    x1 = onp.clip(cx - (w - 1) / 2, 0, info[1] - 1)
    y1 = onp.clip(cy - (h - 1) / 2, 0, info[0] - 1)
    x2 = onp.clip(cx + (w - 1) / 2, 0, info[1] - 1)
    y2 = onp.clip(cy + (h - 1) / 2, 0, info[0] - 1)
    return onp.stack([x1, y1, x2, y2], -1).reshape(-1, 4)


def _rpn_inputs(B):
    prob = RNG.uniform(0, 1, (B, 2 * RPN_A, RPN_H, RPN_W)).astype(onp.float32)
    deltas = _f(B, 4 * RPN_A, RPN_H, RPN_W, scale=0.2)
    for b in range(B):
        while True:
            boxes = _rpn_boxes(deltas[b], RPN_INFO[b])
            bad = near(boxes, RPN_THRESHOLD)
            if not len(bad):
                break
            REDRAWN["proposal"] += len(near_pairs(boxes, RPN_THRESHOLD)[0])
            a, hw = onp.divmod(bad, RPN_H * RPN_W)
            y, x = onp.divmod(hw, RPN_W)
            for k in range(len(bad)):
                deltas[b, 4 * a[k]:4 * a[k] + 4, y[k], x[k]] = _f(
                    4, scale=0.2)
    return prob, deltas


RPN_PROB, RPN_DELTA = _rpn_inputs(2)
ROI_X = _f(2, 18, 12, 14)
ROIS = onp.array([[0, 1.3, 2.2, 9.7, 8.1], [1, 0.4, 0.6, 13.2, 11.5],
                  [1, 6.1, 3.3, 6.9, 4.2], [0, -3.0, -2.0, 4.5, 5.5],
                  [1, 10.2, 7.7, 20.0, 16.0]], onp.float32)
RROIS = onp.array([[0, 6.5, 5.2, 6.0, 4.0, 30.0],
                   [1, 3.3, 8.1, 5.5, 3.0, -65.0],
                   [0, 10.0, 2.0, 9.0, 5.0, 120.0]], onp.float32)
TRANS = _f(5, 2, 3, 3, scale=0.5)
DC_X = _f(1, 4, 5, 6)
DC_OFF = _f(1, 2 * 6, 5, 5, scale=0.7)
DC_W, DC_B = _f(3, 4, 3, 2, scale=0.3), _f(3)
MDC_W = _f(3, 4, 1, 2, scale=0.3)
MDC_OFF = _f(1, 2 * 2 * 2, 4, 4, scale=0.7)
MDC_MASK = RNG.uniform(0, 1, (1, 2 * 2, 4, 4)).astype(onp.float32)
MASKS = (RNG.uniform(0, 1, (2, 2, 8, 8)) > 0.5).astype(onp.float32)
MR_ROIS = onp.array([[[0.5, 1.0, 6.5, 7.0], [2.0, 0.0, 9.0, 5.5],
                      [-1.0, 3.0, 4.0, 8.5]],
                     [[1.0, 1.0, 3.0, 3.0], [0.0, 0.0, 8.0, 8.0],
                      [4.2, 2.2, 7.9, 9.1]]], onp.float32)

CASES = {
    "multibox_target": Case("_contrib_MultiBoxTarget",
                            [MB_ANCHOR, MB_LABEL, MB_PRED],
                            {"negative_mining_ratio": 3.0,
                             "negative_mining_thresh": 0.3}),
    "multibox_target_plain": Case("_npx_multibox_target",
                                  [MB_ANCHOR, MB_LABEL, MB_PRED],
                                  {"overlap_threshold": 0.3}),
    "multibox_detection": Case("_contrib_MultiBoxDetection",
                               [MB_PRED, MB_LOC, MB_ANCHOR],
                               {"nms_threshold": DET_THRESHOLD,
                                "nms_topk": 30}),
    "multibox_detection_force": Case("_npx_multibox_detection",
                                     [MB_PRED, MB_LOC, MB_ANCHOR],
                                     {"nms_threshold": DET_THRESHOLD,
                                      "force_suppress": True,
                                      "threshold": 0.3}),
    "proposal": Case("_contrib_Proposal", [RPN_PROB[:1], RPN_DELTA[:1],
                                           RPN_INFO[:1]],
                     {"rpn_pre_nms_top_n": 120, "rpn_post_nms_top_n": 30,
                      "threshold": RPN_THRESHOLD, "output_score": True}),
    "multi_proposal": Case("MultiProposal", [RPN_PROB, RPN_DELTA, RPN_INFO],
                           {"rpn_pre_nms_top_n": 80,
                            "rpn_post_nms_top_n": 20,
                            "threshold": RPN_THRESHOLD, "rpn_min_size": 8}),
    "psroi_pooling": Case("_contrib_PSROIPooling", [ROI_X, ROIS],
                          {"spatial_scale": 0.9, "output_dim": 2,
                           "pooled_size": 3}, grad=(0,)),
    "rroi_align": Case("RROIAlign", [ROI_X[:, :4], RROIS],
                       {"pooled_size": (2, 3), "sampling_ratio": 2},
                       grad=(0,)),
    "deformable_psroi": Case("_contrib_DeformablePSROIPooling",
                             [ROI_X, ROIS, TRANS],
                             {"spatial_scale": 0.7, "output_dim": 2,
                              "group_size": 3, "pooled_size": 3,
                              "trans_std": 0.2}, grad=(0, 2)),
    "deformable_psroi_no_trans": Case("DeformablePSROIPooling",
                                      [ROI_X, ROIS],
                                      {"output_dim": 2, "group_size": 3,
                                       "pooled_size": 3, "no_trans": True},
                                      grad=(0,)),
    "deformable_conv": Case("_contrib_DeformableConvolution",
                            [DC_X, DC_OFF, DC_W, DC_B],
                            {"kernel": (3, 2), "pad": (1, 0),
                             "num_filter": 3}, grad=(0, 1, 2, 3)),
    "modulated_deformable_conv": Case(
        "ModulatedDeformableConvolution",
        [DC_X, MDC_OFF, MDC_MASK, MDC_W],
        {"kernel": (1, 2), "stride": (2, 1), "dilate": (1, 2),
         "pad": (1, 0), "num_filter": 3, "num_deformable_group": 2,
         "no_bias": True}, grad=(1, 2)),
    "mrcnn_mask_target": Case("_contrib_mrcnn_mask_target",
                              [MR_ROIS, MASKS,
                               onp.array([[0, 1, 1], [1, 0, 7]], onp.float32),
                               onp.array([[1, 0, 2], [2, 2, 1]],
                                         onp.float32)],
                              {"num_classes": 3, "mask_size": (4, 5)}),
}


@pytest.fixture(scope="module")
def ref():
    return reference_results(reference_thunks(CASES), chunk=4, probe=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(ref, name):
    got, want = check(CASES[name], result(ref, name), name)
    if name.startswith("multibox_detection"):
        onp.testing.assert_array_equal(keep_rows(got), keep_rows(want),
                                       err_msg=name)
    if name.startswith("multibox_target"):
        assert_close(got[2], want[2], "exact", name + " cls")
    if "proposal" in name:       # the kept rows: nonzero boxes
        rows = onp.asarray(want[0])[:, 1:]
        assert_close(got[0][:, 1:] != 0, rows != 0, "exact", name + " kept")


def test_decoded_boxes_keep_clear_of_the_thresholds():
    """No decoded IoU within 1e-5 of the NMS threshold (redrawn pairs
    counted), and the ops keep some rows and drop others."""
    for b in range(2):
        assert len(near(_decode_det(MB_LOC[b]), DET_THRESHOLD)) == 0
        assert len(near(_rpn_boxes(RPN_DELTA[b], RPN_INFO[b]),
                        RPN_THRESHOLD)) == 0
    assert min(REDRAWN.values()) >= 0
    from _op_cases import port_forward
    keep = keep_rows(port_forward(CASES["multibox_detection"]))
    assert 0 < keep.sum() < keep.size
