"""``ops/detection_ops.py`` of the port against the JAX package on the CPU:
``box_iou``, ``box_nms``, ``bipartite_matching``, ``box_encode``/
``box_decode``, ``MultiBoxPrior``, ``ROIAlign``, ``BilinearResize2D``,
``AdaptiveAvgPooling2D``, ``boolean_mask`` and ``allclose``, on the same
seeded numpy arrays (``_op_cases``; the proposal family is in
``test_torch_proposal_ops.py``).

Tolerances: the priors, ``boolean_mask``, ``allclose``, the matchings and
every NMS output bitwise (its keep set, which rows are -1, checked on its
own too); float outputs within 1e-5 of their largest magnitude in
float32, gradients alike (``jax.grad`` against autograd, the same seeded
cotangents).

NMS boxes are drawn so that no IoU between two of them lies within 1e-5
of an overlap threshold the cases use (``_op_cases.near``): :data:`REDRAWN`
counts the pairs that were too near and redrawn.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import detection_ops as det

from _op_cases import (Case, check, iou64, keep_rows, near, near_pairs,
                       port_forward, reference_thunks)
from _parity import reference_results, result

RNG = onp.random.default_rng(18)
REDRAWN = {"box_nms": 0}
THRESHOLDS = (0.5, 0.3)


def _f(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(onp.float32)


def _boxes(n, thr=()):
    """``n`` corner boxes in the unit square, redrawn away from each
    threshold in ``thr``."""
    def draw(k):
        c = RNG.uniform(0, 1, (k, 2))
        wh = RNG.uniform(0.05, 0.4, (k, 2))
        return onp.concatenate([c - wh / 2, c + wh / 2], 1).astype(
            onp.float32)
    b = draw(n)
    for t in thr:
        while True:
            bad = near(b, t)
            if not len(bad):
                break
            REDRAWN["box_nms"] += len(near_pairs(b, t)[0])
            b[bad] = draw(len(bad))
    return b


def _nms_data(B, n):
    rows = []
    for _ in range(B):
        boxes = _boxes(n, THRESHOLDS)
        ids = RNG.integers(0, 3, (n, 1)).astype(onp.float32)
        scores = onp.round(RNG.uniform(0, 1, (n, 1)), 1).astype(onp.float32)
        rows.append(onp.concatenate([ids, scores, boxes], 1))
    return onp.stack(rows)


NMS = _nms_data(2, 40)          # scores rounded to 0.1: many ties
NMS_C = NMS.copy()
NMS_C[..., 2:4] = (NMS[..., 2:4] + NMS[..., 4:6]) / 2
NMS_C[..., 4:6] = NMS[..., 4:6] - NMS[..., 2:4]
MATCH = RNG.uniform(0, 1, (2, 5, 7)).astype(onp.float32)
ANC = _boxes(12)[None].repeat(2, 0)
REFS = _boxes(4)[None].repeat(2, 0)
SAMPLES = RNG.integers(-1, 2, (2, 12)).astype(onp.float32)
MATCHES = RNG.integers(-1, 4, (2, 12)).astype(onp.float32)
ROI_X = _f(2, 18, 12, 14)
ROIS = onp.array([[0, 1.3, 2.2, 9.7, 8.1], [1, 0.4, 0.6, 13.2, 11.5],
                  [1, 6.1, 3.3, 6.9, 4.2], [0, -3.0, -2.0, 4.5, 5.5],
                  [1, 10.2, 7.7, 20.0, 16.0]], onp.float32)

NMS_KW = {"overlap_thresh": 0.5, "valid_thresh": 0.15}
CASES = {
    "box_iou": Case("_contrib_box_iou", [ANC[0], REFS[0]], grad=(0, 1)),
    "box_iou_center": Case("box_iou", [NMS_C[0, :, 2:], NMS_C[1, :5, 2:]],
                           {"format": "center"}, grad=(0,)),
    "box_nms": Case("_contrib_box_nms", [NMS], NMS_KW, tol="exact",
                    grad=(0,)),
    "box_nms_class": Case("box_nms", [NMS],
                          dict(NMS_KW, id_index=0, background_id=0, topk=15),
                          tol="exact"),
    "box_nms_force": Case("_contrib_box_non_maximum_suppression", [NMS],
                          {"overlap_thresh": 0.3, "id_index": 0,
                           "force_suppress": True}, tol="exact"),
    "box_nms_center": Case("box_nms", [NMS_C],
                           dict(NMS_KW, in_format="center",
                                out_format="corner"), tol="exact"),
    "bipartite": Case("_contrib_bipartite_matching", [MATCH],
                      {"threshold": 0.3}, tol="exact"),
    "bipartite_ascend": Case("bipartite_matching", [MATCH],
                             {"is_ascend": True, "threshold": 0.7,
                              "topk": 3}, tol="exact"),
    "box_encode": Case("_contrib_box_encode",
                       [SAMPLES, MATCHES, ANC, REFS], grad=(2, 3)),
    "box_decode": Case("box_decode", [_f(2, 12, 4, scale=0.3), ANC],
                       {"clip": 0.5}, grad=(0, 1)),
    "box_decode_center": Case("_contrib_box_decode",
                              [_f(1, 40, 4, scale=0.3), NMS_C[:1, :, 2:]],
                              {"format": "center"}, grad=(0,)),
    "multibox_prior": Case("_contrib_MultiBoxPrior", [_f(1, 3, 5, 6)],
                           {"sizes": (0.2, 0.45), "ratios": (1, 2, 0.5)},
                           tol="exact"),
    "multibox_prior_steps": Case("_npx_multibox_prior", [_f(1, 3, 3, 4)],
                                 {"sizes": (0.7,), "ratios": (1, 3),
                                  "steps": (0.3, 0.25),
                                  "offsets": (0.4, 0.6), "clip": True},
                                 tol="exact"),
    "roi_align": Case("_contrib_ROIAlign", [ROI_X, ROIS],
                      {"pooled_size": (3, 4), "spatial_scale": 0.8},
                      grad=(0,)),
    "roi_align_aligned": Case("ROIAlign", [ROI_X, ROIS],
                              {"pooled_size": (2, 2), "sample_ratio": 0,
                               "aligned": True}, grad=(0,)),
    "roi_align_ps": Case("roi_align", [ROI_X, ROIS],
                         {"pooled_size": 3, "sample_ratio": 3,
                          "position_sensitive": True}, grad=(0,)),
    "resize_up": Case("_contrib_BilinearResize2D", [_f(2, 3, 5, 6)],
                      {"height": 9, "width": 11}, grad=(0,)),
    "resize_down": Case("BilinearResize2D", [_f(1, 2, 10, 12)],
                        {"height": 6, "width": 5}, grad=(0,)),
    "resize_like": Case("bilinear_resize_2d", [_f(1, 2, 4, 4)],
                        {"like": _f(1, 1, 7, 3), "mode": "like"},
                        grad=(0,)),
    "resize_scale": Case("BilinearResize2D", [_f(1, 2, 4, 6)],
                         {"scale_height": 1.5, "scale_width": 0.5},
                         grad=(0,)),
    "adaptive_pool": Case("_contrib_AdaptiveAvgPooling2D", [_f(2, 3, 10, 13)],
                          {"output_size": (4, 5)}, grad=(0,)),
    "adaptive_pool_global": Case("AdaptiveAvgPooling2D", [_f(2, 3, 5, 4)],
                                 grad=(0,)),
    "boolean_mask": Case("_contrib_boolean_mask",
                         [_f(5, 3), onp.array([1, 0, 1, 1, 0], onp.float32)],
                         tol="exact"),
    "boolean_mask_axis": Case("_npi_boolean_mask",
                              [_f(2, 4), onp.array([0, 1, 1, 0], "int32")],
                              {"axis": 1}, tol="exact"),
    "allclose": Case("_contrib_allclose", [MATCH, MATCH + 1e-6],
                     tol="exact"),
    "allclose_not": Case("allclose", [MATCH, MATCH * 1.01], {"rtol": 1e-3},
                         tol="exact"),
}


@pytest.fixture(scope="module")
def ref():
    return reference_results(reference_thunks(CASES), chunk=8, probe=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(ref, name):
    got, want = check(CASES[name], result(ref, name), name)
    if name.startswith("box_nms"):
        onp.testing.assert_array_equal(keep_rows(got), keep_rows(want),
                                       err_msg=name)


def test_nms_inputs_keep_clear_of_the_thresholds():
    """No IoU of the NMS input within 1e-5 of a threshold (the redrawn
    pairs are counted), and the keep sets are not trivial."""
    for b in range(NMS.shape[0]):
        for t in THRESHOLDS:
            assert len(near(NMS[b, :, 2:], t)) == 0
    assert REDRAWN["box_nms"] >= 0
    keep = keep_rows(port_forward(CASES["box_nms"]))
    assert 0 < keep.sum() < keep.size


def test_boolean_mask_refuses_a_capture(monkeypatch):
    with tmx.cpu():
        x, m = tnd.array(MATCH[0]), tnd.array([1.0, 0.0, 1.0, 0.0, 1.0])
        assert tnd.boolean_mask(x, m).shape == (3, 7)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        with pytest.raises(tmx.MXNetError, match="boolean_mask"):
            tnd.boolean_mask(x, m)


def test_nms_sweep_equals_the_greedy_loop():
    """The fixed-point sweep gives the keep set of the row-by-row greedy
    loop, on a long suppression chain (a row of boxes, each overlapping
    the next), with some rows invalid."""
    n = 60
    x = onp.arange(n, dtype=onp.float32) * 0.6
    boxes = onp.stack([x, onp.zeros(n), x + 1.0, onp.ones(n)], 1)[None]
    valid = onp.ones((1, n), bool)
    valid[0, ::7] = False
    keep = det.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                        None, 0.2).numpy()[0]
    iou = iou64(boxes[0], boxes[0])
    want = valid[0].copy()
    for i in range(n):
        if want[i]:
            want[i + 1:] &= ~(iou[i, i + 1:] > 0.2)
    onp.testing.assert_array_equal(keep, want)
    assert keep.sum() < valid.sum()
