"""Item 8 steps 1-4 (the contrib, control-flow, spatial and detection
families) on a card. Every test here is marked ``cuda`` and skips where no
CUDA device is present; the module imports neither JAX nor the JAX
package (the CPU side is held to the reference in
``tests/test_torch_contrib_ops.py``, ``test_torch_spatial_ops.py``,
``test_torch_detection_ops.py`` and ``test_torch_proposal_ops.py``):

    python -m pytest --noconftest -q tests/test_torch_detection_cuda.py

Parts (a)-(c) of ``chip_smoke.py``'s detection phase at small sizes (its
functions, with its tolerances): (a) every name the slice registers on
``gpu(0)`` against the CPU, the NMS bitwise on the same rows, ``foreach``
over an LSTM cell; (b) SSD's anchors, targets, loss and detection; (c)
Faster R-CNN's proposals, ROIAlign, PSROIPooling and a deformable
convolution. Then: the value-dependent and predicated ops raise, naming
themselves, inside a ``CachedOp``'s CUDA-graph capture, and ``foreach``
runs in one.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = {"DET_SSD_MAPS": (8, 4, 2, 1, 1, 1), "DET_BATCH": 2,
         "DET_ANCHORS": 8 * 8 * 4 + 16 * 6 + 4 * 6 + 6 + 4 + 4,
         "DET_MAP": (6, 8), "DET_C4": 64, "DET_PS": (3, 3), "DET_DCN": 16,
         "DET_LSTM": (5, 8, 32), "DET_CPU_ROWS": 4, "DET_CALLS": 2}


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = {k: getattr(cs, k) for k in SMALL}
    for k, v in SMALL.items():
        setattr(cs, k, v)
    yield types.SimpleNamespace(seed=0, profile=False)
    for k, v in saved.items():
        setattr(cs, k, v)


DEV, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture(scope="module")
def arrays(small):
    return cs._det_derived(torch, nd, cs._det_arrays(0), DEV)


def test_a_every_new_name_on_the_card(small, arrays):
    out, mism = cs._det_part_a(small, torch, nd, arrays, DEV, CPU)
    assert mism == [] and out["names"] == len(cs.DET_NEW_NAMES) == 130


def test_a_nms_bitwise_on_the_same_rows(small, arrays):
    out = cs._det_nms_explained(torch, arrays, DEV, CPU)
    assert out["ssd_decode_err"] <= cs.DET_TOL


def test_a_foreach_lstm(small, arrays):
    out = cs._det_lstm(torch, nd, autograd, arrays, DEV, CPU)
    assert out["out_rel_to_max"] <= 1e-4 and out["ms_fwd_bwd"] > 0


def test_b_ssd(small, arrays):
    out = cs._det_ssd(small, torch, nd, autograd, arrays, DEV)
    assert out["positives"] > 0 and out["kept"] > 0


def test_c_faster_rcnn(small, arrays):
    out = cs._det_frcnn(small, torch, nd, autograd, arrays, DEV)
    assert out["rois_kept"] > 0 and out["ms"]["Proposal"] > 0


class _Fn(gluon.HybridBlock):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def hybrid_forward(self, F, x):
        return self._fn(x)


@pytest.mark.parametrize("name,fn", [      # no host value in the lambdas
    ("boolean_mask", lambda x: nd.boolean_mask(x, x)),
    ("while_loop", lambda x: nd.contrib.while_loop(
        lambda v: v[0:1], lambda v: v * 0, x)),
    ("cond", lambda x: nd.contrib.cond(x[0:1], lambda: x,
                                       lambda: x * 2))])
def test_value_dependent_ops_raise_in_a_capture(small, name, fn):
    x = nd.array(np.array([1.0, 0.0, 2.0, 0.5], np.float32), ctx=mx.gpu(0))
    fn(x)                                   # eagerly it runs
    net = _Fn(fn)
    net.hybridize()
    with autograd.predict_mode(), pytest.raises(mx.MXNetError, match=name):
        net(x)


def test_foreach_runs_in_a_capture(small):
    x = nd.array(np.arange(12.0, dtype=np.float32).reshape(3, 4),
                 ctx=mx.gpu(0))
    fn = (lambda v: nd.contrib.foreach(
        lambda t, s: (t * s, s + t), v, v[0])[0])
    want = fn(x).asnumpy()
    net = _Fn(fn)
    net.hybridize()
    with autograd.predict_mode():
        got = net(x).asnumpy()
        again = net(x).asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
