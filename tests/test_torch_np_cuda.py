"""The numpy frontends and the second part of the op corpus on a card.
Every test here is marked ``cuda`` and skips where no CUDA device is
present; the module imports neither JAX nor the JAX package (the CPU side
is held to the reference in ``tests/test_torch_numpy*.py``,
``test_torch_numpy_ops.py``, ``test_torch_optim_ops.py``,
``test_torch_linalg_extra.py`` and ``test_torch_image_ops.py``):

    python -m pytest --noconftest -q tests/test_torch_np_cuda.py

Parts (a)-(f) of ``chip_smoke.py``'s np phase at small sizes (its
functions, with its tolerances): (a) every name the slice registers on
``gpu(0)`` against the CPU; (b) every public callable of ``mx.np``,
``np.linalg``, ``np.random`` and ``mx.npx``, in the CPU's dtypes; (c) the
MLM loss's gradients through ``mx.np``, bitwise to ``nd``'s; (d) the
update ops over a 2-layer BERT's parameters against the CPU; (e) the
image preprocessing into a small ResNet input; (f) the samplers' moments
and seeds. Then: the solvers' results stay on the card, and the
value-dependent-shape functions raise, naming themselves, inside a
``CachedOp``'s CUDA-graph capture.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, models, nd
from mxnet_tpu_torch import numpy as npm
from mxnet_tpu_torch import numpy_extension as npx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = {"NP_LOGITS": (4, 320), "NP_SVD": ((16, 16), (16, 48)),
         "NP_SPD": (3, 16, 16), "NP_LQ": (3, 4, 16),
         "NP_IMAGES": (2, 40, 36, 3), "NP_CROP": 28,
         "NP_DRAWS": (8, 3, 64, 64), "BERT_VOCAB": 100, "NP_MLM_ROWS": 20,
         "VISION_IMAGE": 32}


def _small_cases(orig):
    def cases():
        c = orig()
        c["_npi_indices"] = ([], {"dimensions": (4, 4)}, "exact")
        for k in ("_npi_blackman", "_npi_hamming", "_npi_hanning"):
            c[k] = ([], {"M": 50}, c[k][2])
        c["logspace"] = ([], {"start": -2.0, "stop": 2.0, "num": 50},
                         "float")
        c["_npi_identity"] = ([], {"n": 8}, "exact")
        c["_image_crop"] = (["@IMG"], {"x": 2, "y": 2, "width": 28,
                                       "height": 28}, "exact")
        return c
    return cases


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    patch = dict(SMALL, _np_op_cases=_small_cases(cs._np_op_cases))
    saved = {k: getattr(cs, k) for k in patch}
    card = dict(cs.NP_SIZES["card"])
    for k, v in patch.items():
        setattr(cs, k, v)
    cs.NP_SIZES["card"] = dict(card, n=60, rows=6, cols=8, depth=2,
                               knots=10, m=8)
    bert_base = models.bert_base
    models.bert_base = lambda **kw: models.bert_tiny(**kw)
    yield types.SimpleNamespace(seed=0, profile=False)
    models.bert_base = bert_base
    cs.NP_SIZES["card"] = card
    for k, v in saved.items():
        setattr(cs, k, v)


DEV, CPU = torch.device("cuda"), torch.device("cpu")


def test_a_every_new_name_on_the_card(small):
    out, mism = cs._np_part_a(small, torch, mx, nd, DEV, CPU)
    assert mism == [] and out["names"] == len(cs.NP_NEW_NAMES) == 184


def test_b_every_public_function_on_the_card(small):
    out, mism = cs._np_part_b(small, torch, mx, DEV, CPU)
    assert mism == [] and out["functions"] >= 300


def test_c_mlm_gradients(small):
    out = cs._np_mlm(torch, mx, npm, npx, nd, autograd, DEV, 0)
    assert out["np_equals_nd_bitwise"]


def test_d_updates(small):
    out = cs._np_updates(small, torch, mx, nd, DEV)
    assert out["values"] > 0 and out["ms"]["trainer_adam"] > 0


def test_e_images(small):
    out = cs._np_images(small, torch, mx, nd, DEV)
    assert out["logits_rel_to_max"] <= cs.NP_LOGIT_TOL


def test_f_samplers(small):
    assert len(cs._np_samplers(small, torch, mx, npm, DEV)) == 12


def test_solvers_stay_on_the_card(small):
    rng = np.random.default_rng(1)
    a = nd.array(rng.standard_normal((3, 8, 8)).astype(np.float32),
                 ctx=mx.gpu(0))
    spd = nd.linalg_gemm2(a, a, transpose_b=True) + 8 * nd.array(
        np.eye(8, dtype=np.float32), ctx=mx.gpu(0))
    outs = [*nd._npi_svd(a[0]), *nd.linalg_syevd(spd),
            *nd.linalg_gelqf(a[:, :4]), nd.linalg_inverse(spd),
            *nd.linalg_slogdet(spd), nd.linalg_potri(nd.linalg_potrf(spd)),
            *npm.linalg.svd(npm.array(a[0]))]
    assert all(o._data.device.type == "cuda" for o in outs)


class _ValueShaped(gluon.HybridBlock):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def hybrid_forward(self, F, x):
        return self._fn(x)


@pytest.mark.parametrize("name,fn", [
    ("nonzero", lambda x: nd.nonzero(x)),
    ("unique", lambda x: nd._npi_unique(x)),
    ("argwhere", lambda x: npm.argwhere(x.as_np_ndarray())),
    ("boolean indexing", lambda x: x.as_np_ndarray()[
        npm.greater(x.as_np_ndarray(), 0)]),
])
def test_value_dependent_shapes_raise_in_a_capture(small, name, fn):
    x = nd.array(np.array([1.0, 0.0, 2.0, 0.0], np.float32), ctx=mx.gpu(0))
    fn(x)                                   # eagerly it runs
    net = _ValueShaped(fn)
    net.hybridize()
    with autograd.predict_mode(), pytest.raises(mx.MXNetError,
                                                match=name):
        net(x)
