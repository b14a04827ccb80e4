"""The update ops of ``ops/optim_ops.py`` of the port against the JAX
package's, on the same numpy inputs, at small widths, in float32 and in
mixed precision (bf16 weights and gradients, float32 masters), on the CPU.

Tolerances: float32 outputs rtol 1e-6, atol 1e-7 (the arithmetic is the
reference's, in its order: rescale, clip, weight decay); a bf16 output
(an ``mp_*`` op's weight, the float32 master rounded) within one bf16 ulp
(rtol 2**-8). The ``multi_*`` and ``preloaded_multi_*`` ops return flat
tuples; the ``preloaded`` ones take ``lrs``/``wds`` as tensors.
"""
import jax.numpy as jjnp
import ml_dtypes
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import registry as treg

from _parity import compare, reference_results, result

RNG = onp.random.default_rng(33)
SHAPES = [(4, 5), (7,), (2, 3, 2)]


def _arr(shape, lo=None):
    a = RNG.standard_normal(shape).astype(onp.float32)
    return onp.abs(a) + 0.1 if lo == "pos" else a


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


W, G, M, V, Z = (_arr(SHAPES[0], "pos" if k in "VZ" else None)
                 for k in "WGMVZ")
W32 = W.copy()
BW, BG = _bf16(W), _bf16(G)
SCALE = onp.array(0.5, onp.float32)
HYPER = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}

CASES = {  # case: (op, arrays, kwargs)
    "sgd_update": ("sgd_update", [W, G], HYPER),
    "sgd_noclip": ("sgd_update", [W, G], {"lr": 0.1}),
    "sgd_mom_update": ("sgd_mom_update", [W, G, M],
                       dict(HYPER, momentum=0.9)),
    "mp_sgd_update": ("mp_sgd_update", [BW, BG, W32], HYPER),
    "mp_sgd_mom_update": ("mp_sgd_mom_update", [BW, BG, M, W32],
                          dict(HYPER, momentum=0.9)),
    "nag_mom_update": ("nag_mom_update", [W, G, M],
                       dict(HYPER, momentum=0.9)),
    "mp_nag_mom_update": ("mp_nag_mom_update", [BW, BG, M, W32],
                          dict(HYPER, momentum=0.9)),
    "adam_update": ("adam_update", [W, G, M, V], HYPER),
    "adamw_update": ("adamw_update", [W, G, M, V, SCALE],
                     {"lr": 0.01, "wd": 0.1, "eta": 0.5,
                      "clip_gradient": 0.3}),
    "_adamw_update": ("_adamw_update", [W, G, M, V, SCALE], {"lr": 0.01}),
    "mp_adamw_update": ("mp_adamw_update", [BW, BG, M, V, W32, SCALE],
                        {"lr": 0.01, "wd": 0.1}),
    "_mp_adamw_update": ("_mp_adamw_update", [BW, BG, M, V, W32, SCALE],
                         {"lr": 0.01}),
    "ftml_update": ("ftml_update", [W, G, M, V, Z],
                    {"lr": 0.1, "t": 3, "wd": 0.01, "clip_grad": 0.3}),
    "ftrl_update": ("ftrl_update", [W, G, Z, V], HYPER),
    "rmsprop_update": ("rmsprop_update", [W, G, V],
                       dict(HYPER, clip_weights=0.8)),
    "rmspropalex_update": ("rmspropalex_update", [W, G, V, M, Z],
                           dict(HYPER, clip_weights=0.8)),
    "signsgd_update": ("signsgd_update", [W, G], HYPER),
    "signum_update": ("signum_update", [W, G, M],
                      dict(HYPER, momentum=0.9, wd_lh=0.01)),
    "adagrad_update": ("adagrad_update", [W, G, V], HYPER),
    "_sparse_adagrad_update": ("_sparse_adagrad_update", [W, G, V],
                               {"lr": 0.1}),
    "multi_lars": ("multi_lars", [onp.array([0.1, 0.2, 0.3], onp.float32),
                                  onp.array([4.0, 0.0, 9.0], onp.float32),
                                  onp.array([1.0, 2.0, 0.0], onp.float32),
                                  onp.array([0.01, 0.0, 0.1], onp.float32)],
                   {"eta": 0.01, "rescale_grad": 0.5}),
}


def _group(k, mp=False, adam=False):
    """A flat group list over ``SHAPES`` of ``k`` arrays a weight."""
    out = []
    for s in SHAPES:
        w = _arr(s)
        g = _arr(s)
        arrays = [_bf16(w), _bf16(g)] if mp else [w, g]
        extra = k - 2
        for j in range(extra):
            last = j == extra - 1
            arrays.append(w.copy() if mp and last else
                          (onp.abs(_arr(s)) if adam and j == 1 else _arr(s)))
        out += arrays
    return out


LRS, WDS = [0.1, 0.05, 0.2], [0.0, 0.01, 0.02]
MULTI = {"lrs": LRS, "wds": WDS, "rescale_grad": 0.5, "clip_gradient": 0.3,
         "num_weights": 3}
PRE = {"rescale_grad": 0.5, "clip_gradient": 0.3, "num_weights": 3}
LRS_T = onp.array(LRS, onp.float32)
WDS_T = onp.array(WDS, onp.float32)
CASES.update({
    "multi_sgd_update": ("multi_sgd_update", _group(2), MULTI),
    "multi_sgd_mom_update": ("multi_sgd_mom_update", _group(3),
                             dict(MULTI, momentum=0.9)),
    "multi_mp_sgd_update": ("multi_mp_sgd_update", _group(3, mp=True),
                            MULTI),
    "multi_mp_sgd_mom_update": ("multi_mp_sgd_mom_update",
                                _group(4, mp=True), dict(MULTI,
                                                         momentum=0.9)),
    "multi_adamw_update": ("multi_adamw_update", _group(4, adam=True)
                           + [SCALE], {"lrs": LRS, "wds": WDS,
                                       "etas": [1.0, 0.5, 1.0],
                                       "num_weights": 3}),
    "_multi_adamw_update": ("_multi_adamw_update", _group(4, adam=True)
                            + [SCALE], {"num_weights": 3}),
    "multi_mp_adamw_update": ("multi_mp_adamw_update",
                              _group(5, mp=True, adam=True) + [SCALE],
                              {"lrs": LRS, "wds": WDS, "num_weights": 3}),
    "_multi_mp_adamw_update": ("_multi_mp_adamw_update",
                               _group(5, mp=True, adam=True) + [SCALE],
                               {"num_weights": 3}),
    "preloaded_multi_sgd_update": ("preloaded_multi_sgd_update",
                                   _group(2) + [LRS_T, WDS_T], PRE),
    "preloaded_multi_sgd_mom_update": ("preloaded_multi_sgd_mom_update",
                                       _group(3) + [LRS_T, WDS_T], PRE),
    "preloaded_multi_mp_sgd_update": ("preloaded_multi_mp_sgd_update",
                                      _group(3, mp=True) + [LRS_T, WDS_T],
                                      PRE),
    "preloaded_multi_mp_sgd_mom_update": (
        "preloaded_multi_mp_sgd_mom_update",
        _group(4, mp=True) + [LRS_T, WDS_T], PRE),
})


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(onp.float32)).bfloat16()
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def reference():
    return reference_results({
        c: (lambda c=c: jreg.get_op(CASES[c][0]).fn(
            *[jjnp.asarray(a) for a in CASES[c][1]], **CASES[c][2]))
        for c in CASES})


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(case, reference):
    name, arrays, kw = CASES[case]
    got = treg.get_op(name).fn(*[_t(a) for a in arrays], **kw)
    want = result(reference, case)
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    for k, (g, w) in enumerate(zip(got, want)):
        bf16 = g.dtype == torch.bfloat16
        compare(g, w, rtol=2 ** -8 if bf16 else 1e-6,
                atol=0 if bf16 else 1e-7, what="%s[%d]" % (case, k))
    assert len(got) == len(want)


def test_every_update_name_is_registered():
    names = [n for n in jreg.list_ops()
             if jreg.get_op(n).fn.__module__.endswith("optim_ops")]
    assert len(names) == 32
    for n in names:
        assert treg.get_op(n) is not None and \
            treg.get_op(n).name == jreg.get_op(n).name, n


def test_preloaded_rates_stay_tensors_through_nd():
    """Through ``nd``, a flat tuple of NDArrays, with the rates given as
    NDArrays (read where they lie)."""
    cpu = __import__("mxnet_tpu_torch").cpu()
    arrays = [tnd.array(a, ctx=cpu) for a in _group(2)] + [
        tnd.array(LRS_T, ctx=cpu), tnd.array(WDS_T, ctx=cpu)]
    outs = tnd.preloaded_multi_sgd_update(*arrays, **PRE)
    assert isinstance(outs, tuple) and len(outs) == 3
    one = tnd.sgd_update(arrays[0], arrays[1], lr=0.1, wd=0.0,
                         rescale_grad=0.5, clip_gradient=0.3)
    onp.testing.assert_array_equal(outs[0].asnumpy(), one.asnumpy())
