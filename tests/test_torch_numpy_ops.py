"""``ops/numpy_ops.py`` and the rest of ``ops/nn.py`` of the port against
the JAX package's, op by op (the registry functions on the same numpy
inputs), on the CPU.

Tolerances: exact for integer and boolean results, rtol 1e-5 and atol
1e-6 for float32 (jit-fused reference chunks, see ``_parity``), one
bf16 ulp (rtol 2**-8) for the bf16 cases; ``_npi_svd``'s factors by
reconstruction (1e-5 of the input's max) and ``|<u, u_ref>| = 1`` within
1e-4. The samplers (``_npi_bernoulli``, ``_npi_choice``,
``_npi_multinomial``) in distribution and under their key, as PR 14's
samplers (threefry is not ported). The alias table: every ``_npx_`` and
``_npi_`` alias the slice registers is the reference target's op.
"""
import jax.numpy as jjnp
import ml_dtypes
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

from _parity import compare, reference_results, result

RNG = onp.random.default_rng(21)
F = onp.float32
X = RNG.standard_normal((3, 4)).astype(F)
Y = RNG.standard_normal((3, 4)).astype(F)
T = RNG.standard_normal((2, 3, 4)).astype(F)
I = onp.array([[3, 4, 6], [8, 9, 2]], onp.int32)
J = onp.array([[2, 6, 4], [12, 3, 7]], onp.int32)
IMG = RNG.standard_normal((2, 6, 5, 5)).astype(F)
N = X.copy()
N[0, 1], N[1, 2], N[2, 0] = onp.nan, onp.inf, -onp.inf
LOGITS = RNG.standard_normal((5, 7)).astype(F)
LABEL = onp.array([0, 3, -1, 6, 2], F)
BF = X.astype(ml_dtypes.bfloat16)


def _t(a):
    if isinstance(a, onp.ndarray):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(F)).bfloat16()
        return torch.from_numpy(a.copy())
    return a


def _j(a):
    return jjnp.asarray(a) if isinstance(a, onp.ndarray) else a


CASES = {  # case: (op, args, kwargs, rtol)
    "around": ("around", [X], {"decimals": 1}, None),
    "around_int": ("_npi_around", [I], {}, None),
    "rot90": ("rot90", [T], {"k": 3, "axes": (1, 2)}, None),
    "std": ("std", [T], {"axis": (0, 2), "ddof": 1}, None),
    "var": ("_npi_var", [T], {"axis": 1, "keepdims": True}, None),
    "var_int": ("var", [I], {}, None),
    "std_dtype": ("std", [X], {"dtype": "float64"}, None),
    "einsum": ("einsum", [X, Y], {"subscripts": "ij,kj->ik"}, None),
    "tensordot": ("tensordot", [T, X], {"a_axes_summed": (1, 2),
                                        "b_axes_summed": (0, 1)}, None),
    "tensordot_axes": ("_npi_tensordot", [X, Y.T], {"axes": 1}, None),
    "tensordot_int": ("_npi_tensordot_int_axes", [T, X], {"axes": 2}, None),
    "diff": ("diff", [T], {"n": 2, "axis": 2}, None),
    "copysign": ("copysign", [X, Y], {}, None),
    "copysign_int": ("_npi_copysign", [I, J], {}, None),
    "copysign_scalar": ("_npi_copysign_scalar", [X], {"scalar": -1.0}, None),
    "rcopysign_scalar": ("_npi_rcopysign_scalar", [X], {"scalar": 2.5},
                         None),
    "lcm": ("lcm", [I, J], {}, None),
    "lcm_scalar": ("_npi_lcm_scalar", [I], {"scalar": 4}, None),
    "ldexp": ("ldexp", [X, onp.arange(-6, 6, dtype=onp.int32)
                        .reshape(3, 4)], {}, None),
    "ldexp_float_exp": ("_npi_ldexp", [X, Y], {}, None),
    "ldexp_scalar": ("_npi_ldexp_scalar", [X], {"scalar": 3}, None),
    "rldexp_scalar": ("_npi_rldexp_scalar", [I], {"scalar": 1.5}, None),
    "arctan2": ("arctan2", [X, Y], {}, None),
    "arctan2_scalar": ("_npi_arctan2_scalar", [X], {"scalar": 0.5}, None),
    "rarctan2_scalar": ("_npi_rarctan2_scalar", [X], {"scalar": -0.5},
                        None),
    "nan_to_num": ("nan_to_num", [N], {}, None),
    "nan_to_num_args": ("_npi_nan_to_num", [N], {"nan": 1.0, "posinf": 9.0,
                                                 "neginf": -9.0}, None),
    "indices": ("_npi_indices", [], {"dimensions": (2, 3)}, None),
    "indices_dtype": ("indices", [], {"dimensions": (3,),
                                      "dtype": "int64"}, None),
    "logspace": ("logspace", [], {"start": 0.0, "stop": 2.0, "num": 7},
                 None),
    "logspace_base": ("_npi_logspace", [], {"start": -1.0, "stop": 1.0,
                                            "num": 5, "base": 2.0,
                                            "endpoint": False}, None),
    "blackman": ("_npi_blackman", [], {"M": 9}, None),
    "hamming": ("hamming", [], {"M": 9, "dtype": "float64"}, None),
    "hanning": ("hanning", [], {"M": 1}, None),
    "column_stack": ("column_stack", [X[0], Y[0]], {}, None),
    "dstack": ("_npi_dstack", [X, Y], {}, None),
    "vstack": ("vstack", [X, Y], {}, None),
    "hsplit": ("_npi_hsplit", [X], {"sections": 2}, None),
    "hsplit_idx": ("_npi_hsplit", [T], {"indices": (1,)}, None),
    "tril": ("tril", [X], {"k": -1}, None),
    "moveaxis": ("_np_moveaxis", [T], {"source": (0, 1),
                                       "destination": (2, 0)}, None),
    "trace": ("_np_trace", [T], {"offset": 1, "axis1": 1, "axis2": 2},
              None),
    "trace_int": ("trace", [I], {}, None),
    "identity": ("_npi_identity", [], {"n": 3}, None),
    "share_memory": ("share_memory", [X, Y], {}, None),
    "nonzero": ("_npx_nonzero", [I * (I > 4)], {}, None),
    "unique": ("_npi_unique", [I], {"return_index": True,
                                    "return_inverse": True,
                                    "return_counts": True}, None),
    "unique_plain": ("unique", [J.reshape(-1)], {}, None),
    # the rest of nn.py
    "hard_sigmoid": ("hard_sigmoid", [X], {"alpha": 0.3, "beta": 0.4},
                     None),
    "hard_sigmoid_bf16": ("hard_sigmoid", [BF], {}, 2 ** -8),
    "softmin": ("softmin", [X], {"axis": 0, "temperature": 2.0}, None),
    "softmax_activation": ("SoftmaxActivation", [IMG], {}, None),
    "softmax_activation_channel": ("SoftmaxActivation", [IMG],
                                   {"mode": "channel"}, None),
    "softmax_cross_entropy": ("softmax_cross_entropy", [LOGITS, LABEL], {},
                              None),
    "l2norm": ("L2Normalization", [IMG], {}, None),
    "l2norm_channel": ("L2Normalization", [IMG], {"mode": "channel"}, None),
    "l2norm_spatial": ("L2Normalization", [IMG], {"mode": "spatial"}, None),
    "lrn": ("LRN", [IMG], {"nsize": 3, "alpha": 0.01}, None),
    "lrn_bf16": ("LRN", [IMG.astype(ml_dtypes.bfloat16)], {}, 2 ** -8),
    "batch_take": ("batch_take", [LOGITS, onp.array([0, 6, 9, -2, 3], F)],
                   {}, None),
    "upsampling": ("UpSampling", [IMG], {"scale": 2}, None),
    "upsampling_bilinear": ("UpSampling", [IMG], {"scale": 2,
                                                  "sample_type": "bilinear"},
                            None),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref(case):
    name, args, kw, _ = CASES[case]
    return lambda: jreg.get_op(name).fn(*[_j(a) for a in args], **kw)


@pytest.fixture(scope="module")
def reference():
    return reference_results({c: _ref(c) for c in CASES})


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case, reference):
    name, args, kw, rtol = CASES[case]
    got = treg.get_op(name).fn(*[_t(a) for a in args], **kw)
    compare(got, result(reference, case), rtol=rtol or 1e-5,
            atol=0 if rtol else 1e-6, what=case)


def test_svd_factors():
    a = RNG.standard_normal((5, 3)).astype(F)
    u, s, vh = treg.get_op("_npi_svd").fn(torch.from_numpy(a))
    ru, rs, rvh = jreg.get_op("svd").fn(jjnp.asarray(a))
    assert (u.shape, s.shape, vh.shape) == (ru.shape, rs.shape, rvh.shape)
    onp.testing.assert_allclose(s.numpy(), onp.asarray(rs), rtol=1e-5)
    onp.testing.assert_allclose((u * s) @ vh, a, atol=1e-5 * abs(a).max())
    for k in range(3):
        assert abs(abs(u[:, k].numpy() @ onp.asarray(ru)[:, k]) - 1) < 1e-4


def test_new_aliases_are_the_reference_targets():
    """Each alias name this slice adds resolves to the op the reference's
    alias resolves to (same primary name); so do the three whose targets
    came with the detection and contrib families (item 8 steps 2-4)."""
    names = ["_npx_activation", "_npx_batch_norm", "_npx_convolution",
             "_npx_deconvolution", "_npx_dropout", "_npx_fully_connected",
             "_npx_layer_norm", "_npx_leaky_relu", "_npx_log_softmax",
             "_npx_pooling", "_npx_relu", "_npx_sigmoid", "_npx_softmax",
             "_npi_inv", "Convolution_v1", "Pooling_v1", "det", "inverse",
             "svd", "indices", "blackman", "hamming", "hanning"]
    for n in names:
        assert treg.get_op(n).name == jreg.get_op(n).name, n
    for n in ("_npx_roi_pooling", "_npx_smooth_l1", "_npi_boolean_mask"):
        assert treg.get_op(n).name == jreg.get_op(n).name, n


SAMPLER_KEYS = [(1, 2), (3, 4)]


def test_samplers_in_distribution_and_keyed():
    bern = treg.get_op("_npi_bernoulli").fn
    p = torch.full((20000,), 0.3)
    a = bern(prob=p, key=SAMPLER_KEYS[0])
    assert a.dtype == torch.float32 and abs(a.mean().item() - 0.3) < 0.02
    assert torch.equal(a, bern(prob=p, key=SAMPLER_KEYS[0]))
    assert not torch.equal(a, bern(prob=p, key=SAMPLER_KEYS[1]))
    lg = bern(logit=torch.tensor([0.0, 50.0, -50.0]), key=(5, 6))
    assert lg[1:].tolist() == [1.0, 0.0]
    assert bern(size=(4,), key=(1, 1), ctx=None).shape == (4,)
    choice = treg.get_op("_npi_choice").fn
    c = choice(a=10, size=(20000,), key=(7, 8))
    assert c.dtype == torch.int64 and abs(c.float().mean().item() - 4.5) < 0.1
    w = choice(a=3, size=(20000,), p=torch.tensor([0.2, 0.3, 0.5]),
               key=(9, 9))
    freq = torch.bincount(w, minlength=3).float() / 20000
    assert torch.allclose(freq, torch.tensor([0.2, 0.3, 0.5]), atol=0.02)
    perm = choice(a=10, size=(10,), replace=False, key=(1, 2))
    assert sorted(perm.tolist()) == list(range(10))
    pool = choice(a=torch.tensor([5.0, 6.0]), size=(8,), key=(1, 3))
    assert set(pool.tolist()) <= {5.0, 6.0}
    mult = treg.get_op("_npi_multinomial").fn
    m = mult(n=100, pvals=torch.tensor([0.1, 0.9]), size=(200,),
             key=(2, 2))
    assert m.dtype == torch.int64 and m.shape == (200, 2)
    assert (m.sum(-1) == 100).all()
    assert abs(m[:, 1].float().mean().item() - 90.0) < 1.0
    ref = jreg.get_op("_npi_multinomial").fn(
        n=100, pvals=jjnp.asarray([0.1, 0.9]), size=(2,),
        key=__import__("jax").random.PRNGKey(0))
    assert str(ref.dtype) == "int64" and ref.shape == (2, 2)
