"""The port's ``ops/tensor_extra.py`` corpus against the JAX package's,
name by name, on the CPU.

Every op that ``mxnet_tpu/ops/tensor_extra.py`` registers (the scalar
comparisons and logical ops in both spellings, creation, the histogram,
slice assignment, index ravelling, ``moments``, the multi-tensor checks,
``cast_storage`` and ``_sparse_retain``) runs through
``mxnet_tpu.nd.<name>`` and ``mxnet_tpu_torch.nd.<name>`` under
``cpu()`` on the same numpy inputs, made from a seed. Dtype and shape
must be equal, and the values: ``exact`` bit for bit (every NaN taken
as the canonical one: torch's ``maximum`` returns another NaN payload),
``float`` within
rtol 1e-6 / atol 1e-7 (one bf16 ulp in bfloat16). Each alias the
reference registers onto these functions must resolve to the port's op
for the reference's primary name, and ``moments``' gradient through the
port's tape must equal the reference function's within 1e-5 of its
largest |value|. ``_shuffle`` draws, so it is held to the permutation it
must be (and to the seeding rules in ``test_torch_random_ops.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jregistry
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import registry as tregistry

FLOAT_RTOL, FLOAT_ATOL = 1e-6, 1e-7
LINALG_TOL = 1e-5
LGAMMA_ATOL = 1e-6


def _arr(pkg, x):
    if not isinstance(x, np.ndarray):
        return x
    if x.dtype.name == "bfloat16":
        return pkg.nd.array(x.astype("float32"), dtype="float32").astype(
            "bfloat16")
    return pkg.nd.array(x, dtype=x.dtype.name)


def _run(pkg, name, args, kwargs):
    nd = jnd if pkg is jmx else tnd
    with pkg.cpu():
        out = getattr(nd, name)(*[_arr(pkg, a) for a in args], **kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return [o.asnumpy() for o in outs]


def _ulp_bf16(x):
    """One bf16 ulp at each value of ``x`` (float32)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check(family, own, ref):
    assert len(own) == len(ref)
    for o, r in zip(own, ref):
        assert o.dtype == r.dtype, (o.dtype, r.dtype)
        assert o.shape == r.shape, (o.shape, r.shape)
        if family == "exact":
            if o.dtype.kind == "f" or o.dtype.name == "bfloat16":
                # NaN payloads aside: torch's maximum makes another NaN
                o, r = (np.where(np.isnan(a.astype("float32")),
                                 np.array(np.nan, a.dtype), a)
                        for a in (o, r))
            np.testing.assert_array_equal(o.view(np.uint8),
                                          r.view(np.uint8))
        elif family in ("float", "lgamma"):
            if o.dtype.name == "bfloat16":
                of, rf = o.astype("float32"), r.astype("float32")
                assert np.all((np.abs(of - rf) <= _ulp_bf16(rf))
                              | (np.isnan(of) & np.isnan(rf)))
            else:
                np.testing.assert_allclose(
                    o, r, rtol=FLOAT_RTOL,
                    atol=LGAMMA_ATOL if family == "lgamma" else FLOAT_ATOL)
        else:
            scale = max(float(np.abs(r.astype("float64")).max()), 1e-30)
            assert float(np.abs(o.astype("float64") - r).max()) <= \
                LINALG_TOL * scale


def _rng(seed=0):
    return np.random.default_rng(seed)


def _n(*shape, seed=0, dtype="float32", scale=1.0, shift=0.0):
    x = shift + scale * _rng(seed).standard_normal(shape)
    return x.astype(dtype)


def _u(lo, hi, *shape, seed=0, dtype="float32"):
    return _rng(seed).uniform(lo, hi, shape).astype(dtype)


def _ties(*shape, seed=0, dtype="float32"):
    """Values with many ties, a NaN and a signed zero."""
    x = _rng(seed).integers(-3, 4, shape).astype(dtype)
    flat = x.reshape(-1)
    flat[1] = np.nan
    flat[2] = -0.0
    return x


def _spd(n, batch=(), seed=0):
    a = _rng(seed).standard_normal(batch + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype("float32")


def _lower(n, batch=(), seed=0):
    return np.linalg.cholesky(_spd(n, batch, seed)).astype("float32")


BF = "bfloat16"
X = _n(4, 6, scale=2)
XT = _ties(4, 6)
CASES = [
    ("_equal_scalar", "_equal_scalar", [XT], {"scalar": 1.0}, "exact"),
    ("_not_equal_scalar", "_not_equal_scalar", [XT], {"scalar": 0.0},
     "exact"),
    ("_greater_scalar", "_greater_scalar", [X], {"scalar": 0.3}, "exact"),
    ("_greater_scalar_bf16", "_greater_scalar", [_n(64, dtype=BF)],
     {"scalar": 0.1}, "exact"),
    ("_greater_equal_scalar", "_greater_equal_scalar", [XT],
     {"scalar": 1.0}, "exact"),
    ("_lesser_scalar", "_lesser_scalar", [X], {"scalar": -0.2}, "exact"),
    ("_lesser_equal_scalar", "_lesser_equal_scalar", [XT], {"scalar": 0.0},
     "exact"),
    ("_lesser_scalar_int", "_lesser_scalar",
     [np.arange(-4, 4, dtype="int32")], {"scalar": 1}, "exact"),
    ("_logical_and_scalar", "_logical_and_scalar", [XT], {"scalar": 1.0},
     "exact"),
    ("_logical_or_scalar", "_logical_or_scalar", [XT], {"scalar": 0.0},
     "exact"),
    ("_logical_xor_scalar", "_logical_xor_scalar", [XT], {"scalar": 1.0},
     "exact"),
    ("_maximum_scalar", "_maximum_scalar", [XT], {"scalar": 0.5}, "exact"),
    ("_minimum_scalar", "_minimum_scalar", [X], {"scalar": 0.5}, "exact"),
    ("_minimum_scalar_bf16", "_minimum_scalar", [_n(64, dtype=BF)],
     {"scalar": 0.1}, "exact"),
    ("_mod_scalar", "_mod_scalar", [X], {"scalar": 0.7}, "exact"),
    ("_rmod_scalar", "_rmod_scalar", [_u(0.5, 3, 4, 6)], {"scalar": 2.5},
     "exact"),
    ("_hypot_scalar", "_hypot_scalar", [X], {"scalar": 1.5}, "float"),
    ("_logical_and", "_logical_and", [XT, _ties(4, 6, seed=1)], {},
     "exact"),
    ("_logical_or", "_logical_or", [XT, _ties(4, 6, seed=1)], {}, "exact"),
    ("_logical_xor", "_logical_xor", [XT, _ties(4, 6, seed=1)], {},
     "exact"),
    # creation
    ("_zeros", "_zeros", [], {"shape": (2, 3)}, "exact"),
    ("_zeros_int", "_zeros", [], {"shape": (4,), "dtype": "int32"},
     "exact"),
    ("_ones", "_ones", [], {"shape": (3, 2), "dtype": "bfloat16"}, "exact"),
    ("_full", "_full", [], {"shape": (2, 2), "value": 0.1}, "exact"),
    ("_eye", "_eye", [], {"N": 4}, "exact"),
    ("_eye_k", "_eye", [], {"N": 3, "M": 5, "k": 2, "dtype": "int32"},
     "exact"),
    ("_eye_negk", "_eye", [], {"N": 4, "M": 3, "k": -1}, "exact"),
    ("_linspace", "_linspace", [], {"start": -1.3, "stop": 7.1, "num": 37},
     "exact"),
    ("_linspace_open", "_linspace", [],
     {"start": 0.2, "stop": 1.0, "num": 9, "endpoint": False}, "exact"),
    ("_histogram", "_histogram", [_n(200, scale=3)], {"bin_cnt": 7},
     "hist"),
    ("_histogram_range", "_histogram", [_n(200, scale=3)],
     {"bins": 5, "range": (-2.0, 3.0)}, "hist"),
    # indexing / assignment
    ("_slice_assign", "_slice_assign", [_n(4, 6), _n(2, 3, seed=1)],
     {"begin": (1, 0), "end": (3, 6), "step": (1, 2)}, "exact"),
    ("_slice_assign_none", "_slice_assign", [_n(4, 6), _n(4, 2, seed=1)],
     {"begin": (None, 4), "end": (None, None)}, "exact"),
    ("_slice_assign_scalar", "_slice_assign_scalar", [_n(4, 6)],
     {"scalar": 2.5, "begin": (0, 1), "end": (2, 5)}, "exact"),
    ("_scatter_set_nd", "_scatter_set_nd",
     [_n(3, 4), _n(2, seed=1), np.array([[0, 2], [3, 1]], "int32")],
     {"shape": (3, 4)}, "exact"),
    ("_ravel_multi_index", "_ravel_multi_index",
     [np.array([[0, 1, 3, 5], [2, 0, 4, 1]], "float32")],
     {"shape": (4, 3)}, "exact"),
    ("_unravel_index", "_unravel_index",
     [np.array([0, 5, 11, 7], "float32")], {"shape": (4, 3)}, "exact"),
    ("_unravel_index_int", "_unravel_index",
     [np.array([0, 23, 17], "int64")], {"shape": (2, 3, 4)}, "exact"),
    ("_identity_with_attr_like_rhs", "_identity_with_attr_like_rhs",
     [X, _n(2, seed=1)], {}, "exact"),
    ("broadcast_like", "broadcast_like", [_n(1, 6), _n(4, 6, seed=1)], {},
     "exact"),
    ("broadcast_like_axes", "broadcast_like", [_n(1, 6, 1), _n(5, 3)],
     {"lhs_axes": (0, 2), "rhs_axes": (0, 1)}, "exact"),
    ("reshape_like", "reshape_like", [_n(4, 6), _n(3, 8, seed=1)], {},
     "exact"),
    ("reshape_like_range", "reshape_like", [_n(2, 12, 5), _n(3, 4)],
     {"lhs_begin": 1, "lhs_end": 2, "rhs_begin": 0, "rhs_end": None},
     "exact"),
    ("_split_v2_sections", "_split_v2", [_n(4, 6)],
     {"sections": 3, "axis": 1}, "exact"),
    ("_split_v2_indices", "_split_v2", [_n(6, 4)],
     {"indices": (1, 4), "axis": 0, "squeeze_axis": False}, "exact"),
    ("_split_v2_squeeze", "_split_v2", [_n(2, 3)],
     {"sections": 3, "axis": 1, "squeeze_axis": True}, "exact"),
    ("argmax_channel", "argmax_channel", [_ties(3, 7)], {}, "exact"),
    ("moments", "moments", [_n(3, 4, 5)], {"axes": (0, 2)}, "float"),
    ("moments_keep", "moments", [_n(3, 4, 5)],
     {"axes": (1,), "keepdims": True}, "float"),
    ("moments_bf16", "moments", [_n(6, 8, dtype=BF)], {"axes": (1,)},
     "float"),
    ("_square_sum", "_square_sum", [_n(4, 6)], {"axis": 1}, "float"),
    ("_square_sum_all", "_square_sum", [_n(4, 6)],
     {"axis": (0, 1), "keepdims": True}, "float"),
    ("cast_storage", "cast_storage", [X], {"stype": "row_sparse"}, "exact"),
    ("_sparse_retain", "_sparse_retain",
     [_n(5, 3), np.array([0, 3], "int64")], {}, "exact"),
    ("all_finite", "all_finite", [X], {}, "exact"),
    ("all_finite_nan", "all_finite", [XT], {}, "exact"),
    ("multi_all_finite", "multi_all_finite", [X, _n(3, seed=1)],
     {"num_arrays": 2}, "exact"),
    ("multi_all_finite_inf", "multi_all_finite",
     [X, np.array([1, np.inf], "float32")], {"num_arrays": 2}, "exact"),
    ("multi_sum_sq", "multi_sum_sq", [X, _n(3, 5, seed=1)],
     {"num_arrays": 2}, "float"),
    ("reset_arrays", "reset_arrays", [X, _n(3, seed=1)], {"num_arrays": 2},
     "exact"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    _, name, args, kwargs, family = case
    own = _run(tmx, name, args, dict(kwargs))
    ref = _run(jmx, name, args, dict(kwargs))
    if family == "hist":
        # counts bit for bit; the edges within ``float`` (XLA fuses the
        # edges' multiply-adds its own way: an ulp on some edges)
        check("exact", own[:1], ref[:1])
        check("float", own[1:], ref[1:])
    else:
        check(family, own, ref)


EXTRA_ALIASES = {
    "_EqualScalar": "_equal_scalar", "_NotEqualScalar": "_not_equal_scalar",
    "_GreaterScalar": "_greater_scalar",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_LogicalAndScalar": "_logical_and_scalar",
    "_LogicalOrScalar": "_logical_or_scalar",
    "_LogicalXorScalar": "_logical_xor_scalar",
    "_MaximumScalar": "_maximum_scalar", "_MinimumScalar": "_minimum_scalar",
    "_npi_maximum_scalar": "_maximum_scalar",
    "_npi_minimum_scalar": "_minimum_scalar",
    "_ModScalar": "_mod_scalar", "_npi_mod_scalar": "_mod_scalar",
    "_RModScalar": "_rmod_scalar", "_npi_rmod_scalar": "_rmod_scalar",
    "_HypotScalar": "_hypot_scalar", "_npi_hypot_scalar": "_hypot_scalar",
    "_Logical_And": "_logical_and", "_Logical_Or": "_logical_or",
    "_Logical_Xor": "_logical_xor",
    "_npi_zeros": "_zeros", "_zeros_without_dtype": "_zeros",
    "_npi_ones": "_ones", "_npi_full": "_full", "_npi_eye": "_eye",
    "_npi_linspace": "_linspace", "_npi_histogram": "_histogram",
    "_crop_assign": "_slice_assign", "_npi_slice_assign": "_slice_assign",
    "_crop_assign_scalar": "_slice_assign_scalar",
    "_npi_slice_assign_scalar": "_slice_assign_scalar",
    "_npi_scatter_set_nd": "_scatter_set_nd",
    "ravel_multi_index": "_ravel_multi_index",
    "unravel_index": "_unravel_index",
    "_npx_reshape_like": "reshape_like", "square_sum": "_square_sum",
    "sparse_retain": "_sparse_retain",
    "shuffle": "_shuffle", "_np__random_shuffle": "_shuffle",
}


@pytest.mark.parametrize("alias", sorted(EXTRA_ALIASES))
def test_alias_resolves_as_reference(alias):
    primary = EXTRA_ALIASES[alias]
    assert jregistry.get_op(alias).name == primary
    assert tregistry.get_op(alias) is tregistry.get_op(primary)


@pytest.mark.parametrize("keepdims", [False, True])
def test_moments_gradient_matches_reference(keepdims):
    """Tolerance: within 1e-5 of each gradient's largest |value|."""
    x = _n(3, 4, 5)
    hm, hv = _n(3, 1, 5, seed=5), _n(3, 1, 5, seed=6)
    if not keepdims:
        hm, hv = hm[:, 0], hv[:, 0]
    with tmx.cpu():
        t = tnd.array(x)
        t.attach_grad()
        with tag.record():
            m, v = tnd.moments(t, axes=(1,), keepdims=keepdims)
            loss = (m * tnd.array(hm)).sum() + (v * tnd.array(hv)).sum()
        loss.backward()
        own = t.grad.asnumpy()
    fn = jregistry.get_op("moments").fn

    def f(a):
        m, v = fn(a, axes=(1,), keepdims=keepdims)
        return jnp.sum(m * hm) + jnp.sum(v * hv)

    check("linalg", [own], [np.asarray(jax.jit(jax.grad(f))(x))])


def test_shuffle_permutes_the_first_axis():
    x = np.arange(40, dtype="float32").reshape(10, 4)
    with tmx.cpu():
        out = tnd.shuffle(tnd.array(x)).asnumpy()
    assert out.dtype == x.dtype and out.shape == x.shape
    assert sorted(out[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(out, x[(out[:, 0] // 4).astype(int)])
