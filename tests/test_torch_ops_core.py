"""The port's ``ops/core.py`` corpus against the JAX package's, name by
name, on the CPU.

Every op that ``mxnet_tpu/ops/core.py`` registers and the port lacked
before (elementwise math, logical ops, ordering, NaN reductions, shape
and indexing ops, the AMP casts, ``linalg_*``) runs through
``mxnet_tpu.nd.<name>`` and ``mxnet_tpu_torch.nd.<name>`` under
``cpu()`` on the same numpy inputs, made from a seed. Dtype and shape
must be equal, and the values within the case's family tolerance:

- ``exact``: bit for bit (ordering, indexing, shape, comparisons, casts,
  arithmetic that rounds once, and ``cumsum``, which adds in XLA's
  order);
- ``float``: rtol 1e-6 / atol 1e-7 in float32 (transcendental functions
  and reductions), one bf16 ulp in bfloat16;
- ``linalg``: within 1e-5 of each output's largest |value|;
- ``lgamma``: rtol 1e-6 / atol 1e-6. ``gammaln`` is XLA's Lanczos sum
  in both packages, op for op, but near its roots at 1 and 2 it cancels
  terms of magnitude ~2, and XLA's and torch's ``log``/``log1p`` differ
  by an ulp on ~5% of inputs: the absolute tolerance is 4 ulps of those
  terms.

Each alias the reference registers onto these functions (the ``_npi_``,
``_np_``, ``_npx_``, ``_linalg_`` and CamelCase spellings) must resolve to
the port's op for the reference's primary name. Gradients through the
port's tape are held against those of the reference op's function (under
one ``jax.jit``) for ``linalg_*``, ``sort`` and ``topk`` values and
``cumsum``.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
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
# (id, op name, args, kwargs, family)
CASES = [
    # elementwise math
    ("rint", "rint", [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7],
                               "float32")], {}, "exact"),
    ("rint_bf16", "rint", [_n(64, scale=4, dtype=BF)], {}, "exact"),
    ("fix", "fix", [_n(64, scale=4)], {}, "exact"),
    ("cbrt", "cbrt", [_n(64, scale=8)], {}, "float"),
    ("cbrt_bf16", "cbrt", [_n(64, scale=8, dtype=BF)], {}, "float"),
    ("rcbrt", "rcbrt", [_u(0.1, 9, 64)], {}, "float"),
    ("gamma", "gamma", [_u(0.5, 4.5, 64)], {}, "float"),
    ("gammaln", "gammaln", [_u(0.5, 9, 64)], {}, "lgamma"),
    ("gammaln_neg", "gammaln", [_u(-4.5, 0.45, 64)], {}, "lgamma"),
    ("gammaln_bf16", "gammaln", [_u(0.5, 9, 64, dtype=BF)], {}, "lgamma"),
    ("erfinv", "erfinv", [_u(-0.9, 0.9, 64)], {}, "float"),
    ("digamma", "digamma", [_u(0.5, 9, 64)], {}, "float"),
    ("digamma_neg", "digamma", [_u(-4.4, 0.45, 64, seed=3)], {}, "lgamma"),
    ("arcsinh", "arcsinh", [_n(64, scale=3)], {}, "float"),
    ("arccosh", "arccosh", [_u(1.0, 9, 64)], {}, "float"),
    ("arctanh", "arctanh", [_u(-0.9, 0.9, 64)], {}, "float"),
    ("degrees", "degrees", [_n(64, scale=3)], {}, "exact"),
    ("degrees_bf16", "degrees", [_n(64, scale=3, dtype=BF)], {}, "exact"),
    ("radians", "radians", [_n(64, scale=300)], {}, "exact"),
    ("radians_bf16", "radians", [_n(64, scale=300, dtype=BF)], {}, "exact"),
    ("hypot", "hypot", [_n(4, 8), _n(4, 8, seed=1)], {}, "float"),
    ("hypot_bcast", "hypot", [_n(4, 8), _n(1, 8, seed=1)], {}, "float"),
    ("fmod", "fmod", [_n(4, 8, scale=5), _u(0.5, 2, 4, 8, seed=1)], {},
     "exact"),
    ("fmod_int", "fmod", [np.arange(-6, 6, dtype="int32"),
                          np.full(12, 4, "int32")], {}, "exact"),
    ("isnan", "isnan", [np.array([0, np.nan, np.inf, -1], "float32")], {},
     "exact"),
    ("isinf", "isinf", [np.array([0, np.nan, np.inf, -np.inf], "float32")],
     {}, "exact"),
    ("isfinite", "isfinite", [np.array([0, np.nan, np.inf, -1], "float32")],
     {}, "exact"),
    # logical
    ("logical_and", "logical_and", [_ties(4, 6), _ties(4, 6, seed=1)], {},
     "exact"),
    ("logical_or", "logical_or", [_ties(4, 6), _ties(4, 6, seed=1)], {},
     "exact"),
    ("logical_xor", "logical_xor", [_ties(4, 6), _ties(1, 6, seed=1)], {},
     "exact"),
    ("logical_not", "logical_not", [_ties(4, 6)], {}, "exact"),
    ("logical_not_bf16", "logical_not", [_ties(4, 6, dtype=BF)], {},
     "exact"),
    # ordering
    ("sort", "sort", [_ties(5, 9)], {}, "exact"),
    ("sort_desc", "sort", [_ties(5, 9)], {"is_ascend": False}, "exact"),
    ("sort_axis0", "sort", [_ties(5, 9)], {"axis": 0, "is_ascend": False},
     "exact"),
    ("sort_bf16", "sort", [_n(4, 33, dtype=BF)], {"is_ascend": False},
     "exact"),
    ("argsort", "argsort", [_ties(5, 9)], {}, "exact"),
    ("argsort_desc", "argsort", [_ties(5, 9)], {"is_ascend": False},
     "exact"),
    ("argsort_int32", "argsort", [_ties(5, 9)],
     {"axis": 0, "dtype": "int32"}, "exact"),
    ("topk_indices", "topk", [_ties(5, 9)], {"k": 3}, "exact"),
    ("topk_value", "topk", [_ties(5, 9)], {"k": 3, "ret_typ": "value"},
     "exact"),
    ("topk_both", "topk", [_ties(5, 9)], {"k": 4, "ret_typ": "both"},
     "exact"),
    ("topk_mask", "topk", [_ties(5, 9)], {"k": 2, "ret_typ": "mask"},
     "exact"),
    ("topk_ascend", "topk", [_ties(5, 9)],
     {"k": 3, "ret_typ": "both", "is_ascend": True}, "exact"),
    ("topk_axis0", "topk", [_ties(6, 4)],
     {"k": 2, "axis": 0, "ret_typ": "both", "dtype": "int64"}, "exact"),
    ("topk_mask_axis0", "topk", [_n(6, 4)],
     {"k": 2, "axis": 0, "ret_typ": "mask"}, "exact"),
    ("topk_bf16", "topk", [_n(4, 40, dtype=BF)],
     {"k": 5, "ret_typ": "both"}, "exact"),
    # cumsum adds in XLA's order (blocks of 16, the blocks' totals scanned
    # the same way), so it is held bit for bit: fp32 over three levels of
    # blocks, and bf16, where the reference rounds each addition
    ("cumsum_flat", "cumsum", [_n(3, 5)], {}, "exact"),
    ("cumsum_axis", "cumsum", [_n(3, 5)], {"axis": 1}, "exact"),
    ("cumsum_long", "cumsum", [_n(2, 300)], {"axis": 1}, "exact"),
    ("cumsum_int", "cumsum", [np.arange(12, dtype="int32").reshape(3, 4)],
     {"axis": 0}, "exact"),
    ("cumsum_dtype", "cumsum", [_n(3, 5)], {"axis": 0, "dtype": "float64"},
     "exact"),
    ("cumsum_bf16", "cumsum", [_n(2, 24, dtype=BF)], {"axis": 1}, "exact"),
    ("cumsum_bf16_long", "cumsum", [_n(2, 300, dtype=BF)], {"axis": 1},
     "exact"),
    # NaN reductions
    ("nansum", "nansum", [_ties(4, 6)], {}, "float"),
    ("nansum_axis", "nansum", [_ties(4, 6)], {"axis": 1, "keepdims": True},
     "float"),
    ("nanprod", "nanprod", [_ties(4, 6) + 4.5], {"axis": 0}, "float"),
    ("nanprod_all", "nanprod", [_u(0.5, 1.5, 3, 4)], {}, "float"),
    # shape and indexing
    ("roll", "roll", [_n(3, 5)], {"shift": 2, "axis": 1}, "exact"),
    ("roll_flat", "roll", [_n(3, 5)], {"shift": -4}, "exact"),
    ("roll_multi", "roll", [_n(3, 5)], {"shift": (1, 2), "axis": (0, 1)},
     "exact"),
    ("depth_to_space", "depth_to_space", [_n(2, 8, 3, 3)],
     {"block_size": 2}, "exact"),
    ("space_to_depth", "space_to_depth", [_n(2, 2, 6, 4)],
     {"block_size": 2}, "exact"),
    ("scatter_nd", "scatter_nd",
     [_n(3), np.array([[0, 1, 2], [2, 0, 1]], "int32")],
     {"shape": (3, 4)}, "exact"),
    ("shape_array", "shape_array", [_n(2, 3, 4)], {}, "exact"),
    ("size_array", "size_array", [_n(2, 3, 4)], {}, "exact"),
    ("diag_vec", "diag", [_n(4)], {"k": 1}, "exact"),
    ("diag_mat", "diag", [_n(2, 4, 5)], {"k": -1}, "exact"),
    ("khatri_rao", "khatri_rao", [_n(2, 3), _n(4, 3, seed=1),
                                  _n(2, 3, seed=2)], {}, "float"),
    # AMP casts
    ("amp_cast", "amp_cast", [_n(8)], {"dtype": "bfloat16"}, "exact"),
    ("amp_cast_back", "amp_cast", [_n(8, dtype=BF)], {"dtype": "float32"},
     "exact"),
    ("amp_multicast", "amp_multicast", [_n(4, dtype="float16"),
                                        _n(4, seed=1)],
     {"num_outputs": 2}, "exact"),
    ("amp_multicast_narrow", "amp_multicast",
     [_n(4, dtype="float16"), _n(4, seed=1)],
     {"num_outputs": 2, "cast_narrow": True}, "exact"),
    # linalg
    ("gemm2", "linalg_gemm2", [_n(3, 4, 5), _n(3, 5, 6, seed=1)], {},
     "linalg"),
    ("gemm2_t", "linalg_gemm2", [_n(5, 4), _n(6, 5, seed=1)],
     {"transpose_a": True, "transpose_b": True, "alpha": 0.5}, "linalg"),
    ("gemm", "linalg_gemm", [_n(2, 4, 5), _n(2, 5, 3, seed=1),
                             _n(2, 4, 3, seed=2)],
     {"alpha": 2.0, "beta": -0.5}, "linalg"),
    ("gemm_ta", "linalg_gemm", [_n(5, 4), _n(5, 3, seed=1),
                                _n(4, 3, seed=2)],
     {"transpose_a": True}, "linalg"),
    ("potrf", "linalg_potrf", [_spd(5, (2,))], {}, "linalg"),
    ("syrk", "linalg_syrk", [_n(2, 3, 5)], {"alpha": 0.5}, "linalg"),
    ("syrk_t", "linalg_syrk", [_n(3, 5)], {"transpose": True}, "linalg"),
    ("trsm", "linalg_trsm", [_lower(4, (2,)), _n(2, 4, 3, seed=1)],
     {"alpha": 2.0}, "linalg"),
    ("trsm_t", "linalg_trsm", [_lower(4), _n(4, 3, seed=1)],
     {"transpose": True}, "linalg"),
    ("trsm_right", "linalg_trsm", [_lower(4), _n(3, 4, seed=1)],
     {"rightside": True}, "linalg"),
    ("trsm_right_upper", "linalg_trsm",
     [np.ascontiguousarray(_lower(4).T), _n(3, 4, seed=1)],
     {"rightside": True, "lower": False, "transpose": True}, "linalg"),
    ("sumlogdiag", "linalg_sumlogdiag", [_spd(4, (3,))], {}, "linalg"),
    ("extractdiag", "linalg_extractdiag", [_n(2, 4, 4)], {"offset": 1},
     "exact"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    _, name, args, kwargs, family = case
    check(family, _run(tmx, name, args, dict(kwargs)),
          _run(jmx, name, args, dict(kwargs)))


# every name the reference's ops/core.py functions are registered under,
# with the primary op's name (computed from the reference's registry)
CORE_ALIASES = {
    "_Div": "divide", "_Equal": "equal", "_Greater": "greater",
    "_Greater_Equal": "greater_equal", "_Hypot": "hypot",
    "_Lesser": "lesser", "_Lesser_Equal": "lesser_equal",
    "_Maximum": "maximum", "_Minimum": "minimum", "_Minus": "subtract",
    "_Mod": "mod", "_Mul": "multiply", "_Not_Equal": "not_equal",
    "_Plus": "add", "_Power": "power", "_grad_add": "add",
    "_hypot": "hypot", "broadcast_hypot": "hypot", "_mod": "mod",
    "less": "lesser", "less_equal": "lesser_equal",
    "choose_element_0index": "pick", "BlockGrad_identity": "identity",
    "SparseEmbedding": "embedding", "_contrib_SparseEmbedding": "embedding",
    "broadcast_logical_and": "logical_and",
    "broadcast_logical_or": "logical_or",
    "broadcast_logical_xor": "logical_xor",
    "_linalg_extractdiag": "linalg_extractdiag",
    "_linalg_gemm": "linalg_gemm", "_linalg_gemm2": "linalg_gemm2",
    "_linalg_potrf": "linalg_potrf", "_npi_cholesky": "linalg_potrf",
    "_linalg_sumlogdiag": "linalg_sumlogdiag",
    "_linalg_syrk": "linalg_syrk", "_linalg_trsm": "linalg_trsm",
    "_np_broadcast_to": "broadcast_to", "_np_copy": "identity",
    "_np_cumsum": "cumsum", "_np_dot": "dot", "_np_max": "max",
    "_np_min": "min", "_np_ones_like": "ones_like", "_np_prod": "prod",
    "_np_repeat": "repeat", "_np_reshape": "reshape", "_np_roll": "roll",
    "_np_squeeze": "squeeze", "_np_sum": "sum",
    "_np_transpose": "transpose", "_np_zeros_like": "zeros_like",
    "_npi_abs": "abs", "_npi_absolute": "abs", "_npi_add": "add",
    "_npi_add_scalar": "_plus_scalar", "_npi_arccos": "arccos",
    "_npi_arccosh": "arccosh", "_npi_arcsin": "arcsin",
    "_npi_arcsinh": "arcsinh", "_npi_arctan": "arctan",
    "_npi_arctanh": "arctanh", "_npi_argmax": "argmax",
    "_npi_argmin": "argmin", "_npi_cast": "cast", "_npi_cbrt": "cbrt",
    "_npi_ceil": "ceil", "_npi_clip": "clip",
    "_npi_concatenate": "concat", "_npi_cos": "cos", "_npi_cosh": "cosh",
    "_npi_deg2rad": "radians", "_npi_degrees": "degrees",
    "_npi_exp": "exp", "_npi_expand_dims": "expand_dims",
    "_npi_expm1": "expm1", "_npi_fix": "fix", "_npi_flip": "flip",
    "_npi_floor": "floor", "_npi_gather_nd": "gather_nd",
    "_npi_hypot": "hypot", "_npi_log": "log", "_npi_log10": "log10",
    "_npi_log1p": "log1p", "_npi_log2": "log2",
    "_npi_logical_not": "logical_not", "_npi_maximum": "maximum",
    "_npi_mean": "mean", "_npi_minimum": "minimum", "_npi_mod": "mod",
    "_npi_multiply": "multiply", "_npi_multiply_scalar": "_mul_scalar",
    "_npi_negative": "negative", "_npi_power": "power",
    "_npi_power_scalar": "_power_scalar", "_npi_rad2deg": "degrees",
    "_npi_radians": "radians", "_npi_reciprocal": "reciprocal",
    "_npi_reshape": "reshape", "_npi_rint": "rint",
    "_npi_rpower_scalar": "_rpower_scalar",
    "_npi_rsubtract_scalar": "_rminus_scalar",
    "_npi_rtrue_divide_scalar": "_rdiv_scalar", "_npi_sign": "sign",
    "_npi_sin": "sin", "_npi_sinh": "sinh", "_npi_slice": "slice",
    "_npi_split": "split", "_npi_sqrt": "sqrt", "_npi_square": "square",
    "_npi_stack": "stack", "_npi_subtract": "subtract",
    "_npi_subtract_scalar": "_minus_scalar", "_npi_swapaxes": "swapaxes",
    "_npi_take": "take", "_npi_tan": "tan", "_npi_tanh": "tanh",
    "_npi_tile": "tile", "_npi_true_divide": "divide",
    "_npi_true_divide_scalar": "_div_scalar", "_npi_trunc": "trunc",
    "_npx_batch_dot": "batch_dot", "_npx_batch_flatten": "Flatten",
    "_npx_cast": "cast", "_npx_embedding": "embedding",
    "_npx_gamma": "gamma", "_npx_one_hot": "one_hot", "_npx_pick": "pick",
    "_npx_reshape": "reshape", "_npx_slice": "slice", "_npx_topk": "topk",
    "_npi_arange": "_arange",
}


@pytest.mark.parametrize("alias", sorted(CORE_ALIASES))
def test_alias_resolves_as_reference(alias):
    primary = CORE_ALIASES[alias]
    assert jregistry.get_op(alias).name == primary
    assert tregistry.get_op(alias) is tregistry.get_op(primary)


def _own_grads(name, args, kwargs, head):
    """d(sum(out * head))/d(args) through the port's tape."""
    with tmx.cpu():
        xs = [_arr(tmx, a) for a in args]
        for x in xs:
            x.attach_grad()
        with tag.record():
            out = getattr(tnd, name)(*xs, **kwargs)
            out = out[0] if isinstance(out, (list, tuple)) else out
            loss = (out * tnd.array(head, dtype="float32")).sum()
        loss.backward()
        return [x.grad.asnumpy() for x in xs]


def _ref_grads(name, args, kwargs, head):
    """The same gradient of the reference op's function, under one
    ``jax.jit`` (its eager tape compiles every primitive apart)."""
    fn = jregistry.get_op(name).fn

    def loss(*xs):
        out = fn(*xs, **kwargs)
        out = out[0] if isinstance(out, (list, tuple)) else out
        return jnp.sum(out * jnp.asarray(head))

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in grads]


GRAD_CASES = [
    ("gemm2", "linalg_gemm2", [_n(2, 3, 4), _n(2, 4, 5, seed=1)],
     {"transpose_b": False}, (2, 3, 5)),
    ("gemm", "linalg_gemm", [_n(3, 4), _n(4, 2, seed=1), _n(3, 2, seed=2)],
     {"alpha": 1.5, "beta": 0.5}, (3, 2)),
    ("potrf", "linalg_potrf", [_spd(4)], {}, (4, 4)),
    ("syrk", "linalg_syrk", [_n(3, 4)], {"alpha": 2.0}, (3, 3)),
    ("trsm", "linalg_trsm", [_lower(4), _n(4, 2, seed=1)], {}, (4, 2)),
    ("sumlogdiag", "linalg_sumlogdiag", [_spd(3, (2,))], {}, (2,)),
    ("sort", "sort", [_n(3, 7)], {"is_ascend": False}, (3, 7)),
    ("topk", "topk", [_n(3, 7)], {"k": 3, "ret_typ": "value"}, (3, 3)),
    ("cumsum", "cumsum", [_n(3, 5)], {"axis": 1}, (3, 5)),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_reference(case):
    """Tolerance: within 1e-5 of each gradient's largest |value|."""
    _, name, args, kwargs, hshape = case
    head = _n(*hshape, seed=7)
    check("linalg", _own_grads(name, args, kwargs, head),
          _ref_grads(name, args, kwargs, head))


def test_case_names_cover_every_new_core_op():
    """Every primary op of the reference's core.py that this file ports
    has a value case above."""
    covered = {c[1] for c in CASES}
    ported = {"rint", "fix", "cbrt", "rcbrt", "gamma", "gammaln", "erfinv",
              "digamma", "arcsinh", "arccosh", "arctanh", "degrees",
              "radians", "hypot", "fmod", "isnan", "isinf", "isfinite",
              "logical_and", "logical_or", "logical_xor", "logical_not",
              "sort", "argsort", "topk", "cumsum", "nansum", "nanprod",
              "roll", "depth_to_space", "space_to_depth", "scatter_nd",
              "shape_array", "size_array", "diag", "khatri_rao",
              "amp_cast", "amp_multicast", "linalg_gemm2", "linalg_gemm",
              "linalg_potrf", "linalg_syrk", "linalg_trsm",
              "linalg_sumlogdiag", "linalg_extractdiag"}
    assert ported <= covered, json.dumps(sorted(ported - covered))
