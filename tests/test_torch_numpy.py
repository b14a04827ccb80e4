"""``mx.np``, ``np.linalg``, ``np.random`` and ``mx.npx`` of the port
against the JAX package's, on the CPU.

- The dtype grid: bool, uint8, int8, int32, int64, float16, bfloat16,
  float32 and float64 arrays and Python bool/int/float scalars through
  ``add``, ``multiply``, ``true_divide``, ``power`` and ``less``, each
  array through ``sum``, ``mean``, ``prod``, ``cumsum`` and ``argmax``,
  and every creation function's default (the operators' grid is in
  ``test_torch_numpy_runtime.py``): the port's dtype
  equals the reference's on every cell. The reference's dtype is read by
  running its own function under ``jax.eval_shape`` (no compile); the
  values are held on the cells with small integers (exact, or 1e-2
  relative in float16/bfloat16; a negative integer power is left out,
  which XLA leaves undefined).
- The name gate: every public callable of the reference's four modules
  exists in the port's counterpart.
- The dispatch protocol (``numpy.sum`` of an ``mx.np`` array, a ufunc
  with ``out=``), jnp's out-of-range indices (``x[idx]`` clamps, ``take``
  and ``take_along_axis`` fill, ``put_along_axis`` drops, exactly), the
  boolean-mask assigns, saturating casts and the utilities
  (``allclose``, ``copyto``, ...). The ``ndarray`` at run time and
  ``np.random`` are in ``test_torch_numpy_runtime.py``, the functions in
  ``test_torch_numpy_functions.py`` and ``test_torch_numpy_linalg.py``.
"""
import inspect
import os

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jjnp
import ml_dtypes
import mxnet_tpu as jmx
import mxnet_tpu.numpy as jnp_
import mxnet_tpu.numpy_extension as jnpx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

from _parity import compare, reference_results, result

tnp = tmx.np
tnpx = tmx.npx

DTYPES = ["bool", "uint8", "int8", "int32", "int64", "float16", "bfloat16",
          "float32", "float64"]
SCALARS = {"pyb": True, "pyi": 2, "pyf": 1.5}
RTOL, ATOL = 1e-5, 1e-6
# the grid's cells whose values are held too (the issue's table's rows)
VALUE_CELLS = {("int32", "pyf"), ("float32", "int32"), ("uint8", "int8")}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _host(d, n=6, seed=0):
    rng = onp.random.default_rng(seed)
    lo = 0 if d in ("bool", "uint8") else -3
    v = rng.integers(lo, 4, n).astype(onp.float64)
    return v.astype(ml_dtypes.bfloat16 if d == "bfloat16" else d)


def _spec(d):
    return jax.ShapeDtypeStruct((6,), jjnp.dtype(d))


# ---- the dtype grid --------------------------------------------------------

@pytest.mark.parametrize("fn", ["add", "multiply", "true_divide", "power",
                                "less"])
def test_dtype_grid_binary(fn):
    for d1 in DTYPES:
        a = _host(d1, seed=1)
        for d2 in DTYPES + list(SCALARS):
            s = SCALARS.get(d2)
            b = _host(d2, seed=2) if s is None else s

            def ref(x, y=None):
                return getattr(jnp_, fn)(jnp_.ndarray(x), s if y is None
                                         else jnp_.ndarray(y))._data
            try:
                want = jax.eval_shape(ref, _spec(d1),
                                      None if s is not None else _spec(d2))
            except (TypeError, ValueError):
                with pytest.raises((TypeError, ValueError, RuntimeError)):
                    getattr(tnp, fn)(tnp.array(a, dtype=d1), b if s is not None
                                     else tnp.array(b, dtype=d2))
                continue
            got = getattr(tnp, fn)(tnp.array(a, dtype=d1), b if s is not None
                                   else tnp.array(b, dtype=d2))
            assert str(got.dtype) == str(want.dtype), (fn, d1, d2)
            if (d1, d2) in VALUE_CELLS and not (
                    fn == "power" and "int" in str(want.dtype)):
                r = getattr(jnp_, fn)(jnp_.array(a, dtype=d1), b if s is not
                                      None else jnp_.array(b, dtype=d2))
                onp.testing.assert_allclose(
                    got.asnumpy().astype(onp.float64),
                    r.asnumpy().astype(onp.float64), rtol=1e-2
                    if "16" in str(want.dtype) else RTOL)


@pytest.mark.parametrize("fn", ["sum", "mean", "prod", "cumsum", "argmax"])
def test_dtype_grid_reductions(fn):
    for d in DTYPES:
        a = _host(d, seed=3)
        want = jax.eval_shape(
            lambda x: getattr(jnp_, fn)(jnp_.ndarray(x))._data, _spec(d))
        got = getattr(tnp, fn)(tnp.array(a, dtype=d))
        assert str(got.dtype) == str(want.dtype), (fn, d)
        if d in ("bool", "int32", "bfloat16"):
            r = getattr(jnp_, fn)(jnp_.array(a, dtype=d)).asnumpy()
            onp.testing.assert_allclose(got.asnumpy().astype(onp.float64),
                                        r.astype(onp.float64), rtol=1e-2)


CREATION = {
    "ones": lambda np: np.ones(3), "zeros": lambda np: np.zeros((2,)),
    "empty": lambda np: np.empty(2), "full_int": lambda np: np.full(2, 1),
    "full_float": lambda np: np.full(2, 1.5),
    "full_bool": lambda np: np.full(2, True),
    "arange_int": lambda np: np.arange(3),
    "arange_float": lambda np: np.arange(3.0),
    "arange_step": lambda np: np.arange(0, 1, 0.25),
    "linspace": lambda np: np.linspace(0, 1, 5),
    "logspace": lambda np: np.logspace(0, 1, 5),
    "eye": lambda np: np.eye(3, 4, 1), "identity": lambda np: np.identity(2),
    "tri": lambda np: np.tri(3), "indices": lambda np: np.indices((2, 3)),
    "array_int": lambda np: np.array([1, 2]),
    "array_float": lambda np: np.array([1.0, 2.0]),
    "array_bool": lambda np: np.array([True, False]),
    "array_np_int64": lambda np: np.array(onp.array([1, 2])),
    "array_np_float64": lambda np: np.array(onp.array([1.0])),
    "array_np_int32": lambda np: np.array(onp.array([1], onp.int32)),
    "array_dtype": lambda np: np.array([1, 2], dtype="float64"),
    "asarray": lambda np: np.asarray([1.5, 2.5]),
    "hanning": lambda np: np.hanning(5), "hamming": lambda np: np.hamming(5),
    "blackman": lambda np: np.blackman(5),
    "bartlett": lambda np: np.bartlett(5),
    "kaiser": lambda np: np.kaiser(5, 2.0),
    "zeros_like": lambda np: np.zeros_like(np.array([1, 2]), dtype="int32"),
    "ones_like": lambda np: np.ones_like(np.arange(3)),
    "full_like": lambda np: np.full_like(np.array(onp.arange(3, dtype=onp
                                                             .int32)), 1.5),
    "fromfunction": lambda np: np.fromfunction(lambda i, j: i + j, (2, 2)),
    "frombuffer": lambda np: np.frombuffer(b"\x01\x02", dtype=onp.uint8),
}


@pytest.fixture(scope="module")
def creation_reference():
    return reference_results({c: (lambda c=c: CREATION[c](jnp_))
                              for c in CREATION})


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation_defaults(case, creation_reference):
    r, o = result(creation_reference, case), CREATION[case](tnp)
    compare(o, r, rtol=RTOL, atol=ATOL, what=case)


# ---- the name gate ---------------------------------------------------------

def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_") and
            callable(getattr(mod, n)) and
            not inspect.ismodule(getattr(mod, n))}


@pytest.mark.parametrize("ref,own", [
    (jnp_, tnp), (jnp_.linalg, tnp.linalg), (jnp_.random, tnp.random),
    (jnpx, tnpx)], ids=["np", "np.linalg", "np.random", "npx"])
def test_public_callables_exist(ref, own):
    assert _public(ref) - _public(own) == set()


# ---- dispatch protocol, indices, the subclass --------------------------------

def test_dispatch_protocol():
    x = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    a, r = tnp.array(x), jnp_.array(x)
    got = onp.sum(a, axis=1)
    assert isinstance(got, tnp.ndarray)
    onp.testing.assert_array_equal(got.asnumpy(),
                                   onp.sum(r, axis=1).asnumpy())
    assert isinstance(onp.linalg.norm(a), tnp.ndarray)
    out = tnp.zeros((2, 3), dtype="float32")
    res = onp.add(a, a, out=out)
    assert res is out
    onp.testing.assert_array_equal(out.asnumpy(), 2 * x)
    ro = jnp_.zeros((2, 3), dtype="float32")
    onp.multiply(r, r, out=ro)
    onp.multiply(a, a, out=out)
    onp.testing.assert_array_equal(out.asnumpy(), ro.asnumpy())


INDEX_CASES = {
    "getitem_clamps": lambda np, a, i: a[i],
    "getitem_columns": lambda np, a, i: a[:, i],
    "getitem_pair": lambda np, a, i: a[i, i],
    "take_fills": lambda np, a, i: np.take(a, i),
    "take_axis_fills": lambda np, a, i: np.take(a, i, axis=1),
    "take_along_axis_fills": lambda np, a, i: np.take_along_axis(
        a, np.reshape(i, (1, 4)), 1),
    "take_int_fills": lambda np, a, i: np.take(a.astype("int32"), i),
    "batch_take": None,
}


IDX_X = onp.arange(12, dtype=onp.float32).reshape(3, 4)
IDX = onp.array([0, 5, -1, -7])
BATCH_IDX = onp.array([0, 9, -1], onp.float32)


def _index_ref(case):
    if case == "batch_take":
        return lambda: jmx.ops.registry.get_op("batch_take").fn(
            jjnp.asarray(IDX_X), jjnp.asarray(BATCH_IDX))
    return lambda: INDEX_CASES[case](jnp_, jnp_.array(IDX_X),
                                     jnp_.array(IDX, dtype="int64"))


@pytest.fixture(scope="module")
def index_reference():
    return reference_results({c: _index_ref(c) for c in INDEX_CASES})


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_out_of_range_indices(case, index_reference):
    """jnp's gathers: ``x[idx]`` wraps a negative index once and clamps;
    ``take``/``take_along_axis`` wrap ``[-n, 0)`` and fill outside."""
    if case == "batch_take":
        got = tnd.batch_take(tnd.array(IDX_X), tnd.array(BATCH_IDX))
    else:
        got = INDEX_CASES[case](tnp, tnp.array(IDX_X),
                                tnp.array(IDX, dtype="int64"))
    compare(got, result(index_reference, case), rtol=0, atol=0, what=case)


def test_put_along_axis_and_bool_index():
    x = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    ti = onp.array([[0, 7], [1, -1], [-9, 2]])
    vals = onp.full((3, 2), -1.0, onp.float32)
    r, o = jnp_.array(x), tnp.array(x)
    jnp_.put_along_axis(r, jnp_.array(ti, dtype="int64"), jnp_.array(vals),
                        1)
    tnp.put_along_axis(o, tnp.array(ti, dtype="int64"), tnp.array(vals), 1)
    onp.testing.assert_array_equal(o.asnumpy(), r.asnumpy())
    m = onp.array([True, False, True])
    onp.testing.assert_array_equal(
        o[tnp.array(m)].asnumpy(), r[jnp_.array(m)].asnumpy())


def test_mask_assigns_match_the_reference():
    d = onp.arange(6, dtype=onp.float32)
    m = onp.array([1, 0, 1, 0, 0, 1], onp.float32)
    for args, kw in (((onp.array([7.0, 8.0, 9.0], onp.float32),), {}),
                     ((onp.full(6, 5.0, onp.float32),), {}),
                     ((onp.array([4.0], onp.float32),), {})):
        want = jmx.nd._npi_boolean_mask_assign_tensor(
            jmx.nd.array(d), jmx.nd.array(m), jmx.nd.array(args[0]))
        got = tnd._npi_boolean_mask_assign_tensor(
            tnd.array(d), tnd.array(m), tnd.array(args[0]))
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    want = jmx.nd._npi_boolean_mask_assign_scalar(
        jmx.nd.array(d), jmx.nd.array(m), value=3.5)
    got = tnd._npi_boolean_mask_assign_scalar(tnd.array(d), tnd.array(m),
                                              value=3.5)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_astype_saturates_as_jnp():
    x = onp.array([300.7, -5.2, onp.nan, 254.9, 1e10, -1e10, 0.99],
                  onp.float32)
    for d in ("uint8", "int8", "int32", "bool"):
        onp.testing.assert_array_equal(
            tnp.array(x).astype(d).asnumpy(),
            jnp_.array(x).astype(d).asnumpy())


def test_utilities_match_the_reference():
    x = onp.array([[1.0, 2.0], [3.0, 4.0]], onp.float32)
    for np in (jnp_, tnp):
        a = np.array(x)
        assert np.ndim(a) == 2 and np.shape(a) == (2, 2) and \
            np.size(a) == 4 and np.size(a, 1) == 2
        assert np.isscalar(1.0) and not np.isscalar(a)
        assert np.allclose(a, a + 1e-9) and not np.allclose(a, a + 1)
        assert np.array_equal(a, np.array(x)) and \
            not np.array_equal(a, a.T)
        assert not np.may_share_memory(a, a) and \
            not np.shares_memory(a, a)
        assert np.result_type(a, np.array(x, dtype="float64")) == \
            onp.float64
        onp.testing.assert_array_equal(np.asnumpy(a), x)
    d = tnp.zeros((2, 2), dtype="float32")
    tnp.copyto(d, tnp.array(x), where=tnp.array([[True, False],
                                                 [False, True]]))
    onp.testing.assert_array_equal(d.asnumpy(), [[1.0, 0.0], [0.0, 4.0]])
    r = jnp_.zeros((2, 2), dtype="float32")
    jnp_.copyto(r, jnp_.array(x), where=jnp_.array([[True, False],
                                                    [False, True]]))
    onp.testing.assert_array_equal(d.asnumpy(), r.asnumpy())
