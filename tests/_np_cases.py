"""The cases of the ``mx.np`` parity tests
(``test_torch_numpy_functions.py``, ``test_torch_numpy_linalg.py``): the
inputs and one case per public function (a function of the module and its
arrays), from ``chip_smoke.py``'s np phase, which runs the same cases on
the card; the reference's results computed in jit chunks; and the
comparison. A case's result must have the reference's dtype and shape,
and its values within rtol 1e-5 and atol 1e-6 of the reference's (exact
for integer and boolean results; rtol 1e-4 for the cases marked
``"loose"``, products of several float32 roundings)."""
import functools
import os
import sys

import numpy as onp
import pytest

import jax
import jax.numpy as jjnp
import mxnet_tpu.numpy as jnp_

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (NP_BINARY, NP_UNARY, np_arrays, np_cases,  # noqa
                        np_host)


HOST = np_host("small")
U, B = NP_UNARY, NP_BINARY


def _arrays(np):
    return np_arrays(np, HOST)

CASES = np_cases()


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _compare(got, want, kind, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        if not hasattr(w, "dtype") or not hasattr(w, "asnumpy"):
            assert g == pytest.approx(w, rel=1e-5), what
            continue
        assert str(g.dtype) == str(w.dtype), (what, g.dtype, w.dtype)
        assert tuple(g.shape) == tuple(w.shape), (what, g.shape, w.shape)
        gv, wv = g.asnumpy(), w.asnumpy()
        if wv.dtype.kind in "biu":
            onp.testing.assert_array_equal(gv, wv, err_msg=what)
        else:
            rtol = 1e-4 if kind == "loose" else 1e-5
            onp.testing.assert_allclose(gv.astype(onp.float64),
                                        wv.astype(onp.float64), rtol=rtol,
                                        atol=1e-6, err_msg=what)


def _handles(vals):
    return {k: jnp_.ndarray(v) for k, v in zip(HOST, vals)}


def _plain(out):
    if isinstance(out, (tuple, list)):
        return [_plain(o) for o in out]
    return out._data if hasattr(out, "_data") else out


@functools.lru_cache(maxsize=None)
def reference_results(names):
    """The reference results of ``names`` (a tuple), computed once: the
    cases that trace
    run 50 at a time under ``jax.jit`` (a few XLA compiles instead of one
    a function; values within the cases' tolerances of the eager ones),
    the value-dependent ones eagerly."""
    vals = [jjnp.asarray(v, dtype=d) for v, d in HOST.values()]
    traced, eager = [], []
    for name in names:
        fn = CASES[name][0]
        try:
            jax.eval_shape(lambda *vs: _plain(fn(jnp_, _handles(vs))), *vals)
            traced.append(name)
        except Exception:
            eager.append(name)
    res = {}
    for i in range(0, len(traced), 50):    # XLA compiles 50 at a time fast
        part = traced[i:i + 50]
        outs = jax.jit(lambda *vs: [_plain(CASES[n][0](jnp_, _handles(vs)))
                                    for n in part])(*vals)
        res.update(zip(part, outs))
    for name in eager:
        try:
            res[name] = _plain(CASES[name][0](jnp_, _arrays(jnp_)))
        except Exception as e:     # the case's own test re-raises it
            res[name] = e
    return res


def run_case(np_mod, case, names):
    """The port's result of ``case`` against the reference's (computed
    with the other ``names`` of its file)."""
    fn, kind = CASES[case]
    want = reference_results(names)[case]
    if isinstance(want, Exception):
        raise want
    want = _as_handles(want)
    got = fn(np_mod, _arrays(np_mod))
    _compare(got, want, kind, case)


def _as_handles(out):
    if isinstance(out, (tuple, list)):
        return [_as_handles(o) for o in out]
    return jnp_.ndarray(out) if hasattr(out, "dtype") else out


