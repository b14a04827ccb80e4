"""Shared helpers of the port's op-parity tests: the reference's results of
many cases computed at once, and the comparison of a port result with a
reference one.

``reference_results(cases)`` runs each case's reference function (a
function of no arguments returning jax arrays, tuples of them, or Python
scalars) 40 at a time under one ``jax.jit`` when it traces, and eagerly
otherwise (a value-dependent shape, a host callback). One XLA compile a
chunk instead of one an op keeps the test files cheap; jit fuses, so a
case's tolerance must allow an ulp or two where the reference's rounding
order is not fixed.
"""
import jax
import numpy as onp
import torch


def _plain(out):
    if isinstance(out, (tuple, list)):
        return [_plain(o) for o in out]
    return out._data if hasattr(out, "_data") else out


def _eager(cases, name):
    try:
        return _plain(cases[name]())
    except Exception as e:     # the case's own test re-raises it
        return e


def reference_results(cases, chunk=40, probe=True):
    """``{name: result}`` for ``cases`` (``{name: thunk}``), ``chunk``
    cases a compile (XLA's compile time grows faster than the program:
    files of heavy cases take smaller chunks). With ``probe`` each case is
    traced once first (``jax.eval_shape``) to find the ones that cannot
    be; without it a chunk that fails to trace runs its cases one by one,
    each under its own ``jax.jit`` or else eagerly (one trace per case
    fewer when nearly all trace)."""
    names = sorted(cases)
    eager = []
    if probe:
        traced = []
        for name in names:
            try:
                jax.eval_shape(lambda f=cases[name]: _plain(f()))
                traced.append(name)
            except Exception:
                eager.append(name)
        names = traced
    res = {}
    for i in range(0, len(names), chunk):
        part = names[i:i + chunk]
        try:
            outs = jax.jit(lambda: [_plain(cases[n]()) for n in part])()
        except Exception:
            if probe:
                raise
            outs = []
            for n in part:
                try:
                    outs.append(jax.jit(lambda n=n: _plain(cases[n]()))())
                except Exception:
                    outs.append(_eager(cases, n))
        res.update(zip(part, outs))
    for name in eager:
        res[name] = _eager(cases, name)
    return res


def result(results, name):
    """A case's reference result (raising the error its run raised)."""
    out = results[name]
    if isinstance(out, Exception):
        raise out
    return out


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    a = onp.asarray(x)
    return a.astype(onp.float32) if a.dtype.name == "bfloat16" else a


def dtype_of(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if hasattr(x, "dtype"):
        return str(x.dtype)
    return type(x).__name__


def flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(got, want, rtol=1e-5, atol=1e-6, what="", dtypes=True):
    """Dtype, shape and values (integers and booleans exactly)."""
    got, want = flat(got), flat(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        if dtypes:
            assert dtype_of(g) == dtype_of(w), (what, k, dtype_of(g),
                                                dtype_of(w))
        gv, wv = to_numpy(g), to_numpy(w)
        assert gv.shape == wv.shape, (what, k, gv.shape, wv.shape)
        if wv.dtype.kind in "biu":
            onp.testing.assert_array_equal(gv, wv, err_msg=what)
        else:
            onp.testing.assert_allclose(gv.astype(onp.float64),
                                        wv.astype(onp.float64), rtol=rtol,
                                        atol=atol, err_msg=what)
