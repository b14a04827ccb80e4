"""Test utilities.

Counterpart of ``mxnet_tpu/test_utils.py`` (the reference's
``python/mxnet/test_utils.py`` surface): ``assert_almost_equal``,
``check_numeric_gradient`` (central finite differences against the
autograd backward), ``check_consistency`` (one function on several
contexts: the CPU against the card by default when there is one),
``rand_ndarray`` and the shape helpers.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd as ag
from .context import Context, cpu, current_context, gpu
from .ndarray.ndarray import NDArray, array

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
           "rand_shape_nd", "check_numeric_gradient", "check_consistency",
           "DummyIter", "same", "list_gpus"]

_default_ctx = None


def default_context() -> Context:
    return _default_ctx or current_context()


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def _host(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")):
    np.testing.assert_allclose(_host(a), _host(b), rtol=rtol, atol=atol,
                               err_msg="%s vs %s" % names)


def almost_equal(a, b, rtol=1e-5, atol=1e-8):
    return np.allclose(_host(a), _host(b), rtol=rtol, atol=atol)


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None):
    data = np.random.uniform(-1, 1, size=shape).astype(dtype or np.float32)
    out = array(data, ctx=ctx)
    if stype != "default":
        out = out.tostype(stype)
    return out


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim).tolist())


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-3, atol=1e-4):
    """The autograd gradient of the scalar ``fn(*inputs)`` against central
    finite differences, input by input. On the card the tolerances are at
    least 1e-2 / 1e-3, as the reference's accelerator checks."""
    inputs = [x if isinstance(x, NDArray) else array(x) for x in inputs]
    if any(x._data.is_cuda for x in inputs):
        rtol, atol = max(rtol, 1e-2), max(atol, 1e-3)
    for x in inputs:
        x.attach_grad()
    with ag.record():
        y = fn(*inputs)
    y.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]
    for i, x in enumerate(inputs):
        base = np.ascontiguousarray(x.asnumpy(), dtype=np.float64)
        num = np.zeros(base.shape, dtype=np.float64)
        flat, nflat = base.ravel(), num.ravel()
        for j in range(flat.size):
            orig = flat[j]
            _set_flat(x, base, j, orig + eps)
            fp = float(fn(*inputs).asnumpy())
            _set_flat(x, base, j, orig - eps)
            fm = float(fn(*inputs).asnumpy())
            _set_flat(x, base, j, orig)
            nflat[j] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(analytic[i], num, rtol=rtol, atol=atol,
                                   err_msg="gradient mismatch for input %d"
                                   % i)


def _set_flat(x, base, j, val):
    """``x`` (in place, on its device) set to ``base`` with element ``j``
    replaced by ``val``."""
    b = base.copy()
    b.ravel()[j] = val
    with torch.no_grad():
        x._data.copy_(torch.from_numpy(b).to(x._data.dtype))


def check_consistency(fn, inputs, ctxs=None, rtol=1e-4, atol=1e-6):
    """``fn`` over copies of ``inputs`` on each context in ``ctxs`` (the
    CPU and ``gpu(0)`` when the card is there, else the CPU alone); every
    output of every context is held to the first context's. Returns the
    outputs as numpy arrays, a list a context."""
    if ctxs is None:
        ctxs = [cpu(0)] + ([gpu(0)] if torch.cuda.is_available() else [])
    outs = []
    for ctx in ctxs:
        with ctx:
            res = fn(*[x.as_in_context(ctx) for x in inputs])
        res = res if isinstance(res, (list, tuple)) else [res]
        outs.append([_host(r) for r in res])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    return outs


class DummyIter:
    def __init__(self, batches):
        self._batches = batches

    def __iter__(self):
        return iter(self._batches)


def same(a, b):
    """Exact array equality."""
    return np.array_equal(_host(a), _host(b))


def list_gpus():
    """The card ordinals (empty without a card)."""
    return list(range(torch.cuda.device_count()))
