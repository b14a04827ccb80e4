"""Random keys: the key discipline of ``mxnet_tpu/random.py``.

The reference keeps a thread-local JAX key that :func:`seed` sets and every
random op splits (``next_key``); its Dropout op mixes the key's two uint32
words into a lowbias32 counter hash (``ops/nn.py:_hash_keep_mask``). The
port keeps the same discipline over a thread-local CPU ``torch.Generator``:
:func:`seed` sets it, and :func:`next_key` draws two uint32 words from it
(or from an explicit generator).

Threefry is not ported. The words that :func:`next_key` draws for a seed
therefore differ from the reference's, so a run with dropout matches the
reference only when both are fed the same key words; the port's Dropout op
and the tests take the words explicitly for that.

The samplers (:func:`uniform`, :func:`normal`, :func:`randint`,
:func:`gamma`, ... as in ``mxnet_tpu/random.py``) call the registry's
sampler ops (``ops/random_ops.py``): each binds a key from
:func:`next_key` and draws on the context's device (the current context
when none is given), on the card there. They match the reference in
distribution, not in values. :func:`seed` repeats every draw that follows
it, and the replays of a CUDA graph that samples.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import torch_dtype

__all__ = ["seed", "next_key", "default_generator", "uniform", "normal",
           "randn", "randint", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "bernoulli"]

_state = threading.local()


def default_generator():
    """This thread's generator (CPU), seeded from the OS at first use, as
    the reference seeds its key from ``np.random`` until :func:`seed`."""
    gen = getattr(_state, "generator", None)
    if gen is None:
        gen = torch.Generator()
        gen.seed()
        _state.generator = gen
    return gen


def seed(seed_state, ctx="all"):
    """Parity with ``mx.random.seed``: reseed this thread's generator,
    numpy's global state (as the reference does) and every device's
    sampler generator (what a replayed CUDA graph draws from). ``ctx`` is
    accepted for parity: one seed serves every device."""
    from .ops.random_ops import reseed_devices
    default_generator().manual_seed(int(seed_state))
    np.random.seed(int(seed_state) % (2 ** 32))
    reseed_devices(int(seed_state))


def next_key(generator=None):
    """Two uint32 key words ``(s0, s1)`` as Python ints, drawn from
    ``generator`` (this thread's generator when None)."""
    gen = default_generator() if generator is None else generator
    words = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=gen,
                          device=gen.device)
    s0, s1 = words.tolist()
    return s0, s1


# ---- samplers: the registry's sampler ops (ops/random_ops.py), which bind
# a fresh key at each call ------------------------------------------------


def _op(name):
    from .ops.registry import get_op
    return get_op(name)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    return _op("_random_uniform")(low=low, high=high, shape=shape,
                                  dtype=dtype, ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    return _op("_random_normal")(loc=loc, scale=scale, shape=shape,
                                 dtype=dtype, ctx=ctx, out=out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape, dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None,
            **kw):
    if high is None:
        low, high = 0, low
    return _op("_random_randint")(low=low, high=high, shape=shape,
                                  dtype=dtype, ctx=ctx, out=out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    return _op("_random_gamma")(alpha=alpha, beta=beta, shape=shape,
                                dtype=dtype, ctx=ctx, out=out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    """Exponential draws of mean ``scale`` (rate ``1 / scale``)."""
    return _op("_random_exponential")(lam=1.0 / scale, shape=shape,
                                      dtype=dtype, ctx=ctx, out=out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return _op("_random_poisson")(lam=lam, shape=shape, dtype=dtype,
                                  ctx=ctx, out=out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return _op("_random_negative_binomial")(k=k, p=p, shape=shape,
                                            dtype=dtype, ctx=ctx, out=out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None,
                                  **kw):
    """NB(k, p) with ``k = 1 / alpha`` and ``p = k / (k + mu)``."""
    k = 1.0 / alpha
    return negative_binomial(k=k, p=k / (k + mu), shape=shape, dtype=dtype,
                             ctx=ctx, out=out)


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    """Category draws from the probability vector ``data`` (or from each
    row of a matrix): ``shape`` draws (one without it); with ``get_prob``
    also each draw's log-probability (of ``max(p, 1e-37)``)."""
    from .ndarray.ndarray import NDArray
    probs = data._data if isinstance(data, NDArray) else \
        torch.as_tensor(np.asarray(data, np.float32))
    from .ops.random_ops import _shape
    shp = _shape(shape)
    n = int(np.prod(shp)) if shp else 1
    samp, lp = _op("_sample_multinomial")(NDArray(probs), shape=(n,),
                                          get_prob=True, dtype=dtype)
    lead = tuple(probs.shape[:-1])
    out = NDArray(samp._data.reshape(lead + (shp or ())))
    if get_prob:
        logits = torch.log(torch.clamp(probs, min=1e-37))
        idx = samp._data.reshape(lead + (-1,)).long()
        return out, NDArray(torch.gather(logits, -1, idx).reshape(out.shape))
    return out


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None,
              **kw):
    u = uniform(0.0, 1.0, shape, ctx=ctx)
    val = (u._data < prob).to(u._data.dtype if dtype is None else
                              torch_dtype(dtype))
    if out is not None:
        out._rebind_out(val)
        return out
    return type(u)(val)


def shuffle(data, **kw):
    """``data`` with its first axis permuted, drawn on its device."""
    from .ndarray.ndarray import NDArray
    return _op("_shuffle")(data if isinstance(data, NDArray)
                           else NDArray(torch.as_tensor(data)))
