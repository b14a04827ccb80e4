"""``mx.np.random`` (counterpart of ``mxnet_tpu/numpy/random.py``): numpy's
samplers over the framework's key service. Each call takes fresh key words
(``mxnet_tpu_torch.random.next_key``) and draws on its context's device
from the samplers' generator (``ops.random_ops.generator_for``), so
``seed`` repeats a sequence. Threefry is not ported: the draws match the
reference's in distribution and in dtype (``uniform``, ``normal`` float32;
``randint``, ``poisson``, ``multinomial`` int64; ``logistic``, ``gumbel``
and ``lognormal`` float64, as jax's samplers give under x64)."""
from __future__ import annotations

import numpy as _onp
import torch

from .. import random as _rnd
from ..base import dtype_np  # noqa: F401
from ..base import torch_dtype as _torch_dtype
from ..ndarray.ndarray import NDArray as _NDArrayBase
from ..ops.random_ops import generator_for as _generator_for


def _np():
    from .. import numpy as np_mod
    return np_mod


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _draw(ctx):
    """The device and generator of one draw."""
    dev = _np()._device(ctx)
    return dev, _generator_for(dev, _rnd.next_key())


def _out(v, out=None):
    res = _np().ndarray(v)
    if out is not None:
        from .. import _tape
        _tape.assign(out, v)
        return out
    return res


def _param(x, dev):
    return x._data.to(dev).float() if isinstance(x, _NDArrayBase) else x


def seed(seed=None):
    _rnd.seed(seed if seed is not None else _onp.random.randint(2 ** 31))


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, out=None):
    dev, gen = _draw(ctx)
    u = torch.rand(_shape(size), generator=gen, device=dev)
    v = _param(low, dev) + u * (_param(high, dev) - _param(low, dev))
    return _out(v.to(_torch_dtype(dtype or "float32")), out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    dev, gen = _draw(ctx)
    n = torch.randn(_shape(size), generator=gen, device=dev)
    v = _param(loc, dev) + _param(scale, dev) * n
    return _out(v.to(_torch_dtype(dtype or "float32")), out)


def randn(*size):
    return normal(size=size or None)


def rand(*size):
    return uniform(size=size or None)


def randint(low, high=None, size=None, dtype=None, ctx=None, out=None):
    if high is None:
        low, high = 0, low
    dev, gen = _draw(ctx)
    v = torch.randint(int(low), int(high), _shape(size), generator=gen,
                      device=dev)
    return _out(v.to(_torch_dtype(dtype or "int64")), out)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    from ..ops.numpy_ops import _npi_choice
    dev = a._data.device if isinstance(a, _NDArrayBase) else \
        _np()._device(ctx)
    pool = a._data if isinstance(a, _NDArrayBase) else (
        torch.as_tensor(_onp.asarray(a), device=dev)
        if not isinstance(a, int) else a)
    pv = p._data if isinstance(p, _NDArrayBase) else p
    from ..context import Context
    v = _npi_choice.fn(pool, _shape(size), replace, pv,
                    ctx=Context.from_device(dev), key=_rnd.next_key())
    return _out(v.to(torch.int64) if not isinstance(pool, torch.Tensor)
                else v, out)


def shuffle(x):
    """Permute ``x`` along its first axis, in place, on its device."""
    from .. import _tape
    gen = _generator_for(x._data.device, _rnd.next_key())
    perm = torch.randperm(x.shape[0], generator=gen, device=x._data.device)
    _tape.assign(x, x._data[perm])


def permutation(x):
    if isinstance(x, int):
        dev, gen = _draw(None)
        return _np().ndarray(torch.randperm(x, generator=gen, device=dev))
    xv = x._data if isinstance(x, _NDArrayBase) else \
        torch.as_tensor(_onp.asarray(x), device=_np()._device())
    gen = _generator_for(xv.device, _rnd.next_key())
    perm = torch.randperm(xv.shape[0], generator=gen, device=xv.device)
    return _np().ndarray(xv[perm])


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    dev, gen = _draw(ctx)
    alpha = torch.full(_shape(size), float(shape), device=dev)
    v = torch._standard_gamma(alpha, generator=gen) * scale
    return _out(v.to(_torch_dtype(dtype or "float32")), out)


def beta(a, b, size=None, dtype=None, ctx=None):
    dev, gen = _draw(ctx)
    x = torch._standard_gamma(torch.full(_shape(size), float(a),
                                         device=dev), generator=gen)
    y = torch._standard_gamma(torch.full(_shape(size), float(b),
                                         device=dev), generator=gen)
    return _np().ndarray((x / (x + y)).to(_torch_dtype(dtype or "float32")))


def exponential(scale=1.0, size=None, dtype=None, ctx=None, out=None):
    dev, gen = _draw(ctx)
    v = torch.empty(_shape(size), device=dev).exponential_(generator=gen)
    return _out((v * scale).to(_torch_dtype(dtype or "float32")), out)


def poisson(lam=1.0, size=None, dtype=None, ctx=None, out=None):
    dev, gen = _draw(ctx)
    v = torch.poisson(torch.full(_shape(size), float(lam), device=dev),
                      generator=gen)
    return _out(v.to(torch.int64), out)


def multinomial(n, pvals, size=None):
    from ..ops.numpy_ops import _npi_multinomial
    pv = pvals._data if isinstance(pvals, _NDArrayBase) else \
        torch.as_tensor(_onp.asarray(pvals, dtype=_onp.float64),
                        device=_np()._device())
    return _np().ndarray(_npi_multinomial.fn(int(n), pv, _shape(size),
                                          key=_rnd.next_key()))


def _float64_draw(ctx, size, transform):
    dev, gen = _draw(ctx)
    u = torch.rand(_shape(size), generator=gen, device=dev,
                   dtype=torch.float64)
    tiny = torch.finfo(torch.float64).tiny
    return transform(u.clamp(min=tiny, max=1 - 2 ** -53))


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    v = _float64_draw(ctx, size, lambda u: torch.log(u) - torch.log1p(-u))
    return _out(loc + scale * v, out)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    v = _float64_draw(ctx, size, lambda u: -torch.log(-torch.log(u)))
    return _out(loc + scale * v, out)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, ctx=None,
              out=None):
    dev, gen = _draw(ctx)
    n = torch.randn(_shape(size), generator=gen, device=dev,
                    dtype=torch.float64)
    return _out(torch.exp(mean + sigma * n), out)
