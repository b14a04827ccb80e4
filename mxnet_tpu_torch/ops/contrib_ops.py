"""Contrib and control-flow operators: counterpart of
``mxnet_tpu/ops/contrib_ops.py``.

The control-flow trio takes Python callables over NDArrays, with the
reference's semantics (which are not MXNet 1.6's):

- ``foreach(body, data, init_states)``: ``body(x_t, states)`` returns
  ``(outputs, new_states)``; the result is the outputs stacked on a new
  axis 0 and the final states. One output (or a list of one) comes back
  bare.
- ``while_loop(cond, func, loop_vars, max_iterations=None)``: ``func``
  returns the NEW loop variables (not ``(outputs, states)``), and the
  result is only the final loop variables. ``max_iterations`` is ignored,
  as the reference ignores it.
- ``cond(pred, then_func, else_func)``: the branch's outputs.

Here they are Python loops over the callables, so gradients flow through
autograd wherever the callables' ops record. ``while_loop`` and ``cond``
read a predicate from the device: inside a ``CachedOp`` graph capture they
raise and name themselves. ``foreach`` has a static trip count, so a
capture unrolls it.

The registry ops ``_foreach``, ``_while_loop`` and ``_cond`` run the same
functions and return their results flattened (outputs, then states).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _jnp
from .registry import register

__all__ = ["foreach", "while_loop", "cond", "arange_like", "div_sqrt_dim",
           "smooth_l1"]


def _host_predicate(name):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "%s reads its predicate from the device and cannot run inside a "
            "CachedOp's graph capture; call it eagerly" % name)


def _nd():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _as_list(x):
    return [x] if isinstance(x, _nd()) else list(x)


def foreach(body, data, init_states):
    """Run ``body`` over axis 0 of ``data`` (see the module's text)."""
    NDArray = _nd()
    from ..ndarray.ndarray import stack
    single_data = isinstance(data, NDArray)
    single_state = isinstance(init_states, NDArray)
    data_t = _as_list(data)
    states = _as_list(init_states)
    steps = []
    for t in range(data_t[0].shape[0]):
        xs = [d[t] for d in data_t]
        out, new_states = body(xs[0] if single_data else xs,
                               states[0] if single_state else states)
        steps.append(_as_list(out))
        states = _as_list(new_states)
    outs = [stack(*[s[j] for s in steps], axis=0)
            for j in range(len(steps[0]))] if steps else []
    return (outs[0] if len(outs) == 1 else outs,
            states[0] if single_state else states)


def _truth(value):
    if isinstance(value, _nd()):
        value = value._data
    if isinstance(value, torch.Tensor):
        return bool(value.reshape(-1)[0])
    return bool(value)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Apply ``func`` to the loop variables while ``cond`` holds; the
    final loop variables (see the module's text)."""
    _host_predicate("while_loop")
    single = isinstance(loop_vars, _nd())
    vals = _as_list(loop_vars)
    while _truth(cond(*vals)):
        vals = _as_list(func(*vals))
    return vals[0] if single else vals


def cond(pred, then_func, else_func, inputs=None):
    """``then_func()`` if ``pred`` holds, else ``else_func()``."""
    _host_predicate("cond")
    outs = _as_list(then_func() if _truth(pred) else else_func())
    return outs[0] if len(outs) == 1 else outs


def _handles(x):
    NDArray = _nd()
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return [_handles(v) for v in x]
    return x


def _flat_tensors(x):
    if isinstance(x, _nd()):
        return [x._data]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return [x]


@register("_foreach", n_out=0)
def _foreach(body, data, init_states):
    return tuple(_flat_tensors(foreach(body, _handles(data),
                                       _handles(init_states))))


@register("_while_loop", n_out=0)
def _while_loop(cond, func, loop_vars, max_iterations=None):
    return tuple(_flat_tensors(while_loop(cond, func, _handles(loop_vars),
                                          max_iterations)))


@register("_cond", n_out=0)
def _cond(pred, then_func, else_func, inputs=None):
    return tuple(_flat_tensors(cond(_handles(pred), then_func, else_func)))


# ---- small contrib ops ----------------------------------------------------


@register("_contrib_arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * arange(n)`` in ``data``'s dtype (jnp's rules), over
    all of ``data`` reshaped to its shape, or along ``axis``."""
    n = data.numel() if axis is None else data.shape[axis]
    r = torch.arange(n, dtype=data.dtype, device=data.device)
    r = r.to(_jnp.result_dtype("promote", r, step)) * step
    out = r.to(_jnp.result_dtype("promote", r, start)) + start
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``, the divisor rounded to ``data``'s
    dtype."""
    d = torch.tensor(math.sqrt(data.shape[-1]), dtype=torch.float64)
    return data / d.to(data.dtype).to(data.device)


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """``0.5 (s x)^2`` where ``|x| < 1/s^2``, else ``|x| - 0.5/s^2``."""
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)
