"""Custom operators written in Python: counterpart of
``mxnet_tpu/operator.py``.

A user subclasses :class:`CustomOpProp` (argument names, shapes, types)
and :class:`CustomOp` (``forward``/``backward`` over NDArrays), registers
the prop with :func:`register` and calls it as ``nd.Custom(...,
op_type=name)`` or ``sym.Custom(...)``. The registry op ``Custom``
(aliases ``_npi_Custom``, ``_npx_Custom``) runs it through a
``torch.autograd.Function``:

- ``forward`` gets NDArrays over the inputs on the op's device (the
  current context is that device while it runs, so ``nd.array`` inside it
  lands there, as MXNet 1.6 hands a custom op its arrays on its context)
  and writes its outputs with :meth:`CustomOp.assign`;
- the backward calls ``backward`` on the same operator instance, so state
  kept on ``self`` in ``forward`` is there; the aux states take no
  gradient;
- ``is_train`` is the training flag (``autograd.train_mode()``, or the
  ``is_train`` of ``Executor.forward``/``Module.forward``);
- on ``meta`` tensors (shape inference at bind) the outputs come from
  the prop's ``infer_shape``/``infer_type``, and nothing runs.

``Custom`` is a host op (``ops.registry.register(host_op=True)``): its
user code may read values to the host, so a ``CachedOp`` whose callable
reaches it runs that signature eagerly instead of capturing a CUDA graph.
Non-tensor keyword arguments reach the prop as strings, as they cross the
C boundary in MXNet; tensor keywords are put in the order of
``list_arguments() + list_auxiliary_states()``
(:func:`normalize_custom_args`). :func:`register_op` registers a plain
function on tensors as a first-class op (the device-speed path).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np
import torch

from . import _tape
from .base import dtype_np, torch_dtype
from .context import Context
from .ops.registry import register as register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get", "register_op",
           "normalize_custom_args"]

_REGISTRY = {}
# bounded: per-step prop kwargs (a stringified lr) must not grow memory
_CACHE_CAP = 512
_PROP_CACHE = OrderedDict()


class CustomOp:
    """Base class of a Python operator's computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """No gradient written by default (``in_grad`` stays zero)."""

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray or array-like) into ``dst`` as
        ``req`` says: ``"write"``/``"inplace"`` replace, ``"add"`` adds,
        ``"null"`` does nothing."""
        if req == "null":
            return
        from .ndarray.ndarray import NDArray
        if isinstance(src, NDArray):
            val = src._data
        else:
            val = torch.as_tensor(_np.asarray(src))
        val = val.detach().to(dst._data.device, dst._data.dtype)
        dst._data = dst._data + val if req == "add" else val


class CustomOpProp:
    """A Python operator's declarations."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator: register a :class:`CustomOpProp` subclass as
    ``op_type=reg_name``; registering a name again replaces the prop."""
    def do_register(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        for key in [k for k in _PROP_CACHE if k[0] == reg_name]:
            del _PROP_CACHE[key]
        return prop_cls
    return do_register


def get(reg_name):
    return _REGISTRY.get(reg_name)


def _prop(op_type, prop_kwargs):
    """The prop of one (op_type, kwargs) configuration, made once."""
    key = (op_type, tuple(sorted((k, repr(v))
                                 for k, v in prop_kwargs.items())))
    prop = _PROP_CACHE.get(key)
    if prop is None:
        prop_cls = _REGISTRY.get(op_type)
        if prop_cls is None:
            raise ValueError(
                "Custom op type %r is not registered; decorate its "
                "CustomOpProp with @mx.operator.register(%r)"
                % (op_type, op_type))
        prop = _PROP_CACHE[key] = prop_cls(**prop_kwargs)
        while len(_PROP_CACHE) > _CACHE_CAP:
            _PROP_CACHE.popitem(last=False)
    return prop


def _out_specs(prop, ins):
    """The outputs' shapes and torch dtypes from the prop."""
    out_shapes = prop.infer_shape([list(t.shape) for t in ins])[1]
    out_types = prop.infer_type([dtype_np(t.dtype) for t in ins])[1]
    return [(tuple(s), torch_dtype(_np.dtype(d).name))
            for s, d in zip(out_shapes, out_types)]


def _handles(tensors):
    from .ndarray.ndarray import NDArray
    return [NDArray(t.detach()) for t in tensors]


class _Custom(torch.autograd.Function):
    """The user's forward and backward around torch's autograd."""

    @staticmethod
    def forward(ctx, prop, is_train, n_args, *tensors):
        from .ndarray.ndarray import NDArray
        ins = tensors[:n_args]
        dev = tensors[0].device
        specs = _out_specs(prop, ins)
        with Context.from_device(dev):
            op = prop.create_operator(
                Context.from_device(dev), [tuple(t.shape) for t in ins],
                [dtype_np(t.dtype) for t in ins])
            in_data, aux = _handles(ins), _handles(tensors[n_args:])
            out_data = [NDArray(torch.zeros(s, dtype=d, device=dev))
                        for s, d in specs]
            op.forward(is_train=is_train, req=["write"] * len(specs),
                       in_data=in_data, out_data=out_data, aux=aux)
        outs = tuple(o._data.detach().to(dev, d).contiguous()
                     for o, (_, d) in zip(out_data, specs))
        ctx.op = op
        ctx.n_args = n_args
        ctx.save_for_backward(*tensors, *outs)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        saved = ctx.saved_tensors
        n_args, n_out = ctx.n_args, len(grads)
        tensors, outs = saved[:-n_out], saved[-n_out:]
        ins = tensors[:n_args]
        dev = ins[0].device
        with Context.from_device(dev):
            in_grad = [NDArray(torch.zeros_like(t)) for t in ins]
            ctx.op.backward(req=["write"] * n_args,
                            out_grad=_handles(grads), in_data=_handles(ins),
                            out_data=_handles(outs), in_grad=in_grad,
                            aux=_handles(tensors[n_args:]))
        ctx.op = None
        gins = tuple(g._data.detach().to(dev, t.dtype)
                     for g, t in zip(in_grad, ins))
        # aux states take no gradient
        return (None, None, None) + gins + (None,) * (len(tensors) - n_args)


def _custom_fn(*tensors, op_type, __is_train__=None, **prop_kwargs):
    """The registered ``Custom`` op."""
    if __is_train__ is None:      # an executor calls the function directly
        __is_train__ = _tape.is_training()
    prop = _prop(op_type, prop_kwargs)
    n_args = len(prop.list_arguments())
    n_out = len(prop.list_outputs())
    if any(t.is_meta for t in tensors):
        outs = tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in _out_specs(prop, tensors[:n_args]))
    else:
        outs = _Custom.apply(prop, bool(__is_train__), n_args, *tensors)
    return outs if n_out > 1 else outs[0]


register_op(name="Custom", aliases=("_npx_Custom", "_npi_Custom"),
            state_binders={"__is_train__": _tape.is_training},
            host_op=True)(_custom_fn)


def normalize_custom_args(args, kwargs):
    """``(tensors, call_kwargs)`` of a ``Custom(...)`` call: keyword
    tensor inputs (``data=x, label=y``) in the prop's declared order after
    the positional ones, every other keyword as a string (``op_type`` and
    ``name`` kept as given)."""
    from .ndarray.ndarray import NDArray
    from .symbol.symbol import Symbol
    kwargs = dict(kwargs)
    op_type = kwargs.pop("op_type", None)
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    name = kwargs.pop("name", None)
    tensor_kwargs = {k: v for k, v in kwargs.items()
                     if isinstance(v, (NDArray, Symbol, torch.Tensor))}
    prop_kwargs = {k: v if isinstance(v, str) else str(v)
                   for k, v in kwargs.items() if k not in tensor_kwargs}
    prop = _prop(op_type, prop_kwargs)
    names = prop.list_arguments() + prop.list_auxiliary_states()
    tensors = list(args)
    for n in names[len(tensors):]:
        if n in tensor_kwargs:
            tensors.append(tensor_kwargs.pop(n))
    if tensor_kwargs:
        raise ValueError("unknown tensor inputs %s for custom op %r "
                         "(declared: %s)"
                         % (sorted(tensor_kwargs), op_type, names))
    call_kwargs = dict(prop_kwargs, op_type=op_type)
    if name is not None:
        call_kwargs["name"] = name
    return tensors, call_kwargs
