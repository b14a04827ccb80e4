"""Operator registry and eager dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op is one plain function
on torch tensors (or Python scalars). :func:`invoke` unwraps ``NDArray``
arguments to their tensors, binds the op's state (``state_binders``: the
RNG key words and the training flag, resolved at each call), runs the
function with torch's grad mode on only while ``autograd.record()`` is
recording, and wraps the results. Gradients come from torch's autograd,
so, as in the reference, no op registers a backward.

Tensor-valued keyword arguments (masks, index arrays) are unwrapped as
constants: they are detached, and only positional arguments carry
gradients. ``out=`` rebinds its target to the result. A host op
(``register(host_op=True)``: ``Custom`` and the graph ops) runs code on
the host; each call of its function counts in :func:`host_calls`, which a
``CachedOp`` reads to run such a callable eagerly. An op registered with
``storage=True`` (the host ops, ``cast_storage``, ``_sparse_retain``)
receives sparse handles (``ndarray.sparse``) as they are, and an op that
returns an NDArray (a sparse one) gives it back as it is. Under NaiveEngine
(``MXNET_ENGINE_TYPE=NaiveEngine``) each op synchronizes the device before
it returns.
"""
from __future__ import annotations

import functools
import inspect
import threading
from typing import Dict, Optional

import torch

from .. import _tape
from .. import engine as _engine

__all__ = ["Op", "register", "get_op", "register_alias", "list_ops",
           "invoke", "wrap_out", "bind_key", "bind_train", "host_calls"]

_OP_REGISTRY: Dict[str, "Op"] = {}
_host = threading.local()


def host_calls():
    """How many times this thread has called a host op's function."""
    return getattr(_host, "calls", 0)


def _counted(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _host.calls = host_calls() + 1
        return fn(*args, **kwargs)
    return run


def bind_key():
    """State binder: two fresh uint32 key words
    (:func:`mxnet_tpu_torch.random.next_key`)."""
    from .. import random as _random
    return _random.next_key()


def bind_train():
    """State binder: the training flag of ``autograd``."""
    return _tape.is_training()


class Op:
    """A registered operator: a named function on tensors with metadata.
    ``state_binders`` maps keyword names to zero-argument callables
    resolved at each :func:`invoke` that does not pass them."""
    __slots__ = ("name", "fn", "n_out", "aliases", "doc", "namespace",
                 "differentiable", "state_binders", "host_op", "storage")

    def __init__(self, name, fn, n_out=1, aliases=(), doc=None,
                 namespace="nd", differentiable=True, state_binders=None,
                 host_op=False, storage=False):
        self.name = name
        self.fn = fn
        self.n_out = n_out
        self.aliases = aliases
        self.doc = doc or fn.__doc__
        self.namespace = namespace
        self.differentiable = differentiable
        self.state_binders = state_binders or {}
        self.host_op = host_op
        self.storage = storage

    def __call__(self, *args, **kwargs):
        return invoke(self, *args, **kwargs)

    def __repr__(self):
        return "<Op %s>" % self.name


def register(name=None, n_out=1, aliases=(), namespace="nd",
             differentiable=True, state_binders=None, host_op=False,
             storage=False):
    """Decorator: register a function on tensors as an op. A name that is
    already registered is refused. ``host_op`` declares that the function
    runs host code (it reads values to the host); ``storage`` that it
    takes sparse handles as they are."""
    def deco(fn):
        opname = name or fn.__name__
        for n in (opname,) + tuple(aliases):
            if n in _OP_REGISTRY:
                raise ValueError(
                    "operator %r is already registered (by %r); use "
                    "register_alias to re-expose an existing op"
                    % (n, _OP_REGISTRY[n].name))
        op = Op(opname, _counted(fn) if host_op else fn, n_out=n_out,
                aliases=aliases, namespace=namespace,
                differentiable=differentiable, state_binders=state_binders,
                host_op=host_op, storage=storage)
        _OP_REGISTRY[opname] = op
        for a in aliases:
            _OP_REGISTRY[a] = op
        return op
    return deco


def get_op(name: str) -> Optional[Op]:
    return _OP_REGISTRY.get(name)


def register_alias(existing: str, *names: str):
    """Expose an already-registered op under more names."""
    op = _OP_REGISTRY[existing]
    for n in names:
        _OP_REGISTRY[n] = op
    return op


def list_ops():
    return sorted(_OP_REGISTRY.keys())


def wrap_out(val, like=None):
    """Wrap a tensor into an NDArray."""
    from ..ndarray.ndarray import NDArray
    return NDArray(val)


@functools.lru_cache(maxsize=None)
def _params(fn):
    """The names a positional argument can fill, in order."""
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return tuple(n for n, p in inspect.signature(fn).parameters.items()
                 if p.kind in kinds)


def _positional(op, n):
    """The names of ``op``'s parameters that ``n`` positional arguments
    fill (a state binder does not bind one of them)."""
    return _params(op.fn)[:n] if op.state_binders else ()


def invoke(op: Op, *args, out=None, **kwargs):
    """Eager dispatch: unwrap handles, bind state, run, wrap."""
    from ..ndarray.ndarray import NDArray
    from ..ndarray.sparse import BaseSparseNDArray

    vals = [a if op.storage and isinstance(a, BaseSparseNDArray) else
            a._data if isinstance(a, NDArray) else a for a in args]
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            kwargs[k] = v._data.detach()
    for kname, binder in op.state_binders.items():
        if kname not in kwargs and kname not in _positional(op, len(vals)):
            kwargs[kname] = binder()
    with torch.set_grad_enabled(op.differentiable and
                                _tape.is_recording()):
        out_vals = op.fn(*vals, **kwargs)
    multi = isinstance(out_vals, (tuple, list))
    outs = tuple(out_vals) if multi else (out_vals,)
    if _engine.is_naive() and any(isinstance(v, torch.Tensor) and v.is_cuda
                                  for v in outs):
        torch.cuda.synchronize()
    targets = out if isinstance(out, (list, tuple)) else \
        ([out] if out is not None else [])
    results = []
    for i, v in enumerate(outs):
        target = targets[i] if i < len(targets) else None
        if target is not None:
            target._rebind_out(v._data if isinstance(v, NDArray) else v)
            results.append(target)
        else:
            results.append(v if isinstance(v, NDArray) else NDArray(v))
    return tuple(results) if multi else results[0]
