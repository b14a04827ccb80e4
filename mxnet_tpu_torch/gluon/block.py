"""Gluon ``Block`` and ``HybridBlock``: counterpart of
``mxnet_tpu/gluon/block.py``.

Both are subclasses of ``torch.nn.Module``, so a block is a module: its
parameters are ``nn.Parameter``s, ``named_parameters``, ``state_dict``
and ``.to()`` work, and a call with torch tensors is a plain module call.
A call with NDArrays is the Gluon one (:meth:`Block.__call__`): inputs are
unwrapped, torch's grad mode follows ``autograd.record()`` and the
module's training flag follows ``autograd``'s, and the outputs come back
as NDArrays. Blocks come in two kinds:

- the port's own layers and models (``Dense``, ``Embedding``,
  ``LayerNorm``, ``Dropout``, ``MultiHeadAttention``,
  ``TransformerEncoderLayer``, ``TransformerLM``, ``BERTEncoder``,
  ``BERTModel``, ``BERTPretrainingLoss``, the losses, the convolution,
  pooling and normalization layers and the model zoo): ``HybridBlock``s
  with a ``forward`` written on tensors and no ``hybrid_forward``, so the
  hot path wraps nothing per op. The vision layers create their
  parameters as the reference's do (``self.params.get``, shapes deferred
  until the first call, placed by ``initialize(ctx=...)``) and finish them
  in ``forward`` (:meth:`Block._ready`);
- a user's ``HybridBlock`` written as in the reference, with
  ``self.params.get(...)`` and ``hybrid_forward(self, F, x, weight=...)``:
  ``F`` is the port's ``nd`` namespace and the parameters arrive as
  NDArrays; a user's ``Block`` writes ``forward`` over NDArrays.

Name scopes and prefixes (``_BlockScope``) name the parameters as the
reference does; ``collect_params(select)`` gives them under those names
(the port's models under ``convert.reference_names``), ``initialize``
draws the reference's values, and ``save_parameters``/``load_parameters``
read and write the reference's structural names in its ``.params``
bytes. ``hybridize()`` sends NDArray calls through a :class:`~mxnet_tpu_
torch.cached_op.CachedOp` (one CUDA graph per input signature on the
card); a block whose parameters are rebound or cast clears it. Nested
arguments (an RNN's states) enter the CachedOp as their leaves, and a
nested output (``(out, [h, c])``) comes back in its eager structure.

A call with a :class:`~mxnet_tpu_torch.symbol.Symbol` composes the block
into a graph instead (:meth:`Block._symbol_call`): a user block through its
``hybrid_forward`` with ``F`` the port's ``sym``, a leaf layer through its
``_sym_forward`` (the op and attrs the reference's layer emits, its
parameters as variables under their full names), and a composite through
its own ``forward``, whose torch calls the ``Symbol`` answers.
:meth:`HybridBlock.export` writes the graph and the parameters as the
reference's ``export`` does; :class:`SymbolBlock` runs a graph (``imports``
reads those files back).
"""
from __future__ import annotations

import contextlib

import re
import threading
from collections import OrderedDict

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import _tape
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, load_param_from_array, wrap_tensor)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "set_slots",
           "slots_set_to"]

_naming = threading.local()
_global_counter = {}
_counter_lock = threading.Lock()


def _namegen(hint):
    with _counter_lock:
        count = _global_counter.get(hint, 0)
        _global_counter[hint] = count + 1
    return "%s%d" % (hint, count)


class _BlockScope:
    """Name manager for automatic prefixes (the reference's)."""

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def current():
        return getattr(_naming, "scope", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                prefix = _namegen(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = _BlockScope.current()
        _naming.scope = self
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        _naming.scope = self._old_scope


class _HookHandle:
    _id = 0

    def __init__(self, hooks, hook):
        _HookHandle._id += 1
        self._hooks = hooks
        self._key = _HookHandle._id
        hooks[self._key] = hook

    def detach(self):
        self._hooks.pop(self._key, None)

    remove = detach


def _has_nd(args, kwargs):
    return any(isinstance(a, NDArray) for a in args) or \
        any(isinstance(v, NDArray) for v in kwargs.values())


def _unwrap(x):
    """An NDArray's tensor; a list or tuple (an RNN's states) element by
    element."""
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x._data if isinstance(x, NDArray) else x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


def _unwrap_out(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_out(v) for v in x)
    return x


def set_slots(slots, tensors):
    """Put ``tensors[i]`` in the ``i``-th ``(module, leaf)`` parameter slot
    of ``slots``; returns what the slots held. The one way the port runs a
    block on other tensors than its registered ones (a context's copies,
    a mesh replica's values): the caller puts the old ones back."""
    old = [mod._parameters[leaf] for mod, leaf in slots]
    for (mod, leaf), t in zip(slots, tensors):
        mod._parameters[leaf] = t
    return old


@contextlib.contextmanager
def slots_set_to(slots, tensors):
    """``tensors`` in ``slots`` (:func:`set_slots`) for the length of the
    ``with`` block."""
    old = set_slots(slots, tensors)
    try:
        yield
    finally:
        set_slots(slots, old)


# NDArray calls of blocks with parameters on several contexts: the context
# whose copies this thread's outermost such call installed, and one lock so
# that no thread runs such a block while another has its slots swapped
_copies = threading.local()
_copies_lock = threading.RLock()


def _param_of(tensor, name, init=None):
    """The tensor's :class:`Parameter`, under its name so far (``name``
    for a tensor not wrapped yet)."""
    param = getattr(tensor, "_mx_parameter", None)
    return param if param is not None else wrap_tensor(tensor, name, init)


def _cast_tensor(t, dtype):
    """Cast a module's tensor through its :class:`Parameter` (in place of
    its storage) where it has one."""
    from .. import cached_op
    from ..base import torch_dtype
    p = getattr(t, "_mx_parameter", None)
    if p is not None:
        p.cast(dtype)
        return
    ptr = t.data_ptr()
    with torch.no_grad():
        t.data = t.data.to(torch_dtype(dtype))
        if t.grad is not None:
            t.grad = t.grad.to(torch_dtype(dtype))
    if t.data_ptr() != ptr:
        cached_op.storage_rebound()


def _cast_children(module, dtype):
    """``cast`` every child block; a plain module's own tensors are cast
    and its children visited."""
    for child in module.children():
        if isinstance(child, Block):
            child.cast(dtype)
            continue
        for t in child._parameters.values():
            if t is not None:
                _cast_tensor(t, dtype)
        _cast_children(child, dtype)


class Block(nn.Module):
    """Base building block: a ``torch.nn.Module`` with Gluon's names,
    parameters and NDArray calls."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = OrderedDict()
        self._mx_forward_hooks = OrderedDict()
        self._mx_forward_pre_hooks = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        """Register child blocks (as modules) and parameters."""
        if isinstance(value, Parameter):
            existing = self._reg_params.get(name)
            if existing is not None and existing is not value:
                raise AssertionError(
                    "Overriding Parameter attribute %s is not allowed" % name)
            object.__setattr__(self, name, value)
            self._reg_params[name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call; returns a handle with
        ``detach()``."""
        return _HookHandle(self._mx_forward_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each call; returns a handle
        with ``detach()``."""
        return _HookHandle(self._mx_forward_hooks, hook)

    # ---- parameters -------------------------------------------------------
    def collect_params(self, select=None):
        """This block's and its children's parameters under the
        reference's full names and order; ``select`` keeps the names a
        regex matches."""
        from . import parameter
        from .. import convert
        try:
            convert.reference_names(self)
        except TypeError:
            return self._collect_params_scoped(select)
        return parameter.collect_params(self, select, prefix=self.prefix)

    def _own_params(self):
        """``{full name: Parameter}`` of this block alone: its
        ``params.get`` parameters, then its module tensors under
        ``prefix + leaf``."""
        own = OrderedDict(self._params.items())
        table = getattr(self, "_param_init", {})
        for leaf, t in self._parameters.items():
            if t is None:
                continue
            p = getattr(t, "_mx_parameter", None)
            if p is not None and own.get(p.name) is p:
                continue
            p = wrap_tensor(t, self.prefix + leaf, table.get(leaf))
            own[p.name] = p
        return own

    def _collect_params_scoped(self, select=None):
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        ret.update({n: p for n, p in self._own_params().items()
                    if pattern is None or pattern.match(n)})

        def visit(module):
            for child in module.children():
                if isinstance(child, Block):
                    ret.update(child.collect_params(select))
                else:
                    visit(child)
        visit(self)
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}`` as the reference's
        ``save_parameters`` names them (attribute paths; the port's models
        through ``convert.reference_structural_names``)."""
        from .. import convert
        try:
            names = convert.reference_structural_names(self)
        except TypeError:
            names = None
        if names is not None:
            full = {n: p for n, p in zip(
                names, self.collect_params().values())}
            return {prefix + ("." if prefix else "") + names[n]: p
                    for n, p in full.items()}
        if prefix:
            prefix += "."
        ret = OrderedDict()
        for leaf, p in self._reg_params.items():
            ret[prefix + leaf] = p
        table = getattr(self, "_param_init", {})
        for leaf, t in self._parameters.items():
            if t is not None and leaf not in self._reg_params:
                ret[prefix + leaf] = _param_of(t, self.prefix + leaf,
                                               table.get(leaf))
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
            elif child is not None:
                for sub, t in child.named_parameters():
                    ret[prefix + name + "." + sub] = _param_of(t, sub)
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``Uniform()`` when ``init`` is
        None), as the reference: numpy draws in ``collect_params`` order."""
        from .. import initializer as init_mod
        if init is None:
            init = init_mod.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)
            else:
                for sub in child.modules():
                    if isinstance(sub, Block):
                        sub.hybridize(active, **kwargs)

    def _clear_all_cached_ops(self):
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._clear_cached_op()

    def cast(self, dtype):
        """Cast this block's parameters (and their gradients) to ``dtype``,
        and each child block's through the child's own ``cast``, as the
        reference recurses: a layer may override it (``BatchNorm`` keeps
        float32)."""
        _cast_children(self, dtype)
        done = set()
        for p in self._params.values():
            p.cast(dtype)
            done.update(id(t) for t in p._tensors or ())
        for t in self._parameters.values():
            if t is not None and id(t) not in done:
                _cast_tensor(t, dtype)
        if isinstance(self, HybridBlock):
            self._clear_cached_op()

    def _ready(self, *args):
        """Finish this layer's deferred parameters from the first call's
        inputs (``infer_shape``), as ``_hybrid_call`` does for a
        ``hybrid_forward`` block; a parameter never initialized raises."""
        if self.__dict__.get("_tensors_ready"):
            return
        pending = [p for p in self._reg_params.values() if p._tensors is None]
        if any(p._deferred_init for p in pending):
            self.infer_shape(*args)
        for p in pending:
            p._finish_deferred_init()
            p._check_init()
        self.__dict__["_tensors_ready"] = True

    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters under the reference's structural names in
        the reference's ``.params`` bytes."""
        from ..ndarray.serialization import save_ndarrays
        params = self._collect_params_with_prefix()
        save_ndarrays(filename, [p._reduce() for p in params.values()],
                      list(params))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Read a file written by :meth:`save_parameters` or by the
        reference's (structural names; a full-name file of
        ``ParameterDict.save`` too). Values are copied into the tensors in
        place; the block's CachedOps are cleared."""
        from ..ndarray.serialization import load_ndarrays
        arrays, names = load_ndarrays(filename)
        loaded = dict(zip(names, arrays))
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and not any("." in k for k in loaded) and \
                not set(loaded) & set(params):
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            self._clear_all_cached_ops()
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError("Parameter %s is missing in file %s"
                                         % (name, filename))
        for name, arr in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %s loaded from file %s is not present in "
                        "this block" % (name, filename))
                continue
            load_param_from_array(params[name], arr, ctx)
        self._clear_all_cached_ops()

    save_params = save_parameters
    load_params = load_parameters

    # ---- calls ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        for hook in self._mx_forward_pre_hooks.values():
            hook(self, args)
        if _has_nd(args, kwargs):
            with self._copies_for(args):
                out = self._nd_call(*args, **kwargs)
        elif args and isinstance(args[0], Symbol):
            out = self._symbol_call(*args)
        else:
            out = super().__call__(*args, **kwargs)
        for hook in self._mx_forward_hooks.values():
            hook(self, args, out)
        return out

    def _nd_call(self, *args, **kwargs):
        return self._nd_forward(*args, **kwargs)

    @contextlib.contextmanager
    def _copies_for(self, args):
        """While the block runs on NDArrays of a context where its own
        parameters hold a copy other than the first, its modules use that
        copy (``initialize(ctx=[...])``: each context's forward and
        gradient land in its own copy, as in the reference). Only the
        outermost such call of a thread swaps (a nested call on the same
        context finds it done), and it holds a lock, so another thread's
        NDArray call of a block with several contexts waits."""
        from .parameter import _several_contexts
        ctx = next((a.ctx for a in args if isinstance(a, NDArray)), None) \
            if _several_contexts else None
        if ctx is None or getattr(_copies, "ctx", None) == ctx:
            yield
            return
        slots, copies, several = [], [], False
        for mod in self.modules():
            for leaf, t in mod._parameters.items():
                p = getattr(t, "_mx_parameter", None)
                if p is None or p._tensors is None or len(p._ctx_list) < 2:
                    continue
                several = True
                if ctx in p._ctx_list[1:]:
                    slots.append((mod, leaf))
                    copies.append(p._tensors[p._ctx_list.index(ctx)])
        if not several:
            yield
            return
        outer = getattr(_copies, "ctx", None)
        with _copies_lock:
            _copies.ctx = ctx
            try:
                with slots_set_to(slots, copies):
                    yield
            finally:
                _copies.ctx = outer

    def _nd_forward(self, *args, **kwargs):
        """One Gluon call with NDArrays: grad mode and the training flag
        from ``autograd``."""
        with torch.set_grad_enabled(_tape.is_recording()):
            if not self._takes_tensors():
                return self._nd_body(*args, **kwargs)
            train = _tape.is_training()
            if self.training != train:
                self.train(train)
            out = nn.Module.__call__(
                self, *[_unwrap(a) for a in args],
                **{k: _unwrap(v) for k, v in kwargs.items()})
        return _wrap(out)

    def _takes_tensors(self):
        """Whether ``forward`` is written on tensors (the port's blocks)
        rather than on NDArrays (a user's)."""
        return False

    def _nd_body(self, *args, **kwargs):
        """A user block's ``forward`` over NDArrays."""
        return self.forward(*args, **kwargs)

    def _symbol_call(self, *args):
        """A call with Symbols: the block composed into their graph."""
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block that ``hybridize()`` routes through a CachedOp. A user
    subclass implements ``hybrid_forward(F, x, *args, **params)``, with
    the parameters assigned as attributes passed by name."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_ops = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self):
        self.__dict__["_cached_ops"] = {}
        self.__dict__["_params_ready"] = False

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .half() give the parameters new storage, which
        # a captured graph does not follow (an ancestor's or a served
        # function's CachedOp included)
        from .. import cached_op
        self._clear_cached_op()
        before = [t.data_ptr() for t in self.parameters()]
        out = super()._apply(fn, *args, **kwargs)
        if [t.data_ptr() for t in self.parameters()] != before:
            cached_op.storage_rebound()
        return out

    def infer_shape(self, *args):
        """Fill deferred parameter shapes from the inputs' shapes (a user
        block with unknown dims overrides this)."""
        raise DeferredInitializationError(
            "%s has parameters with unresolved shapes and does not implement "
            "infer_shape" % type(self).__name__)

    def infer_type(self, *args):
        pass

    def _nd_call(self, *args, **kwargs):
        if self._active and not kwargs:
            return self._call_cached_op(*args)
        return self._nd_forward(*args, **kwargs)

    def _takes_tensors(self):
        return type(self).hybrid_forward is HybridBlock.hybrid_forward

    def _nd_body(self, *args, **kwargs):
        return self._hybrid_call(*args, **kwargs)

    def _hybrid_call(self, *args, **kwargs):
        from .. import ndarray as F
        ctx = next((a.ctx for a in args if isinstance(a, NDArray)), None)
        try:
            params = {n: p.data(ctx) for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {n: p.data(ctx) for n, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def forward(self, *args):
        """A torch-tensor call of a ``hybrid_forward`` block."""
        if self._takes_tensors():
            raise NotImplementedError
        return _unwrap_out(self._hybrid_call(*[_wrap(a) for a in args]))

    def _call_cached_op(self, *args):
        from ..cached_op import CachedOp
        if not self.__dict__.get("_params_ready"):
            if any(p._deferred_init for p in self.collect_params().values()):
                return self._nd_forward(*args)  # finishes the shapes
            self.__dict__["_params_ready"] = True
        # nested arguments (an RNN's states) enter as their leaves, and the
        # output's nesting (``(out, [h, c])``) is rebuilt around the leaves
        flat, spec = tree_flatten(list(args))
        slots = tuple(i for i, a in enumerate(flat)
                      if isinstance(a, NDArray))
        consts = tuple((i, a) for i, a in enumerate(flat)
                       if not isinstance(a, NDArray))
        key = (spec, consts)
        op = self._cached_ops.get(key)
        if op is None:
            def fn(*nds, _n=len(flat), _consts=dict(consts), _slots=slots):
                full = [_consts.get(i) for i in range(_n)]
                for i, v in zip(_slots, nds):
                    full[i] = v
                leaves, op.out_spec = tree_flatten(
                    self._nd_forward(*tree_unflatten(full, spec)))
                return leaves
            op = CachedOp(fn, name=self.name or "CachedOp",
                          **{k: v for k, v in self._flags.items()
                             if k in ("static_alloc", "static_shape",
                                      "inline_limit", "forward_bulk_size",
                                      "backward_bulk_size")})
            self._cached_ops[key] = op
        return tree_unflatten(op(*[flat[i] for i in slots]), op.out_spec)

    def _param_vars(self):
        """``{leaf: variable}`` of this block's own parameters, each named
        by its parameter's full name."""
        from ..symbol import var
        out = {leaf: var(p.name) for leaf, p in self._reg_params.items()}
        for leaf, t in self._parameters.items():
            if leaf not in out and t is not None:
                p = getattr(t, "_mx_parameter", None)
                out[leaf] = var(p.name if p is not None
                                else self.prefix + leaf)
        return out

    def _symbol_call(self, *args):
        from .. import symbol as F
        if not self._takes_tensors():
            return self.hybrid_forward(F, *args, **self._param_vars())
        sym_forward = getattr(self, "_sym_forward", None)
        if sym_forward is not None:
            return sym_forward(F, *args, **self._param_vars())
        return self.forward(*args)

    def _export_arity(self):
        """How many data inputs a call takes: the positional parameters of
        ``forward`` (of ``hybrid_forward`` after ``F``) without a default
        that are not parameters of the block."""
        import inspect
        fn = self.forward if self._takes_tensors() else self.hybrid_forward
        params = list(inspect.signature(fn).parameters.values())
        if not self._takes_tensors():
            params = params[1:]
        kinds = (inspect.Parameter.POSITIONAL_ONLY,
                 inspect.Parameter.POSITIONAL_OR_KEYWORD)
        return max(1, sum(1 for p in params if p.kind in kinds
                          and p.default is p.empty
                          and p.name not in self._reg_params))

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (the block composed on variables
        ``data``, or ``data0``, ``data1``, ... for several inputs) and
        ``path-%04d.params`` (the parameters the graph reads, as
        ``arg:<name>`` and ``aux:<name>``), as the reference's ``export``
        does; returns the two file names. ``SymbolBlock.imports`` and
        ``mx.model.load_checkpoint`` read them back."""
        from .. import symbol as sym_ns
        from ..ndarray.serialization import save_ndarrays
        n = self._export_arity()
        names = ["data"] if n == 1 else ["data%d" % i for i in range(n)]
        out = self(*[sym_ns.var(name) for name in names])
        if isinstance(out, (list, tuple)):
            out = sym_ns.Group(list(out))
        symbol_file = "%s-symbol.json" % path
        out.save(symbol_file)
        inputs = set(out.list_inputs())
        aux = set(out.list_auxiliary_states())
        keys, arrays = [], []
        for name, p in self.collect_params().items():
            if name in inputs:
                keys.append(("aux:" if name in aux else "arg:") + name)
                arrays.append(p._reduce())
        params_file = "%s-%04d.params" % (path, epoch)
        save_ndarrays(params_file, arrays, keys)
        return symbol_file, params_file

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block: every variable that is not one of
    ``inputs`` becomes a :class:`Parameter` of that name (an aux state
    with ``grad_req="null"``), its shape deferred until the first call
    (``infer_shape`` runs the graph's shape pass). The forward evaluates
    the graph's op functions on tensors, resolving their state (the
    training flag, the dropout key) as an eager call does, so it records
    under ``autograd.record()``; ``hybridize()`` sends NDArray calls
    through a ``CachedOp``. ``cast`` to a 16-bit type keeps the
    parameters that feed ``BatchNorm``'s gamma, beta and moving statistics
    in float32, as the port's ``BatchNorm`` layer keeps its own."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block from ``export``'s files (or ``Module.save_checkpoint``'s,
        or the reference's): the graph of ``symbol_file`` with
        ``input_names`` as its inputs, and the ``arg:``/``aux:`` arrays of
        ``param_file`` on ``ctx`` (the current context when None)."""
        from .. import symbol as sym_ns
        from ..ndarray.serialization import load_ndarrays
        out = sym_ns.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(out, [sym_ns.var(n) for n in input_names])
        if param_file is None:
            return block
        arrays, names = load_ndarrays(param_file)
        if arrays and not names:
            raise ValueError("params file %s has unnamed arrays; a "
                             "SymbolBlock needs named ones" % param_file)
        params = block.collect_params()
        for key, arr in zip(names, arrays):
            name = key.split(":", 1)[1] \
                if key.startswith(("arg:", "aux:")) else key
            if name not in params:
                raise AssertionError(
                    "Parameter %s in file %s is not a variable of the "
                    "symbol graph" % (name, param_file))
            load_param_from_array(params[name], arr, ctx)
        return block

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from ..symbol import Group
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._sb_outputs = outputs
        self._input_names = [i.name for i in inputs]
        self._bn_params = set()
        for node in outputs._toposort():
            if node._op is not None and node._op.name == "BatchNorm":
                self._bn_params.update(p._name for p, _ in node._inputs[1:5]
                                       if p._op is None)
            if node._op is not None or node._name in self._input_names:
                continue
            aux = bool(node._attr.get("__aux__"))
            p = self.params.get(node._name,
                                grad_req="null" if aux else "write",
                                allow_deferred_init=True)
            self._reg_params[node._name] = p
            p._attach(self, node._name)

    def infer_shape(self, *args):
        from ..symbol.symbol import _infer_shapes
        shapes = _infer_shapes(self._sb_outputs, {
            n: tuple(a.shape) for n, a in zip(self._input_names, args)})
        for name, p in self._reg_params.items():
            if shapes.get(name) is not None:
                p.shape = shapes[name]

    def cast(self, dtype):
        from ..base import dtype_name
        super().cast(dtype)
        if dtype_name(dtype) in ("float16", "bfloat16"):
            for name in self._bn_params:
                if name in self._reg_params:
                    self._reg_params[name].cast("float32")

    def _export_arity(self):
        return len(self._input_names)

    def forward(self, *args):
        from ..symbol.symbol import evaluate_graph
        if len(args) != len(self._input_names):
            raise ValueError("SymbolBlock expects %d inputs (%s), got %d"
                             % (len(self._input_names), self._input_names,
                                len(args)))
        self._ready(*args)
        binds = dict(self._parameters)
        binds.update(zip(self._input_names, args))
        outs = evaluate_graph(self._sb_outputs, binds, bind_state=True)
        return outs if len(outs) > 1 else outs[0]

    def _sym_forward(self, F, *args, **params):
        """The graph composed again on ``args`` (re-export), each node
        under its own name."""
        from ..symbol.symbol import _out_key, _is_const, _sym_op
        values = {}
        binds = dict(params)
        binds.update(zip(self._input_names, args))
        for node in self._sb_outputs._toposort():
            if node._op is None:
                values[_out_key(node, 0)] = binds[node._name]
                continue
            call = [p[1] if _is_const(p) else values[_out_key(*p)]
                    for p in getattr(node, "_raw_inputs", node._inputs)]
            values[_out_key(node, 0)] = _sym_op(node._op.name)(
                *call, name=node._name, **node._kwargs)
        outs = [values[_out_key(s, i)]
                for s, i in self._sb_outputs._outputs_list()]
        return outs if len(outs) > 1 else outs[0]
