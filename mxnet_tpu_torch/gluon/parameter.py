"""Parameters: counterpart of ``mxnet_tpu/gluon/parameter.py``.

A :class:`Parameter` holds torch tensors, one per context; the first is a
``torch.nn.Parameter`` registered on the block that owns the parameter, so
``named_parameters``, ``state_dict`` and ``.to()`` see it. There are two
ways to get one:

- the reference's: ``block.params.get("weight", shape=..., init=...)``
  (a user ``HybridBlock``), with deferred initialization (a 0 in the shape
  until :meth:`HybridBlock.infer_shape` fills it at the first call) and
  per-context copies (``initialize(ctx=[...])``, ``list_data``,
  ``list_grad``, ``reset_ctx``);
- wrapping a module's own ``nn.Parameter``: :func:`collect_params` gives a
  model's parameters as a :class:`ParameterDict` under the reference's
  full names and in the reference's registration order, each with the
  reference layer's ``init`` default (``Dense``: weight None, bias
  ``"zeros"``; ``LayerNorm``: gamma ``"ones"``, beta ``"zeros"``;
  ``Embedding``: weight None). So, after the same seed,
  ``collect_params(net).initialize(Xavier())`` draws the reference's
  ``net.initialize(mx.init.Xavier())`` values bit for bit.

``data()`` and ``grad()`` return NDArrays bound to the tensor and its
gradient: writing through them writes the module's own tensor. The
trainer and the optimizers read the tensors themselves
(:meth:`Parameter.tensor`, :meth:`Parameter.grad_tensor`).

``grad_req`` keeps the reference's meaning on top of torch's accumulating
``.grad`` (``_tape.hook_grad_req``): ``"write"`` leaves each backward
pass's own gradient, ``"add"`` sums the passes, ``"null"`` turns
``requires_grad`` off. An initialized parameter with a gradient holds a
zero one until the first backward, as the reference's ``attach_grad``
does. ``cast`` changes the tensors' dtype in place of their storage (the
``nn.Parameter`` objects stay), as ``Module.to`` does.
"""
from __future__ import annotations

import re
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import _tape
from .. import cached_op
from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray
from ..ndarray.serialization import load_ndarrays, save_ndarrays

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "collect_params", "tensor_types"]

tensor_types = (NDArray,)

# the live parameters that hold copies on several contexts: while it is
# empty (a one-context process), ``Block._copies_for`` looks at nothing
_several_contexts = weakref.WeakSet()


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def _shape_complete(shape):
    return shape is not None and all(s > 0 for s in shape)


def _contexts(ctx):
    if ctx is None:
        return [current_context()]
    if isinstance(ctx, (list, tuple)):
        return [c if isinstance(c, Context) else Context.from_device(c)
                for c in ctx]
    return [ctx if isinstance(ctx, Context) else Context.from_device(ctx)]


class Parameter:
    """A trainable parameter: construct (shape dims may be 0 with
    ``allow_deferred_init``), ``initialize()``, then ``data()`` and
    ``grad()``."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._tensors = None
        self._ctx_list = None
        self._deferred_init = ()
        self._shape = (shape,) if isinstance(shape, int) else (
            None if shape is None else tuple(shape))
        self._dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._initialized = False
        self._owners = []
        self._pass_grad = {}
        self._grad_req = None
        self.grad_req = grad_req if differentiable else "null"

    @classmethod
    def _wrap(cls, name, tensor, init=None):
        """A parameter over a module's own tensor (not yet
        ``initialize``\\ d: its values are the module's)."""
        p = cls(name, shape=tuple(tensor.shape), dtype=tensor.dtype,
                init=init, grad_req="null")
        p._tensors = [tensor]
        p._ctx_list = [Context.from_device(tensor.device)]
        p.grad_req = "write"
        return p

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def shape(self):
        if self._tensors is not None:
            return tuple(self._tensors[0].shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        cur = self.shape
        if cur is None:
            self._shape = new_shape
            return
        if len(cur) != len(new_shape) or not all(
                a in (0, b) for a, b in zip(cur, new_shape)):
            raise AssertionError(
                "expected shape %s is incompatible with given shape %s for "
                "parameter %s" % (cur, new_shape, self.name))
        self._shape = new_shape

    @property
    def dtype(self):
        if self._tensors is not None:
            return self._tensors[0].dtype
        return torch_dtype(self._dtype)

    # ---- grad_req ---------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % req)
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        for t in self._tensors or ():
            self._apply_grad_req(t)

    def _apply_grad_req(self, t):
        if self._grad_req == "null":
            t.requires_grad_(False)
            t.grad = None
            return
        t.requires_grad_(True)
        _tape.hook_grad_req(t, self)
        if self._initialized and t.grad is None:
            t.grad = torch.zeros_like(t)

    # ---- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the parameter with ``init`` (else its own ``init``, else
        ``default_init``, else ``Uniform()``), drawn on the host with numpy
        under the parameter's name, as the reference does. A second call
        does nothing unless ``force_reinit``. A wrapped module tensor stays
        on its own device (``ctx`` may only name it); otherwise ``ctx`` (a
        context or a list, the current context when None) places the
        copies. With unknown dims and ``allow_deferred_init`` the draw
        waits for the shape."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._initialized and not force_reinit:
            return
        if init is None:
            init = default_init if self.init is None else self.init
        if isinstance(init, str):
            init = init_mod.create(init)
        if self._tensors is not None and not self._deferred_init:
            self._check_ctx(ctx)
            for t in self._tensors:
                init(init_mod.InitDesc(self.name), t)
            self._initialized = True
            self.grad_req = self._grad_req
            return
        ctx = _contexts(ctx)
        self._deferred_init = (init, ctx, None)
        if not _shape_complete(self._shape):
            if self.allow_deferred_init:
                return
            self._deferred_init = ()
            raise ValueError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape %s; set allow_deferred_init or complete the shape"
                % (self.name, self._shape))
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, data = self._deferred_init
        if not _shape_complete(self._shape):
            raise DeferredInitializationError(
                "deferred init of %s failed: shape %s still unknown"
                % (self.name, self._shape))
        self._deferred_init = ()
        if data is None:
            data = torch.zeros(self._shape, dtype=torch_dtype(self._dtype))
            init(init_mod.InitDesc(self.name), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        """Own copies of ``data`` on each context; the first is registered
        on the owning blocks."""
        if self._tensors is not None:
            cached_op.storage_rebound()
        self._ctx_list = list(ctx_list)
        if len(self._ctx_list) > 1:
            _several_contexts.add(self)
        else:
            _several_contexts.discard(self)
        data = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data)) \
            if not isinstance(data, torch.Tensor) else data
        self._tensors = [
            torch.nn.Parameter(data.detach().to(
                device=c.torch_device, dtype=torch_dtype(self._dtype),
                copy=True), requires_grad=False)
            for c in self._ctx_list]
        for t in self._tensors:
            t._mx_parameter = self
        self._initialized = True
        for ref, leaf in self._owners:
            block = ref()
            if block is not None:
                block._parameters[leaf] = self._tensors[0]
        self.grad_req = self._grad_req

    def _attach(self, block, leaf):
        """Register this parameter's tensor on ``block`` under ``leaf``
        (now, or when it is initialized)."""
        self._owners.append((weakref.ref(block), leaf))
        # an uninitialized parameter keeps its place in the module's order
        block._parameters[leaf] = None if self._tensors is None \
            else self._tensors[0]

    # ---- accessors --------------------------------------------------------
    def _check_init(self):
        if self._tensors is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s deferred initialization not complete"
                    % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. Call .initialize() "
                "first" % self.name)

    def _check_ctx(self, ctx):
        if ctx is None or self._tensors is None:
            return
        for c in _contexts(ctx):
            if c not in self._ctx_list:
                raise RuntimeError(
                    "Parameter %s is on %s, not %s: per-context copies of a "
                    "module's tensor are not made" % (self.name,
                                                      self._ctx_list, c))

    def _index(self, ctx):
        self._check_init()
        if ctx is None:
            return 0
        ctx = _contexts(ctx)[0]
        for i, c in enumerate(self._ctx_list):
            if c == ctx:
                return i
        raise RuntimeError("Parameter %s not initialized on context %s "
                           "(has %s)" % (self.name, ctx, self._ctx_list))

    def tensor(self, ctx=None):
        """The parameter's tensor on ``ctx`` (the first copy when None)."""
        return self._tensors[self._index(ctx)]

    def grad_tensor(self, ctx=None):
        """The tensor's gradient (zeros before the first backward)."""
        if self._grad_req == "null":
            raise RuntimeError("Parameter %s grad_req='null'" % self.name)
        t = self.tensor(ctx)
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad

    def data(self, ctx=None):
        """An NDArray bound to the parameter's tensor on ``ctx``."""
        return NDArray._bind(self.tensor(ctx))

    def list_data(self):
        self._check_init()
        return [NDArray._bind(t) for t in self._tensors]

    def row_sparse_data(self, row_id):
        """The data, whole (dense storage, as the reference's: every row,
        whatever ``row_id`` names)."""
        return self.data()

    def list_row_sparse_data(self, row_id):
        return self.list_data()

    def grad(self, ctx=None):
        """An NDArray bound to the gradient on ``ctx``."""
        return NDArray._bind(self.grad_tensor(ctx))

    def list_grad(self):
        self._check_init()
        return [self.grad(c) for c in self._ctx_list]

    def list_ctx(self):
        if self._tensors is None and self._deferred_init:
            return list(self._deferred_init[1])
        self._check_init()
        return list(self._ctx_list)

    def zero_grad(self):
        if self._grad_req == "null" or self._tensors is None:
            return
        for t in self._tensors:
            if t.grad is not None:
                t.grad.zero_()

    def set_data(self, data):
        """Copy ``data`` (an NDArray, tensor or array of this shape) into
        every copy, in its dtype and on its device."""
        self.shape = tuple(data.shape)
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if self._tensors is None:
            if not self._deferred_init:
                raise RuntimeError("set_data on uninitialized Parameter %s"
                                   % self.name)
            init, ctx, _ = self._deferred_init
            self._deferred_init = (init, ctx, data)
            return
        with torch.no_grad():
            for t in self._tensors:
                t.copy_(data)
        self._initialized = True

    def reset_ctx(self, ctx):
        """Move the copies onto ``ctx`` (a context or a list)."""
        ctx = _contexts(ctx)
        if self._tensors is None:
            if self._deferred_init:
                init, _, data = self._deferred_init
                self._deferred_init = (init, ctx, data)
            return
        if len(ctx) == 1 and len(self._tensors) == 1:
            t = self._tensors[0]
            ptr = t.data_ptr()
            with torch.no_grad():
                t.data = t.data.to(ctx[0].torch_device)
                if t.grad is not None:
                    t.grad = t.grad.to(ctx[0].torch_device)
            self._ctx_list = ctx
            if t.data_ptr() != ptr:
                cached_op.storage_rebound()
            return
        self._init_impl(self._reduce(), ctx)

    def _reduce(self):
        """The copies' mean, on the CPU."""
        self._check_init()
        acc = sum(t.detach().float().cpu() for t in self._tensors) \
            / len(self._tensors) if len(self._tensors) > 1 else \
            self._tensors[0].detach().cpu()
        return acc.to(self.dtype)

    def cast(self, dtype):
        """Cast every copy (and its gradient) to ``dtype``."""
        self._dtype = dtype_name(dtype)
        for t in self._tensors or ():
            ptr = t.data_ptr()
            with torch.no_grad():
                t.data = t.data.to(torch_dtype(dtype))
                if t.grad is not None:
                    t.grad = t.grad.to(torch_dtype(dtype))
            if t.data_ptr() != ptr:
                cached_op.storage_rebound()


class Constant(Parameter):
    """A parameter that holds a constant and takes no gradient. It holds
    its value whatever its name, as MXNet 1.6's does (the reference's
    initializer routes a name ending in ``bias`` to zeros, so its
    ``Constant("qbias", b)`` starts at zero: ROADMAP "Standing
    hazards")."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = np.asarray(value)
        if value.dtype == np.float64:     # as nd.array takes it
            value = value.astype(np.float32)
        self.value = value

        class _CInit(init_mod.Initializer):
            def __call__(self_i, _, arr):
                arr.copy_(torch.as_tensor(value))

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit(),
                         differentiable=False)


class ParameterDict:
    """Ordered dictionary of :class:`Parameter` by full name with a
    prefix, as the reference's: ``get``/``get_constant`` create under
    ``prefix + name``; ``initialize``, ``zero_grad``, ``setattr``,
    ``reset_ctx`` and ``save``/``load`` (``.params`` files through
    :mod:`mxnet_tpu_torch.ndarray.serialization`)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        s = "\n".join(repr(v) for v in self.values())
        return "%s(\n%s\n)" % (self._prefix or "Parameters", s)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` when
        it does not exist. An existing one keeps its attributes; a shape
        merges dim by dim as the reference's does (a known dim of the new
        shape wins, a 0 keeps the old one: a tied ``Dense(units)`` asks
        ``(units, 0)`` of an embedding's ``(units, in)`` weight)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        shape = kwargs.pop("shape", None)
        if shape is not None:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            cur = param.shape
            if cur is not None and len(cur) == len(shape):
                param._shape = tuple(a if a != 0 else b
                                     for a, b in zip(shape, cur))
            elif cur is None:
                param.shape = shape
        for k, v in kwargs.items():
            if getattr(param, k, None) is None:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("no constant named %s" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("duplicate parameter name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter in order: its own ``init`` where it
        has one, else ``init`` (``Uniform()`` when None)."""
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def list_ctx(self):
        out = []
        for v in self.values():
            for c in v.list_ctx():
                if c not in out:
                    out.append(c)
        return out

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        names, arrays = [], []
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError("Prefix %s is to be stripped but parameter "
                                 "%s does not start with it"
                                 % (strip_prefix, param.name))
            names.append(param.name[len(strip_prefix):])
            arrays.append(param._reduce())
        save_ndarrays(filename, arrays, names)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        arrays, names = load_ndarrays(filename)
        if not names:
            raise ValueError("expected dict-of-arrays file")
        arg_dict = {restore_prefix + k: v for k, v in zip(names, arrays)}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(
                        "Parameter %s missing in file %s" % (name, filename))
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %s in file %s is not in ParameterDict"
                        % (name, filename))
                continue
            load_param_from_array(self._params[name], v, ctx)


def load_param_from_array(param, arr, ctx=None):
    """Adopt a loaded array into a parameter: take its shape, initialize
    it where needed, and copy the values in."""
    param.shape = arr.shape
    if param._tensors is None and not param._deferred_init:
        param.initialize(ctx=ctx)
    if param._tensors is not None:
        param._check_ctx(ctx)
    param.set_data(arr)
    if param._deferred_init:
        param._finish_deferred_init()


def collect_params(model, select=None, prefix=None):
    """``model``'s parameters as a :class:`ParameterDict`.

    A ``TransformerLM``, ``BERTModel`` or ``PretrainStep`` takes the
    reference's full names (``convert.reference_names``; ``prefix``
    defaults to ``transformerlm0_``, ``bertmodel0_`` or
    ``pretrainstep0_bertmodel0_``). Any other ``gluon.Block`` gives the
    reference's names through its name scopes
    (:meth:`gluon.Block.collect_params`), and any other module its
    parameter names with ``.`` as ``_`` after ``prefix`` (default
    ``""``). The order is the reference's registration order. ``select``
    keeps the names a regex matches from their start, as the reference's
    ``collect_params(select)``. Each tensor keeps one :class:`Parameter`
    across calls."""
    from .. import convert
    from .block import Block

    try:
        names = convert.reference_names(model, prefix)
    except TypeError:                   # no reference name map
        if isinstance(model, Block) and prefix is None:
            return model._collect_params_scoped(select)
        names = {n: (prefix or "") + n.replace(".", "_")
                 for n, _ in model.named_parameters()}
    defaults = {}
    for mod_name, mod in model.named_modules():
        table = getattr(mod, "_param_init", {})
        for leaf, _ in mod.named_parameters(recurse=False):
            full = "%s.%s" % (mod_name, leaf) if mod_name else leaf
            defaults[full] = table.get(leaf)
    pattern = re.compile(select) if select else None
    out = ParameterDict(prefix or "")
    for port_name, tensor in model.named_parameters():
        name = names[port_name]
        if pattern is not None and not pattern.match(name):
            continue
        param = wrap_tensor(tensor, name, defaults.get(port_name))
        out._params[name] = param
    return out


def wrap_tensor(tensor, name, init=None):
    """The :class:`Parameter` of a module's tensor (one per tensor, kept on
    it), named ``name``."""
    param = getattr(tensor, "_mx_parameter", None)
    if param is None:
        param = Parameter._wrap(name, tensor, init=init)
        tensor._mx_parameter = param
    param.name = name
    return param
