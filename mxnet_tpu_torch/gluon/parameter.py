"""Parameters: the part of ``mxnet_tpu/gluon/parameter.py`` that the
trainer, the optimizers and ``initialize`` read.

The port's layers are ``nn.Module``s that hold ``nn.Parameter``s. A
:class:`Parameter` wraps one of them and shares its storage: ``data()`` is
the module's own tensor, so an update through the wrapper is an update of
the module. :func:`collect_params` gives a model's parameters as a
:class:`ParameterDict` under the reference's full names and in the
reference's registration order, each with the reference layer's ``init``
default (``Dense``: weight None, bias ``"zeros"``; ``LayerNorm``: gamma
``"ones"``, beta ``"zeros"``; ``Embedding``: weight None). So, after the
same seed, ``collect_params(net).initialize(Xavier())`` draws the
reference's ``net.initialize(mx.init.Xavier())`` values bit for bit.

``grad_req`` keeps the reference's meaning on top of torch's accumulating
``.grad``: ``"write"`` leaves each backward pass's own gradient (a tensor
hook keeps the pass's gradient aside, and a post-accumulate hook puts it
in place of the sum), ``"add"`` sums the passes, ``"null"`` turns
``requires_grad`` off. An initialized
parameter with a gradient holds a zero one until the first backward, as
the reference's ``attach_grad`` does.

Deferred shapes, per-context copies, ``Constant``, ``cast`` and
``Block`` are not ported (ROADMAP Queue A item 5).
"""
from __future__ import annotations

import re
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import initializer as init_mod
from ..ndarray.serialization import load_ndarrays, save_ndarrays

__all__ = ["Parameter", "ParameterDict", "collect_params"]


class Parameter:
    """One trainable tensor of a port module under a reference name.

    ``data`` is the ``nn.Parameter`` (or any leaf tensor) it wraps;
    ``shape`` and ``dtype`` are the tensor's. Use :func:`collect_params`
    rather than this constructor: it keeps one wrapper per tensor, so that
    ``grad_req``, ``lr_mult``, ``wd_mult`` and the initialized state set
    through one ``ParameterDict`` hold in the next."""

    def __init__(self, name, data, grad_req="write", lr_mult=1.0,
                 wd_mult=1.0, init=None):
        self.name = name
        self._data = data
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._initialized = False
        self._grad_req = None
        self._hooked = False
        self._pass_grad = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @shape.setter
    def shape(self, new_shape):
        if tuple(new_shape) != self.shape:
            raise AssertionError(
                "expected shape %s is incompatible with given shape %s for "
                "parameter %s" % (self.shape, tuple(new_shape), self.name))

    @property
    def dtype(self):
        return self._data.dtype

    # ---- grad_req ---------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % req)
        if req == self._grad_req:
            return
        self._grad_req = req
        if req == "null":
            self._data.requires_grad_(False)
            self._data.grad = None
            return
        self._data.requires_grad_(True)
        if not self._hooked:
            # torch adds each pass into .grad; under "write" the pass's own
            # gradient is kept aside before and put back after the add.
            # Weak references: the tensor holds the hooks and the wrapper.
            ref = weakref.ref(self)
            self._data.register_hook(lambda g: _keep_pass_grad(ref, g))
            self._data.register_post_accumulate_grad_hook(
                lambda t: _write_pass_grad(ref, t))
            self._hooked = True
        if self._initialized and self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)

    # ---- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the tensor with ``init`` (else this parameter's own
        ``init``, else ``default_init``, else ``Uniform()``), drawn on the
        host with numpy under the parameter's name, as the reference does.
        A second call does nothing unless ``force_reinit``. ``ctx`` may name
        the tensor's own device only (per-context copies are not
        ported)."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._initialized and not force_reinit:
            return
        self._check_ctx(ctx)
        if init is None:
            init = default_init if self.init is None else self.init
        if isinstance(init, str):
            init = init_mod.create(init)
        init(init_mod.InitDesc(self.name), self._data)
        self._initialized = True
        if self._grad_req != "null":
            self._data.grad = torch.zeros_like(self._data)

    def _check_ctx(self, ctx):
        own = self._data.device
        for c in ([] if ctx is None else
                  ctx if isinstance(ctx, (list, tuple)) else [ctx]):
            c = torch.device(c)
            if c.type != own.type or c.index not in (None, own.index):
                raise RuntimeError(
                    "Parameter %s lives on %s, not %s: per-context copies "
                    "are not ported" % (self.name, own, c))

    # ---- accessors --------------------------------------------------------
    def data(self, ctx=None):
        """The wrapped tensor (the module's own)."""
        self._check_ctx(ctx)
        return self._data

    def list_data(self):
        return [self._data]

    def grad(self, ctx=None):
        """The tensor's gradient (zeros before the first backward)."""
        self._check_ctx(ctx)
        if self._grad_req == "null":
            raise RuntimeError("Parameter %s grad_req='null'" % self.name)
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return self._data.grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._data.device]

    def zero_grad(self):
        if self._grad_req != "null" and self._data.grad is not None:
            self._data.grad.zero_()

    def set_data(self, data):
        """Copy ``data`` (a tensor or an array of this shape) into the
        tensor, in its dtype and on its device."""
        self.shape = tuple(data.shape)
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        with torch.no_grad():
            self._data.copy_(data)


def _keep_pass_grad(ref, grad):
    param = ref()
    if param is not None and param._grad_req == "write":
        param._pass_grad = grad


def _write_pass_grad(ref, tensor):
    """After torch's accumulation: under ``grad_req="write"`` the
    gradient is this pass's alone, as in the reference."""
    param = ref()
    if param is not None and param._pass_grad is not None:
        if param._grad_req == "write":
            tensor.grad = param._pass_grad
        param._pass_grad = None


class ParameterDict:
    """Ordered dictionary of :class:`Parameter` by full name, with the
    reference's ``initialize``, ``zero_grad``, ``setattr`` and
    ``save``/``load`` (``.params`` files through
    :mod:`mxnet_tpu_torch.ndarray.serialization`)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = OrderedDict()

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
            arrays.append(param.data())
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
            param = self._params[name]
            param._check_ctx(ctx)
            param.set_data(v)
            param._initialized = True


def collect_params(model, select=None, prefix=None):
    """``model``'s parameters as a :class:`ParameterDict`.

    A ``TransformerLM``, ``BERTModel`` or ``PretrainStep`` takes the
    reference's full names (``convert.reference_names``; ``prefix``
    defaults to ``transformerlm0_``, ``bertmodel0_`` or
    ``pretrainstep0_bertmodel0_``); any other module its parameter names
    with ``.`` as ``_`` after ``prefix`` (default ``""``). The order is
    ``named_parameters()``'s, which is the reference's registration order
    for those models. ``select`` keeps the names a regex matches from
    their start, as the reference's ``collect_params(select)``. Each
    tensor keeps one :class:`Parameter` across calls."""
    from .. import convert

    try:
        names = convert.reference_names(model, prefix)
    except TypeError:                   # no reference name map
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
        param = getattr(tensor, "_mx_parameter", None)
        if param is None:
            param = Parameter(name, tensor, init=defaults.get(port_name))
            tensor._mx_parameter = param
        param.name = name
        out._params[name] = param
    return out
