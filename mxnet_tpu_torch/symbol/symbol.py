"""Symbol: the declarative graph-building front end.

Counterpart of ``mxnet_tpu/symbol/symbol.py``. A :class:`Symbol` is a
small DAG over the same op registry the ``nd`` namespace is generated
from: ``var`` makes a variable, ``mx.sym.<op>(...)`` a node, and the
arithmetic operators the ``add``/``_plus_scalar`` family. What it carries,
as the reference does:

- composition (:func:`_sym_op`): an op's missing parameters
  (``FullyConnected``'s weight and bias, ``BatchNorm``'s gamma, beta and
  moving statistics, ...) become variables named ``<node>_<slot>``, and a
  variable in ``BatchNorm``'s moving-statistics slots is an auxiliary
  state; non-symbol positional arguments (a ``None`` bias) are kept as
  constant inputs;
- ``list_arguments``, ``list_outputs``, ``list_auxiliary_states``,
  ``list_inputs``, ``get_internals``, indexing and :func:`Group`;
- shape inference: each op's own function runs on ``device="meta"``
  tensors (shapes and dtypes only, nothing computed), after the per-op
  rules (``_PARAM_SHAPE_RULES``) have sized the parameters from the
  data's shape; an op that cannot run on meta raises with its name.
  ``infer_type`` answers float32, as the reference does;
- ``tojson``/``save`` in the reference's format, string for string
  (every attr ``json.dumps``-encoded, constant inputs under
  ``const_inputs``), and ``load``/``load_json`` of that format and of
  nnvm's (plain-string attrs, 3-element entries);
- ``bind``/``simple_bind``/``eval`` give an :class:`~.executor.Executor`
  on the context asked for (the current one when None: the card unless a
  ``with mx.cpu():`` scope is open); ``group2ctx`` places each
  ``ctx_group`` (``AttrScope``) on its context.

A ``Symbol`` also answers the torch functions that the port's composite
blocks call in their ``forward`` (``torch.relu``, ``torch.cat``,
``torch.clamp``) with the op the reference's ``hybrid_forward`` emits
there (``__torch_function__``), so ``block(mx.sym.var("data"))``
composes a zoo model into a graph; any other torch function raises and
names itself.

``get_backend_symbol(backend)`` partitions the graph with a registered
subgraph backend (:mod:`.subgraph`), and a bind partitions with the
``MXNET_SUBGRAPH_BACKEND`` knob's backend (once per symbol and backend,
so a rebind reuses the region ops); positional argument lists are read
in the unpartitioned symbol's order.
"""
from __future__ import annotations

import ast
import json
import numbers
import threading

import numpy as _np
import torch

from ..base import MXNetError, dtype_np
from ..context import current_context
from ..ops.registry import get_op, list_ops

__all__ = ["Symbol", "var", "Variable", "Group", "AttrScope", "load",
           "load_json", "zeros", "ones", "arange"]


class Symbol:
    """A node (or a group of outputs) of a symbolic graph."""

    def __init__(self, op=None, inputs=(), kwargs=None, name=None,
                 outputs=None, attr=None):
        self._op = op                 # None for variables and groups
        self._inputs = list(inputs)   # [(Symbol, out_index)]
        self._kwargs = kwargs or {}
        self._name = name
        self._group = outputs         # [(Symbol, idx)] of a Group
        self._attr = dict(attr or {})
        self._shape_hint = None
        self._dtype_hint = None

    # ---- identity ---------------------------------------------------------
    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attr.get(key)

    def list_attr(self):
        return dict(self._attr)

    def _set_attr(self, **kwargs):
        self._attr.update(kwargs)

    def __repr__(self):
        if self._group is not None:
            return "<Symbol group [%s]>" % ", ".join(
                s._name or "?" for s, _ in self._group)
        return "<Symbol %s>" % (self._name or (self._op and self._op.name))

    # ---- graph traversal --------------------------------------------------
    def _toposort(self):
        """Every node once, inputs before their users, in the reference's
        order (a left-to-right depth-first postorder)."""
        order, seen = [], set()
        stack = [(s, False) for s, _ in self._outputs_list()]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for parent, _ in reversed(node._inputs):
                stack.append((parent, False))
        return order

    def _outputs_list(self):
        if self._group is not None:
            return list(self._group)
        return [(self, 0)]

    def list_arguments(self):
        return [n._name for n in self._toposort()
                if n._op is None and not n._attr.get("__aux__")]

    def list_auxiliary_states(self):
        return [n._name for n in self._toposort()
                if n._op is None and n._attr.get("__aux__")]

    def list_outputs(self):
        outs = []
        for s, _ in self._outputs_list():
            base = s._name or s._op.name
            outs.append("%s_output" % base if s._op else base)
        return outs

    def list_inputs(self):
        return [n._name for n in self._toposort() if n._op is None]

    def get_internals(self):
        return Group(self._toposort())

    def __getitem__(self, index):
        outs = self._outputs_list()
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        s, i = outs[index]
        if i == 0 and s._group is None:
            return s
        proxy = Symbol(op=None, name=(s._name or "out"))
        proxy._group = [(s, i)]
        return proxy

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs_list())))

    def __len__(self):
        return len(self._outputs_list())

    # ---- arithmetic -------------------------------------------------------
    def _binop(self, other, opname, reverse=False):
        op = _sym_op(opname)
        return op(other, self) if reverse else op(self, other)

    def __add__(self, o):
        return self._binop(o, "_plus_scalar" if _scalar(o) else "add")

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._binop(o, "_minus_scalar" if _scalar(o) else "subtract")

    def __rsub__(self, o):
        return self._binop(o, "_rminus_scalar" if _scalar(o) else "subtract",
                           reverse=not _scalar(o))

    def __mul__(self, o):
        return self._binop(o, "_mul_scalar" if _scalar(o) else "multiply")

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binop(o, "_div_scalar" if _scalar(o) else "divide")

    def __rtruediv__(self, o):
        return self._binop(o, "_rdiv_scalar" if _scalar(o) else "divide",
                           reverse=not _scalar(o))

    def __pow__(self, o):
        return self._binop(o, "_power_scalar" if _scalar(o) else "power")

    def __neg__(self):
        return self.__mul__(-1.0)

    # ---- torch functions of the port's composite blocks --------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        emit = _TORCH_FUNCTIONS.get(func)
        if emit is None:
            raise NotImplementedError(
                "%s has no symbolic form: a block whose forward calls it "
                "cannot be composed into a Symbol"
                % getattr(func, "__name__", func))
        return emit(*args, **(kwargs or {}))

    # ---- shape and type inference ------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given
        (positionally in ``list_arguments`` order, or by name)."""
        known = dict(kwargs)
        arg_names = self.list_arguments()
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = shape
        shapes = _infer_shapes(self, known)
        arg_shapes = [shapes.get(n) for n in arg_names]
        out_shapes = []
        for node, i in self._outputs_list():
            k = _out_key(node, i)
            out_shapes.append(shapes[k] if k in shapes
                              else shapes.get(node._name))
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except Exception:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        """float32 for every unnamed argument, every output and every aux
        state (the reference's answer)."""
        arg_names = self.list_arguments()
        given = list(args) + [None] * (len(arg_names) - len(args))
        for i, n in enumerate(arg_names):
            if kwargs.get(n) is not None:
                given[i] = kwargs[n]
        dt = [(_np.float32 if a is None else dtype_np(a)) for a in given]
        return dt, [_np.float32] * len(self._outputs_list()), \
            [_np.float32] * len(self.list_auxiliary_states())

    # ---- evaluation -------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Bind the NDArrays given by name and run one inference forward;
        on ``ctx`` (the current context when None)."""
        return self.bind(ctx or current_context(), kwargs).forward()

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor
        # positional lists name this symbol's arguments (a partitioned
        # graph may list them in another order)
        names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        if isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(names, grad_req))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self._env_partitioned(), ctx, args, args_grad,
                        grad_req, aux_states, group2ctx=group2ctx)

    def _env_partitioned(self):
        """This symbol partitioned by ``MXNET_SUBGRAPH_BACKEND``'s backend
        (memoized per backend), or itself."""
        from .. import config as _config
        backend = _config.get("MXNET_SUBGRAPH_BACKEND")
        if not backend or backend == "NONE":
            return self
        from .subgraph import _BACKENDS, partition
        if backend not in _BACKENDS:
            import logging
            logging.warning(
                "MXNET_SUBGRAPH_BACKEND=%r is not a registered subgraph "
                "backend (registered: %s); binding unpartitioned",
                backend, sorted(_BACKENDS))
            return self
        cache = self.__dict__.setdefault("_partition_cache", {})
        if backend not in cache:
            cache[backend] = partition(self, backend)
        return cache[backend]

    def get_backend_symbol(self, backend):
        """This symbol partitioned by the registered subgraph backend
        ``backend`` (:func:`.subgraph.partition`)."""
        from .subgraph import partition
        return partition(self, backend)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Bind zero arrays of the shapes inferred from ``kwargs`` (the
        data's shapes) and the dtypes of ``type_dict`` (float32 for the
        names it leaves out), with a gradient array for each argument whose
        ``grad_req`` (one for all, or a dict by name) is not ``"null"``."""
        from ..ndarray import ndarray as _nd
        from .executor import Executor
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        if missing:
            raise MXNetError(
                "simple_bind could not infer the shapes of %s; give the "
                "data variables' shapes" % missing)
        types = type_dict or {}
        args = {n: _nd.zeros(s, ctx=ctx, dtype=types.get(n))
                for n, s in zip(arg_names, arg_shapes)}
        reqs = grad_req if isinstance(grad_req, dict) else \
            dict.fromkeys(arg_names, grad_req)
        grads = {n: _nd.zeros(s, ctx=ctx, dtype=types.get(n))
                 for n, s in zip(arg_names, arg_shapes)
                 if reqs.get(n, "null") != "null"}
        aux = {n: _nd.zeros(s, ctx=ctx, dtype=types.get(n))
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self._env_partitioned(), ctx, args, grads,
                        grad_req, aux, group2ctx=group2ctx)

    # ---- serialization ----------------------------------------------------
    def tojson(self):
        """The graph as the reference writes it (``save``)."""
        nodes = self._toposort()
        idx = {id(n): i for i, n in enumerate(nodes)}
        out = {"nodes": [], "arg_nodes": [], "heads": [],
               "mxnet_tpu_version": 1}
        for i, n in enumerate(nodes):
            entry = {"op": n._op.name if n._op else "null",
                     "name": n._name or ("node%d" % i),
                     "inputs": [[idx[id(p)], oi] for p, oi in n._inputs]}
            raw = getattr(n, "_raw_inputs", None)
            if raw is not None and any(_is_const(p) for p in raw):
                consts = []
                for pos, p in enumerate(raw):
                    if _is_const(p):
                        try:
                            json.dumps(p[1])
                        except (TypeError, ValueError):
                            raise MXNetError(
                                "cannot serialize non-JSON const input %r of "
                                "node %s" % (p[1], n._name))
                        consts.append([pos, p[1]])
                entry["const_inputs"] = consts
            if n._kwargs:
                # json-encoded, strings included: '"4.0"' is a string and
                # '4.0' a float when read back
                entry["attrs"] = {k: json.dumps(v)
                                  for k, v in n._kwargs.items()}
            if n._attr:
                entry["node_attrs"] = {k: str(v) for k, v in n._attr.items()}
            out["nodes"].append(entry)
            if n._op is None:
                out["arg_nodes"].append(i)
        for s, oi in self._outputs_list():
            out["heads"].append([idx[id(s)], oi])
        return json.dumps(out, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def attr_dict(self):
        return {n._name: {k: str(v) for k, v in n._attr.items()}
                for n in self._toposort() if n._attr}


def _scalar(v):
    return isinstance(v, numbers.Number)


def _is_const(p):
    return isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], str) \
        and p[0] == "const"


def _out_key(sym, idx):
    return "%s#%d" % (id(sym), idx)


class AttrScope:
    """Default attributes for the symbols made inside the ``with`` block
    (``ctx_group`` and the like); scopes nest, per thread."""
    _tls = threading.local()

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    @staticmethod
    def _stack():
        st = getattr(AttrScope._tls, "stack", None)
        if st is None:
            st = AttrScope._tls.stack = []
        return st

    def __enter__(self):
        st = AttrScope._stack()
        st.append({**(st[-1] if st else {}), **self._attrs})
        return self

    def __exit__(self, *a):
        AttrScope._stack().pop()

    @staticmethod
    def current_attrs():
        st = AttrScope._stack()
        return dict(st[-1]) if st else {}


def _with_scope_attrs(attr):
    merged = AttrScope.current_attrs()
    if attr:
        merged.update(attr)
    return merged or None


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A variable named ``name``; ``shape`` seeds shape inference."""
    s = Symbol(op=None, name=name, attr=_with_scope_attrs(attr))
    s._shape_hint = tuple(shape) if shape is not None else None
    s._dtype_hint = dtype
    s._init = init
    s._lr_mult = lr_mult
    s._wd_mult = wd_mult
    return s


Variable = var


def Group(symbols):
    """One symbol whose outputs are all of ``symbols``' outputs."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs_list())
    g = Symbol(op=None, name="group")
    g._group = outs
    return g


# ---- composition ------------------------------------------------------------

# ops whose parameters are made as variables when only the data is given:
# (slots after the data, aux slots)
_PARAM_SLOTS = {
    "FullyConnected": (["weight", "bias"], []),
    "Convolution": (["weight", "bias"], []),
    "Deconvolution": (["weight", "bias"], []),
    "BatchNorm": (["gamma", "beta"], ["moving_mean", "moving_var"]),
    "Embedding": (["weight"], []),
    "LayerNorm": (["gamma", "beta"], []),
    "InstanceNorm": (["gamma", "beta"], []),
    "GroupNorm": (["gamma", "beta"], []),
}

_counters = {}
_counter_lock = threading.Lock()


def _auto_name(opname):
    k = opname.lower()
    with _counter_lock:
        c = _counters.get(k, 0)
        _counters[k] = c + 1
    return "%s%d" % (k, c)


def _sym_op(opname):
    """The symbolic constructor of the registry's op ``opname``."""
    op = get_op(opname)
    if op is None:
        raise AttributeError("no operator %r" % opname)

    def make(*args, name=None, attr=None, **kwargs):
        name = name or _auto_name(opname)
        slots, aux_slots = _PARAM_SLOTS.get(op.name, ([], []))
        tensor_args = list(args)
        if slots and sum(isinstance(a, Symbol) for a in args) <= 1:
            no_bias = kwargs.get("no_bias", False)
            for slot in slots:
                if slot == "bias" and no_bias:
                    tensor_args.append(None)
                elif isinstance(kwargs.get(slot), Symbol):
                    tensor_args.append(kwargs.pop(slot))
                else:
                    tensor_args.append(var("%s_%s" % (name, slot)))
            for slot in aux_slots:
                tensor_args.append(var("%s_%s" % (name, slot),
                                       attr={"__aux__": True}))
        # a variable composed into an aux slot is an auxiliary state
        for j in range(len(aux_slots)):
            pos = 1 + len(slots) + j
            if pos < len(tensor_args) and \
                    isinstance(tensor_args[pos], Symbol) and \
                    tensor_args[pos]._op is None:
                tensor_args[pos]._attr["__aux__"] = True
        raw = []
        for a in tensor_args:
            if isinstance(a, Symbol):
                outs = a._outputs_list()
                if len(outs) != 1:
                    raise MXNetError(
                        "cannot compose a symbol of %d outputs into %s"
                        % (len(outs), opname))
                raw.append(outs[0])
            else:
                raw.append(("const", a))
        node = Symbol(op=op, kwargs=kwargs, name=name,
                      attr=_with_scope_attrs(attr))
        node._raw_inputs = raw
        node._inputs = [p for p in raw if not _is_const(p)]
        return node

    make.__name__ = opname
    return make


def _populate_ops(ns):
    for opname in list_ops():
        if opname not in ns:
            ns[opname] = _sym_op(opname)


# the torch calls of the port's composite blocks (the zoo's residuals,
# concatenations and ReLU6) -> the op the reference's hybrid_forward emits
_TORCH_FUNCTIONS = {
    torch.relu: lambda x: _sym_op("Activation")(x, act_type="relu"),
    torch.cat: lambda tensors, dim=0: _sym_op("concat")(*tensors, dim=dim),
    torch.clamp: lambda x, min=None, max=None: _sym_op("clip")(x, min, max),
}


# ---- evaluation -------------------------------------------------------------

def _node_args(node, values):
    args = []
    for p in getattr(node, "_raw_inputs", node._inputs):
        if _is_const(p):
            args.append(p[1])
        else:
            args.append(values[_out_key(*p)])
    return args


def evaluate_graph(root, bindings, bind_state=False, placement=None):
    """Run ``root``'s graph on tensors: ``bindings`` maps each variable's
    name to its tensor; returns the output tensors. ``placement`` maps a
    node's id to the ``torch.device`` its op runs on (``group2ctx``): its
    tensor arguments are copied there first (differentiably, so a
    backward copies the gradients back).

    Each node calls its op's function with the node's attrs. With
    ``bind_state`` the op's state binders (the training flag, the dropout
    key) are resolved as an eager call resolves them (``SymbolBlock``);
    without, the functions take their defaults, as the reference's
    executor runs them: ``BatchNorm`` then normalizes by its moving
    statistics and ``Dropout`` is the identity, in training too."""
    values = {}
    for node in root._toposort():
        if node._op is None:
            if node._name not in bindings:
                raise MXNetError("unbound variable %r" % node._name)
            values[_out_key(node, 0)] = bindings[node._name]
            continue
        kwargs = node._kwargs
        if bind_state and node._op.state_binders:
            kwargs = dict(kwargs)
            for kname, binder in node._op.state_binders.items():
                if kname not in kwargs:
                    kwargs[kname] = binder()
        args = _node_args(node, values)
        dev = placement.get(id(node)) if placement else None
        if dev is not None:
            args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args]
        out = node._op.fn(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            for i, v in enumerate(out):
                values[_out_key(node, i)] = v
        else:
            values[_out_key(node, 0)] = out
    return [values[_out_key(s, i)] for s, i in root._outputs_list()]


def _infer_shapes(root, known_shapes):
    """``{variable name or output key: shape}``: each op's function runs on
    ``meta`` tensors of its inputs' shapes, after the parameter rules have
    sized the variables that the given shapes leave open."""
    shapes = {k: tuple(v) for k, v in known_shapes.items()}
    for node in root._toposort():
        if node._op is None:
            if node._name not in shapes and node._shape_hint is not None \
                    and all(d > 0 for d in node._shape_hint):
                shapes[node._name] = node._shape_hint
            continue
        raw = getattr(node, "_raw_inputs", node._inputs)
        in_shapes = []
        for p in raw:
            if _is_const(p):
                in_shapes.append(p)
            else:
                sym, oi = p
                key = sym._name if sym._op is None else _out_key(sym, oi)
                in_shapes.append(shapes.get(key))
        data_shape = next((s for s in in_shapes
                           if s is not None and not _is_const(s)), None)
        rule = _PARAM_SHAPE_RULES.get(node._op.name)
        if rule is not None and data_shape is not None:
            slot_names = _PARAM_SLOTS[node._op.name][0] + \
                _PARAM_SLOTS[node._op.name][1]
            for j, p in enumerate(raw):
                if j == 0 or in_shapes[j] is not None or _is_const(p) \
                        or j - 1 >= len(slot_names):
                    continue
                inferred = rule(data_shape, node._kwargs, slot_names[j - 1])
                if inferred is not None:
                    in_shapes[j] = tuple(inferred)
                    if p[0]._op is None:
                        shapes[p[0]._name] = tuple(inferred)
        if any(s is None for s in in_shapes):
            raise MXNetError("infer_shape: cannot resolve the inputs of %s "
                             "(%s)" % (node._name, node._op.name))
        args = [s[1] if _is_const(s) else
                torch.empty(s, dtype=torch.float32, device="meta")
                for s in in_shapes]
        try:
            with torch.no_grad():
                out = node._op.fn(*args, **node._kwargs)
        except Exception as err:
            raise MXNetError(
                "infer_shape: %s (%s) cannot run on shapes alone (%s: %s)"
                % (node._name, node._op.name, type(err).__name__, err)) \
                from err
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            shapes[_out_key(node, i)] = tuple(o.shape)
    return shapes


def _prod_tail(shape):
    r = 1
    for d in shape[1:]:
        r *= d
    return r


def _pairify(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_PARAM_SHAPE_RULES = {
    "FullyConnected": lambda ds, kw, slot: {
        "weight": (kw.get("num_hidden"), _prod_tail(ds)
                   if kw.get("flatten", True) else ds[-1]),
        "bias": (kw.get("num_hidden"),)}.get(slot),
    "Convolution": lambda ds, kw, slot: {
        "weight": (kw.get("num_filter"),
                   ds[1] // kw.get("num_group", 1)) +
        tuple(_pairify(kw.get("kernel"), len(ds) - 2)),
        "bias": (kw.get("num_filter"),)}.get(slot),
    "Deconvolution": lambda ds, kw, slot: {
        "weight": (ds[1], kw.get("num_filter") // kw.get("num_group", 1)) +
        tuple(_pairify(kw.get("kernel"), len(ds) - 2)),
        "bias": (kw.get("num_filter"),)}.get(slot),
    "BatchNorm": lambda ds, kw, slot: (ds[kw.get("axis", 1)],),
    "LayerNorm": lambda ds, kw, slot: (ds[kw.get("axis", -1)],),
    "InstanceNorm": lambda ds, kw, slot: (ds[1],),
    "GroupNorm": lambda ds, kw, slot: (ds[1],),
    "Embedding": lambda ds, kw, slot: (kw.get("input_dim"),
                                       kw.get("output_dim")),
}


# ---- creation helpers and files ---------------------------------------------

def zeros(shape, dtype=None, **kwargs):
    raise NotImplementedError("use mx.sym.var + executor bindings")


def ones(shape, dtype=None, **kwargs):
    raise NotImplementedError("use mx.sym.var + executor bindings")


def arange(start, stop=None, step=1.0, **kwargs):
    raise NotImplementedError("use mx.sym.var + executor bindings")


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _attr_value(sv):
    """A typed attr from its string: the reference's ``json.dumps`` form
    (``'"4.0"'`` a string, ``'4.0'`` a float) or nnvm's plain strings
    (``'64'``, ``'(3, 3)'``, ``'True'``, ``'None'``)."""
    if not isinstance(sv, str):
        return sv
    try:
        return json.loads(sv)
    except (ValueError, TypeError):
        pass
    low = sv.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "none":
        return None
    try:
        return ast.literal_eval(sv)
    except (ValueError, SyntaxError):
        return sv


def load_json(json_str):
    """A graph from :meth:`Symbol.tojson`'s format or from an nnvm
    ``-symbol.json`` (plain string attrs, 3-element entries, other
    top-level keys ignored)."""
    data = json.loads(json_str)
    nodes = []
    for entry in data["nodes"]:
        if entry["op"] == "null":
            attr = dict(entry.get("attrs") or {})
            attr.update(entry.get("node_attrs") or {})
            nodes.append(var(entry["name"], attr=attr or None))
            continue
        op = get_op(entry["op"])
        if op is None:
            raise MXNetError("cannot load symbol: unknown operator %r"
                             % entry["op"])
        kwargs = {k: _attr_value(sv)
                  for k, sv in (entry.get("attrs") or {}).items()}
        node = Symbol(op=op, kwargs=kwargs, name=entry["name"])
        sym_inputs = [(nodes[e[0]], e[1]) for e in entry["inputs"]]
        consts = {pos: val for pos, val in entry.get("const_inputs", [])}
        if consts:
            raw, si = [], iter(sym_inputs)
            for pos in range(len(sym_inputs) + len(consts)):
                raw.append(("const", consts[pos]) if pos in consts
                           else next(si))
        else:
            raw = sym_inputs
        node._raw_inputs = raw
        node._inputs = sym_inputs
        nodes.append(node)
    heads = [(nodes[e[0]], e[1]) for e in data["heads"]]
    if len(heads) == 1 and heads[0][1] == 0:
        return heads[0][0]
    g = Symbol(op=None, name="group")
    g._group = heads
    return g
