"""Executor: a Symbol bound to arrays on one device.

Counterpart of ``mxnet_tpu/symbol/executor.py``. The bound arrays
(``arg_dict``, ``grad_dict``, ``aux_dict``) are NDArrays bound to tensors
that the executor keeps for its lifetime: ``forward(**kwargs)``,
``copy_params_from``, ``arr[:] = ...`` and an optimizer's update all
write into them in place, so a captured CUDA graph keeps reading them.

- An inference forward (``is_train=False``) runs through one
  :class:`~mxnet_tpu_torch.cached_op.CachedOp` per set of fed names and
  storage of the other arrays: on the card one CUDA graph per input
  signature, whose inputs are the arrays fed to ``forward``; the other
  bound arrays are read in place.
- A training forward runs the graph's op functions eagerly under torch's
  autograd; :meth:`backward` takes the gradients of that forward's
  outputs (``out_grads``, or ones) with respect to every argument whose
  ``grad_req`` is not ``"null"``, and writes (``"write"``) or adds
  (``"add"``) them into ``grad_dict``.

The op functions take their defaults for the state an eager call binds,
as the reference's executor calls them: ``BatchNorm`` normalizes by its
moving statistics and writes none, and ``Dropout`` is the identity, in
training too (ROADMAP "Standing hazards"). The training flag is
``is_train`` while a forward runs, so a ``Custom`` op's ``forward`` sees
it, as in the reference. ``set_monitor_callback`` hands
every operator's output (every node's, with ``monitor_all``) to the
callback after a forward.

``group2ctx`` (the reference's model-parallel placement) maps
``ctx_group`` names (``AttrScope(ctx_group=...)``) to contexts: a node of
a mapped group runs on its group's device (``_placement``: node id ->
context), its tensor arguments copied there first, so a forward copies
activations across devices and a backward copies their gradients back.
"""
from __future__ import annotations

import torch

from ..autograd import predict_mode, train_mode
from ..base import MXNetError
from ..cached_op import CachedOp
from ..ndarray.ndarray import NDArray
from .symbol import evaluate_graph

__all__ = ["Executor"]


def _adopt(arr, device):
    """``arr`` as an NDArray bound to a tensor on ``device``: the caller's
    NDArray itself where it already lies there (so that its writes reach
    the executor and the executor's reach it), else a copy."""
    if isinstance(arr, NDArray) and arr._data.device == device \
            and not arr._data.requires_grad:
        arr._bound = True
        return arr
    data = arr._data if isinstance(arr, NDArray) else \
        torch.as_tensor(arr)
    return NDArray._bind(data.detach().to(device, copy=True))


def _as_dict(value, names):
    if isinstance(value, (list, tuple)):
        return dict(zip(names, value))
    return dict(value) if value else {}


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self._placement = {}
        for node in symbol._toposort() if group2ctx else ():
            grp = node._attr.get("ctx_group") or \
                node._attr.get("__ctx_group__")
            if grp is not None and grp in group2ctx:
                self._placement[id(node)] = group2ctx[grp]
        self._ctx = ctx
        self._device = ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        dev = self._device
        self.arg_dict = {n: _adopt(a, dev) for n, a in
                         _as_dict(args, self._arg_names).items()}
        self.grad_dict = {n: _adopt(a, dev) for n, a in
                          _as_dict(args_grad, self._arg_names).items()
                          if a is not None}
        self.aux_dict = {n: _adopt(a, dev) for n, a in
                         _as_dict(aux_states, self._aux_names).items()}
        missing = [n for n in self._arg_names + self._aux_names
                   if n not in self.arg_dict and n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: no array for %s" % missing)
        if isinstance(grad_req, str):
            self._grad_req = dict.fromkeys(self._arg_names, grad_req)
        else:
            self._grad_req = _as_dict(grad_req, self._arg_names)
        self.outputs = []
        self._cached_ops = {}
        self._train_state = None
        self._monitor = None
        self._monitor_all = False

    # ---- forward ----------------------------------------------------------
    def _bindings(self):
        b = {n: a._data for n, a in self.arg_dict.items()}
        b.update((n, a._data) for n, a in self.aux_dict.items())
        return b

    def _devices(self):
        """``_placement`` as torch devices (None without one)."""
        if not self._placement:
            return None
        return {k: c.torch_device for k, c in self._placement.items()}

    def _wanted(self):
        return [n for n in self._arg_names
                if self._grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def forward(self, is_train=False, **kwargs):
        """Copy ``kwargs`` into their arguments and run the graph; returns
        (and keeps in ``outputs``) the output NDArrays."""
        for n, v in kwargs.items():
            if n not in self.arg_dict:
                raise MXNetError("unknown argument %r" % n)
            self.arg_dict[n][:] = v
        with train_mode() if is_train else predict_mode():
            if is_train:
                self.outputs = [NDArray(o.detach()) for o in self._train()]
            else:
                self._train_state = None
                self.outputs = self._infer(sorted(kwargs) or
                                           self._arg_names)
        if self._monitor is not None:
            self._report()
        return self.outputs

    def _train(self):
        """One eager forward under autograd, kept for :meth:`backward`."""
        wanted = self._wanted()
        binds = self._bindings()
        leaves = []
        for n in wanted:
            leaf = binds[n].detach().requires_grad_(True)
            binds[n] = leaf
            leaves.append(leaf)
        with torch.enable_grad():
            outs = evaluate_graph(self._symbol, binds,
                                  placement=self._devices())
        self._train_state = (outs, leaves, wanted)
        return outs

    def _infer(self, fed):
        """The inference forward through the CachedOp of ``fed`` and of
        the other arrays' storage."""
        fed = tuple(fed)
        rest = tuple((n, a._data) for n, a in
                     list(self.arg_dict.items()) + list(self.aux_dict.items())
                     if n not in fed)
        key = (fed, tuple(t.data_ptr() for _, t in rest))
        op = self._cached_ops.get(key)
        if op is None:
            symbol, placement = self._symbol, self._devices()

            def run(*vals):
                binds = dict(rest)
                binds.update((n, v._data) for n, v in zip(fed, vals))
                return evaluate_graph(symbol, binds, placement=placement)

            op = self._cached_ops[key] = CachedOp(run, name="Executor")
        return op(*[self.arg_dict[n] for n in fed])

    # ---- backward ---------------------------------------------------------
    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs (a training
        forward is run first where there was none), weighted by
        ``out_grads`` (ones when None)."""
        if self._train_state is None:
            with train_mode():
                self._train()
        outs, leaves, wanted = self._train_state
        self._train_state = None
        if not wanted:
            return
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [g._data if isinstance(g, NDArray) else
                   torch.as_tensor(g, device=self._device)
                   for g in out_grads]
        live = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in live], leaves, [c for _, c in live],
            allow_unused=True) if live else [None] * len(leaves)
        with torch.no_grad():
            for n, g in zip(wanted, grads):
                tgt = self.grad_dict[n]._data
                if g is None:
                    g = torch.zeros_like(tgt)
                if self._grad_req.get(n) == "add":
                    tgt.add_(g)
                else:
                    tgt.copy_(g)

    # ---- arrays -----------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, array in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "auxiliary states" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for the input shapes in ``kwargs``: every array
        whose shape stays is shared with this one (the parameters and the
        aux states), the others are new zeros."""
        from ..ndarray import ndarray as _nd
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep(old, names, shapes):
            return {n: old[n] if n in old and old[n].shape == tuple(s)
                    else _nd.zeros(s, ctx=self._ctx)
                    for n, s in zip(names, shapes)}

        grads = keep(self.grad_dict, self._arg_names, arg_shapes) \
            if self.grad_dict else None
        return Executor(self._symbol, self._ctx,
                        keep(self.arg_dict, self._arg_names, arg_shapes),
                        grads, self._grad_req,
                        keep(self.aux_dict, self._aux_names, aux_shapes),
                        group2ctx=self._group2ctx)

    # ---- debugging --------------------------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` after each forward for every
        operator output (and, with ``monitor_all``, every bound input),
        in the graph's order."""
        self._monitor = callback
        self._monitor_all = bool(monitor_all)

    def _report(self):
        internals = self._symbol.get_internals()
        skip = set() if self._monitor_all else \
            set(self._arg_names) | set(self._aux_names)
        with torch.no_grad():
            values = evaluate_graph(internals, self._bindings(),
                                    placement=self._devices())
        for n, v in zip(internals.list_outputs(), values):
            if n not in skip:
                self._monitor(n, NDArray(v))

    def debug_str(self):
        return self._symbol.tojson()
