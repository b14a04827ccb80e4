"""Module: a symbol, its executor and its optimizer; counterpart of
``mxnet_tpu/module/module.py``.

``bind`` binds the symbol for the data's and labels' shapes
(``simple_bind``; a batch of another size rebinds through
``Executor.reshape``, sharing the parameters), ``init_params`` fills the
parameters (given arrays, else the initializer's draws, in
``list_arguments`` order, as the reference draws them), and
``init_optimizer`` makes the optimizer with ``rescale_grad = 1 /
batch_size``, the batch size read on the data layout's batch axis (times
a dist store's ``num_workers``: the global batch).
``forward``/``backward``/``update`` run the executor and apply the
updater to each parameter's gradient in place. The data take a gradient
only with ``inputs_need_grad``, and the labels never, as in MXNet 1.6.

The executor runs on ``context`` (the current context when None: the
card unless a ``with mx.cpu():`` scope is open, where the reference takes
the CPU). A list of contexts is data parallelism: one executor a context,
each bound for its equal slice of the batch (along the batch axis); a
forward splits the batch over them, ``get_outputs`` concatenates their
outputs, and ``update`` sums each parameter's gradients through the store
of ``init_optimizer`` (``local``, ``device``, ``nccl``, a ``dist*`` one
as a world of one; summed in context order without one), updates the
first context's parameters and copies them to the others. The reference
runs the whole batch as one program, so both give one device's step.
``group2ctxs`` (a dict, or a list of them of which the first is taken)
places the symbol's ``ctx_group`` groups at bind (``Executor``).
``save_optimizer_states`` writes the reference's ``.states`` format.
"""
from __future__ import annotations

import logging

import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..context import current_context
from ..io.io import DataDesc
from ..model import _create_kvstore
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _contexts(context):
    ctxs = list(context) if isinstance(context, (list, tuple)) \
        else [context]
    return [current_context() if c is None else c for c in ctxs or [None]]


def _one_context(context):
    return _contexts(context)[0]


def _shapes(descs):
    return [(d.name, tuple(d.shape)) if isinstance(d, DataDesc)
            else (d[0], tuple(d[1])) for d in descs or []]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._contexts = _contexts(context)
        self._context = self._contexts[0]
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if group2ctxs else None
        self._group2ctxs = group2ctxs
        self._execs = []
        self._kvstore = None
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        inputs = set(self._data_names + self._label_names +
                     self._state_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._monitor = None
        self._grad_req = "write"
        self._batch_axis = 0
        self._data_shapes = []
        self._label_shapes = []

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module from ``save_checkpoint``'s files; its parameters are
        set at ``bind``."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(
            prefix, epoch, ctx=_one_context(kwargs.get("context")))
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        self.logger.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ---- properties -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec.outputs:
            return [(n, tuple(o.shape)) for n, o in
                    zip(self._output_names, self.get_outputs())]
        _, out_shapes, _ = self._symbol.infer_shape(
            **dict(self._data_shapes + self._label_shapes))
        return list(zip(self._output_names, map(tuple, out_shapes)))

    # ---- parameters -------------------------------------------------------
    def get_params(self):
        """The executor's parameter and aux arrays (live, by name)."""
        assert self.binded and self.params_initialized
        return ({n: self._exec.arg_dict[n] for n in self._param_names},
                {n: self._exec.aux_dict[n] for n in self._aux_names})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill each parameter, then each aux state, from ``arg_params``/
        ``aux_params``, else from the arrays the module was loaded with,
        else from ``initializer`` (``Uniform(0.01)`` when None)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        for names, given, held, arrays in (
                (self._param_names, arg_params, self._arg_params,
                 self._exec.arg_dict),
                (self._aux_names, aux_params, self._aux_params,
                 self._exec.aux_dict)):
            for name in names:
                arr = arrays[name]
                if given is not None and name in given:
                    arr[:] = given[name]
                elif held is not None and name in held:
                    arr[:] = held[name]
                else:
                    initializer(init_mod.InitDesc(name), arr._data)
        self._broadcast(aux=True)
        self.params_initialized = True

    def _broadcast(self, aux=False):
        """The first context's parameters (and aux states) into every
        other context's executor."""
        first = self._exec
        for ex in self._execs[1:]:
            for n in self._param_names:
                ex.arg_dict[n][:] = first.arg_dict[n]
            for n in self._aux_names if aux else ():
                ex.aux_dict[n][:] = first.aux_dict[n]

    def _slice_shapes(self, shapes):
        """Each context's input shapes: the batch axis split evenly."""
        n = len(self._contexts)
        if n == 1:
            return dict(shapes)
        out = {}
        ax = self._batch_axis
        for name, shape in shapes.items():
            shape = tuple(shape)
            if shape[ax] % n:
                raise ValueError(
                    "batch of %d (%s) does not split evenly over %d "
                    "contexts" % (shape[ax], name, n))
            out[name] = shape[:ax] + (shape[ax] // n,) + shape[ax + 1:]
        return out

    def _split(self, value):
        """``value`` (an NDArray) in one equal slice a context."""
        n = len(self._contexts)
        if n == 1:
            return [value]
        t = value._data if hasattr(value, "_data") else value
        return [NDArray(c) for c in torch.chunk(t, n, self._batch_axis)]

    # ---- bind -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor for these shapes. Parameters already held (a
        loaded module's, or a rebound one's) are copied in;
        ``shared_module``'s parameter and aux arrays are shared."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        held = self.get_params() \
            if self.binded and self.params_initialized else None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        first = (data_shapes or [None])[0]
        self._batch_axis = DataDesc.get_batch_axis(first.layout) \
            if isinstance(first, DataDesc) else 0
        self._data_shapes = _shapes(data_shapes)
        self._label_shapes = _shapes(label_shapes)
        reqs = {}
        for n in self._symbol.list_arguments():
            if not for_training or n in self._label_names or \
                    n in self._state_names or n in self._fixed_param_names:
                reqs[n] = "null"
            elif n in self._data_names:
                reqs[n] = grad_req if inputs_need_grad else "null"
            else:
                reqs[n] = grad_req
        shapes = self._slice_shapes(
            dict(self._data_shapes + self._label_shapes))
        self._execs = [self._symbol.simple_bind(
            ctx, grad_req=reqs, group2ctx=self._group2ctxs, **shapes)
            for ctx in self._contexts]
        self._exec = self._execs[0]
        if shared_module is not None:
            for ex, shared in zip(self._execs, shared_module._execs):
                for mine, theirs in ((ex.arg_dict, shared.arg_dict),
                                     (ex.aux_dict, shared.aux_dict)):
                    for n in list(mine):
                        if n not in self._data_names + self._label_names \
                                and n in theirs \
                                and theirs[n].shape == mine[n].shape:
                            mine[n] = theirs[n]
        self.binded = True
        given = held if held is not None else \
            (self._arg_params, self._aux_params) \
            if self.params_initialized and self._arg_params is not None \
            else None
        if given is not None:
            for ex in self._execs:
                ex.copy_params_from(*given, allow_extra_params=True)
        if self._monitor is not None:
            for ex in self._execs:
                self._monitor.install(ex)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, sharing the parameters."""
        assert self.binded
        self._data_shapes = _shapes(data_shapes)
        self._label_shapes = _shapes(label_shapes)
        self._reshape(dict(self._data_shapes + self._label_shapes))

    def _reshape(self, shapes):
        shapes = self._slice_shapes(shapes)
        self._execs = [ex.reshape(**shapes) for ex in self._execs]
        self._exec = self._execs[0]
        if self._monitor is not None:
            for ex in self._execs:
                self._monitor.install(ex)

    # ---- optimizer --------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (a name with ``optimizer_params``, or an
        ``Optimizer``) and its updater; ``rescale_grad`` defaults to
        ``1 / batch_size``."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._kvstore, _ = _create_kvstore(kvstore, len(self._contexts),
                                           None)
        if self._kvstore is not None:
            for i, name in enumerate(self._param_names):
                self._kvstore.init(i, self._exec.arg_dict[name])
        batch_size = self._data_shapes[0][1][self._batch_axis] \
            if self._data_shapes else 1
        # a dist store sums the gradients of every worker's batch: the
        # global batch is num_workers times the bound one (the reference's
        # module.py:222-226, MXNet's module.py:505)
        kv = self._kvstore
        if kv is None and isinstance(kvstore, str) and kvstore:
            from .. import kvstore as kvs
            kv = kvs.create(kvstore)
        if kv is not None:
            batch_size *= kv.num_workers
        rescale_grad = 1.0 / max(batch_size, 1)
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but "
                "rescale_grad is not normalized to 1.0/batch_size "
                "(%s vs. %s). Is this intended?", optimizer.rescale_grad,
                rescale_grad)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ---- compute ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feed.update(zip(self._label_names, data_batch.label))
        sliced = self._slice_shapes({n: tuple(v.shape)
                                     for n, v in feed.items()})
        if any(self._exec.arg_dict[n].shape != s for n, s in sliced.items()):
            self._reshape({n: tuple(v.shape) for n, v in feed.items()})
        parts = {n: self._split(v) for n, v in feed.items()}
        for i, ex in enumerate(self._execs):
            ex.forward(is_train=is_train,
                       **{n: p[i] for n, p in parts.items()})

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if len(self._execs) == 1:
            self._exec.backward(out_grads=out_grads)
            return
        if out_grads is not None and not isinstance(out_grads, (list,
                                                                tuple)):
            out_grads = [out_grads]
        parts = None if out_grads is None else \
            [self._split(g) for g in out_grads]
        for i, ex in enumerate(self._execs):
            ex.backward(out_grads=None if parts is None
                        else [p[i] for p in parts])

    def update(self):
        """Apply the updater to every parameter that is not fixed, by its
        index in the parameter list, to the gradient summed over the
        contexts (through the store when there is one: a dist store sums
        over the workers too)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for i, name in enumerate(self._param_names):
            grads = [ex.grad_dict.get(name) for ex in self._execs]
            if name in self._fixed_param_names or grads[0] is None:
                continue
            if self._kvstore is not None:
                # the store sums the contexts' gradients and, for a dist
                # store, every worker's (MXNet's _update_params)
                self._kvstore.push(i, grads)
                self._kvstore.pull(i, out=grads[:1])
            elif len(grads) > 1:
                with torch.no_grad():
                    for g in grads[1:]:
                        grads[0]._data.add_(g._data.to(
                            grads[0]._data.device))
            self._updater(i, grads[0]._data, self._exec.arg_dict[name]._data)
        self._broadcast()

    def _merged(self, per_exec, merge):
        """Per-context lists of arrays: concatenated along the batch axis
        (``merge``), else one list a position of each context's."""
        if len(per_exec) == 1:
            return per_exec[0]
        by_pos = [list(arrs) for arrs in zip(*per_exec)]
        if not merge:
            return by_pos
        dev = self._exec._device
        return [NDArray(torch.cat([a._data.to(dev) for a in arrs],
                                  self._batch_axis)) for arrs in by_pos]

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._merged([ex.outputs for ex in self._execs],
                            merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._merged([[ex.grad_dict.get(n) for n in self._data_names]
                             for ex in self._execs], merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self.get_outputs())))

    def install_monitor(self, mon):
        """Install the ``Monitor`` on every executor, and on each executor
        a rebind makes."""
        assert self.binded
        self._monitor = mon
        for ex in self._execs:
            mon.install(ex)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
