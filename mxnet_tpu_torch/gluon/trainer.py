"""The eager Gluon ``Trainer``: counterpart of
``mxnet_tpu/gluon/trainer.py``.

``Trainer(collect_params(net), "adam", {...})`` applies an optimizer
(:mod:`mxnet_tpu_torch.optimizer`) to the parameters' tensors in place,
after the caller's own forward and ``backward``::

    params = collect_params(net)
    params.initialize(initializer.Xavier())
    trainer = Trainer(params, "adam", {"learning_rate": 1e-4})
    loss = loss_fn(net(x), y)          # per-sample losses
    loss.backward(torch.ones_like(loss))
    trainer.step(batch_size)           # rescale_grad = scale / batch_size

As in the reference, a dict of parameters is indexed by SORTED name: that
index keys the optimizer's states, its update counts and
``save_states``. The store (``kvstore``: ``"device"``, ``"local"``,
``"nccl"``, a ``dist_*`` name as a world of one, a
:class:`~mxnet_tpu_torch.kvstore.KVStore`, or None) only sums gradients
across contexts: over parameters on several contexts (``initialize(ctx=
[...])``) ``allreduce_grads`` pushes each parameter's gradient copies and
pulls their sum back into every copy, and each context's copy is then
updated by its own updater; over one context no store is made (a
``dist_*`` one excepted), as in the reference.
"""
from __future__ import annotations

from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a list or dict of :class:`Parameter`.

    ``optimizer`` is a registered name (with ``optimizer_params``) or an
    ``Optimizer``; ``kvstore`` a store's name, a store, or None."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(list(params.keys()))]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_kind = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = False

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise ValueError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (param.name, ctx, contexts))
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        """The store: made from its name over several contexts (or for a
        ``dist_*`` name), each trained parameter's first copy its initial
        value."""
        from .. import kvstore as kvs
        kind = self._kvstore_kind
        if kind is None or (isinstance(kind, str) and
                            len(self._contexts) <= 1 and
                            not kind.startswith("dist")):
            self._kvstore = None
        else:
            self._kvstore = kvs.create(kind) if isinstance(kind, str) \
                else kind
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.init(i, param.list_data()[0])
        self._kv_initialized = True

    def allreduce_grads(self):
        """Sum each parameter's gradient copies through the store and
        write the sum into every copy."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                grads = param.list_grad()
                self._kvstore.push(i, grads)
                self._kvstore.pull(i, out=grads)

    def step(self, batch_size, ignore_stale_grad=False):
        """Normalize the gradients by ``batch_size`` (``rescale_grad =
        scale / batch_size``), sum them across contexts and update every
        parameter."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """:meth:`step` without the all-reduce."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            for upd, ctx in zip(self._updaters, param.list_ctx()):
                upd(i, param.grad_tensor(ctx), param.tensor(ctx))

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer (pickled)."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read :meth:`save_states`' file (written by this package: it is
        unpickled); the optimizer it holds takes this trainer's
        parameters."""
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param in
                                      enumerate(self._params)}
