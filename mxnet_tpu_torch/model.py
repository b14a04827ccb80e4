"""Checkpoints, the kvstore choice and ``FeedForward``: counterpart of
``mxnet_tpu/model.py``.

``save_checkpoint``/``load_checkpoint`` write and read
``prefix-symbol.json`` and ``prefix-%04d.params`` (``arg:``/``aux:``
names in the reference's ``.params`` bytes), so checkpoints move between
the two packages both ways. ``_create_kvstore`` makes the store a
``Module`` sums its contexts' gradients through: none over one device
(unless a ``dist*`` store is named, a world of one in this process), else
the named one (``local``, ``device``, ``nccl``) or the store given; the
update runs in the ``Module``. ``FeedForward``, the pre-``Module``
estimator, drives a :class:`~mxnet_tpu_torch.module.Module` (over every
context of ``ctx``).
"""
from __future__ import annotations

import logging

import numpy as _np

from .callback import BatchEndParam  # noqa: F401
from .ndarray import ndarray as _nd

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam",
           "FeedForward"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    _nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` from :func:`save_checkpoint`'s
    files (or ``HybridBlock.export``'s), the arrays on ``ctx`` (the
    current context when None)."""
    from . import symbol as sym_mod
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = _nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: no store over one device for a
    non-``dist`` name; the update never runs on the store."""
    from . import kvstore as kvs
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        kv = None if num_device == 1 and "dist" not in kvstore \
            else kvs.create(kvstore)
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    return kv, False


class FeedForward:
    """The legacy estimator: a symbol and its parameters with
    scikit-learn-style ``fit``/``predict``/``score``, over a ``Module``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _as_iter(self, X, y=None, batch_size=None, shuffle=False):
        from . import io as io_mod
        if hasattr(X, "provide_data"):
            return X
        X = X.asnumpy() if hasattr(X, "asnumpy") else _np.asarray(X)
        if y is not None:
            y = y.asnumpy() if hasattr(y, "asnumpy") else _np.asarray(y)
        return io_mod.NDArrayIter(X, y, batch_size=batch_size or
                                  self.numpy_batch_size, shuffle=shuffle)

    def _init_module(self, data_iter, for_training=True):
        from .module import Module

        def _name(desc):
            return desc[0] if isinstance(desc, (tuple, list)) \
                else getattr(desc, "name", desc)

        sym_args = set(self.symbol.list_arguments())
        data_names = tuple(_name(d) for d in data_iter.provide_data)
        provide_label = getattr(data_iter, "provide_label", None) or []
        label_names = tuple(n for n in (_name(l) for l in provide_label)
                            if n in sym_args)
        self._module = Module(self.symbol, data_names=data_names,
                              label_names=label_names or None,
                              context=self.ctx)
        label_shapes = [l for l in provide_label
                        if _name(l) in label_names] or None
        self._module.bind(data_shapes=data_iter.provide_data,
                          label_shapes=label_shapes,
                          for_training=for_training)
        self._module.init_params(initializer=self.initializer,
                                 arg_params=self.arg_params,
                                 aux_params=self.aux_params,
                                 allow_missing=self.arg_params is not None,
                                 allow_extra=self.allow_extra_params)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        train_iter = self._as_iter(X, y, shuffle=True)
        mod = self._init_module(train_iter)
        if logger is not None:
            mod.logger = logger
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod.fit(train_iter, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _ready_module(self, data_iter):
        if self._module is None or not self._module.binded:
            return self._init_module(data_iter, for_training=False)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (a list of them for several
        outputs); a label input is fed zeros."""
        y = None
        if not hasattr(X, "provide_data") and any(
                n.endswith("label") for n in self.symbol.list_arguments()):
            Xa = X.asnumpy() if hasattr(X, "asnumpy") else _np.asarray(X)
            y = _np.zeros((len(Xa),), _np.float32)
        data_iter = self._as_iter(X, y)
        outs = self._ready_module(data_iter).predict(data_iter,
                                                     num_batch=num_batch)
        if isinstance(outs, list):
            return [o.asnumpy() for o in outs]
        return outs.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        from . import metric as metric_mod
        data_iter = self._as_iter(X, y)
        res = self._ready_module(data_iter).score(
            data_iter, metric_mod.create(eval_metric), num_batch=num_batch)
        vals = [v for _, v in res]
        return vals[0] if len(vals) == 1 else vals

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else (self.num_epoch or 0)
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct and ``fit`` in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
