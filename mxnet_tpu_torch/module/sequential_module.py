"""SequentialModule and PythonModule: counterparts of
``mxnet_tpu/module/sequential_module.py``. A ``SequentialModule`` chains
modules (each one's outputs are the next one's data; the backward passes
the input gradients back along the chain); a ``PythonModule`` computes in
Python on numpy arrays (``compute``, ``compute_backward``), with no
parameters."""
from __future__ import annotations

import logging

import numpy as np

from ..io import DataBatch
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["SequentialModule", "PythonModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else ("data",)

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else ()

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    **kwargs):
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          force_init=force_init)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        """Bind each module on the previous one's output shapes; the last
        (and any added with ``take_labels``) takes the labels."""
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (m, meta) in enumerate(zip(self._modules, self._metas)):
            last = i == len(self._modules) - 1
            labels = label_shapes \
                if last or meta.get(self.META_TAKE_LABELS) else None
            m.bind(cur_shapes, labels, for_training=for_training,
                   inputs_need_grad=i > 0)
            if not last:
                nxt = self._modules[i + 1]
                outs = m.output_shapes
                assert len(outs) <= len(nxt.data_names), (
                    "module %d produces %d outputs but module %d declares "
                    "%d data inputs" % (i, len(outs), i + 1,
                                        len(nxt.data_names)))
                cur_shapes = [(dn, s) for dn, (_, s)
                              in zip(nxt.data_names, outs)]
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, m in enumerate(self._modules):
            m.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                batch = DataBatch(data=m.get_outputs(),
                                  label=data_batch.label)

    def backward(self, out_grads=None):
        grads = out_grads
        for i, m in enumerate(reversed(self._modules)):
            m.backward(out_grads=grads)
            if i < len(self._modules) - 1:
                grads = m.get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._modules[-1].update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for m in self._modules:
            m.install_monitor(mon)


class PythonModule(BaseModule):
    """A module whose forward is ``compute`` over numpy arrays (a loss or
    glue with no parameters); its outputs lie on its data's device."""

    def __init__(self, data_names=("data",), label_names=("softmax_label",),
                 output_names=("output",), logger=logging):
        super().__init__(logger=logger)
        self._data_names = tuple(data_names)
        self._label_names = tuple(label_names or ())
        self._output_names = tuple(output_names)
        self._outputs = None
        self.params_initialized = True
        self.optimizer_initialized = True

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    def get_params(self):
        return {}, {}

    def init_params(self, *a, **k):
        pass

    def init_optimizer(self, *a, **k):
        pass

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.binded = True

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, None) for n in self._output_names]

    def compute(self, data, labels=None):
        """Override: a list of numpy arrays in, a list out."""
        raise NotImplementedError

    def compute_backward(self, data, labels=None):
        """Override for a trainable upstream: the input gradients."""
        return [np.zeros_like(d) for d in data]

    def forward(self, data_batch, is_train=None):
        self._ctx = data_batch.data[0].ctx
        data = [d.asnumpy() for d in data_batch.data]
        labels = [l.asnumpy() for l in (data_batch.label or [])]
        self._last = (data, labels)
        self._outputs = [NDArray(np.asarray(o), ctx=self._ctx)
                         for o in self.compute(data, labels)]

    def backward(self, out_grads=None):
        data, labels = self._last
        self._in_grads = [NDArray(np.asarray(g), ctx=self._ctx)
                          for g in self.compute_backward(data, labels)]

    def update(self):
        pass

    def get_outputs(self, merge_multi_context=True):
        return self._outputs

    def get_input_grads(self, merge_multi_context=True):
        return self._in_grads

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self._outputs)
