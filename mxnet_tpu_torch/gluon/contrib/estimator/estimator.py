"""Estimator, the high-level Gluon fit API: counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``.

``Estimator(net, loss, metrics, initializer, trainer, context)``;
``fit(train_data, val_data, epochs | batches, event_handlers)`` over a
``gluon.data.DataLoader`` (anything else is refused), ``fit_batch``,
``evaluate`` and ``evaluate_batch`` to override, and the default handlers
(stopping, metrics, logging, validation when ``val_data`` is given). A
step is the eager one: the forward under ``autograd.record()``, the
loss's ``backward`` and ``trainer.step(batch_size)``. ``context``
defaults to ``current_context()``: the card, unless a ``with mx.cpu():``
scope or ``context=`` says otherwise; an uninitialized net is initialized
there.
"""
from __future__ import annotations

import logging

from ... import loss as gluon_loss
from ...trainer import Trainer
from ...data import DataLoader
from ....context import current_context
from .... import autograd
from ....metric import EvalMetric, Loss as LossMetric, Accuracy
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler,
                            LoggingHandler)

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = self._check_loss(loss)
        self.train_metrics = self._check_metrics(metrics)
        self.context = self._check_context(context)
        self._initialize(initializer)
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.001})
        self.max_epoch = None
        self.max_batch = None
        self.stop_training = False
        self.val_metrics = [_clone_metric(m) for m in self.train_metrics]
        self.train_loss_metrics = [LossMetric(name="loss")]
        self.val_loss_metrics = [LossMetric(name="validation loss")]
        self.logger = logging.getLogger("Estimator")

    # ---- argument checking (MXNet's :101-:189) --------------------------
    @staticmethod
    def _check_loss(loss):
        if isinstance(loss, gluon_loss.Loss):
            return loss
        raise ValueError("loss must be a gluon Loss instance")

    @staticmethod
    def _check_metrics(metrics):
        if metrics is None:
            return [Accuracy()]
        if isinstance(metrics, EvalMetric):
            return [metrics]
        metrics = list(metrics)
        if not all(isinstance(m, EvalMetric) for m in metrics):
            raise ValueError("metrics must be EvalMetric instances")
        return metrics

    @staticmethod
    def _check_context(context):
        if context is None:
            return [current_context()]
        if isinstance(context, (list, tuple)):
            return list(context)
        return [context]

    def _initialize(self, initializer):
        params = self.net.collect_params()
        uninitialized = any(p._tensors is None and not p._deferred_init
                            for p in params.values())
        if uninitialized:
            self.net.initialize(init=initializer, ctx=self.context)

    # ---- evaluation (MXNet's :191-:244) ---------------------------------
    def evaluate_batch(self, val_batch, batch_axis=0):
        data, label = val_batch[0], val_batch[1]
        pred = self.net(data)
        loss = self.loss(pred, label)
        return data, label, pred, loss

    def evaluate(self, val_data, batch_axis=0, event_handlers=None):
        for metric in self.val_metrics + self.val_loss_metrics:
            metric.reset()
        for batch in val_data:
            _, label, pred, loss = self.evaluate_batch(batch, batch_axis)
            for metric in self.val_metrics:
                metric.update(label, pred)
            for metric in self.val_loss_metrics:
                metric.update(0, loss)

    # ---- training (MXNet's :246-:358) -----------------------------------
    def fit_batch(self, train_batch, batch_axis=0):
        data, label = train_batch[0], train_batch[1]
        batch_size = data.shape[batch_axis]
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        loss.backward()
        self.trainer.step(batch_size)
        return data, label, pred, loss

    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers=None, batches=None, batch_axis=0):
        if not isinstance(train_data, DataLoader):
            raise ValueError(
                "Estimator only supports gluon DataLoader input; wrap your "
                "arrays/DataIter in gluon.data.DataLoader")
        if (not epochs) == (not batches):
            raise ValueError("specify exactly one of epochs or batches")
        self.max_epoch = epochs
        self.max_batch = batches
        self.stop_training = False

        event_handlers = self._prepare_default_handlers(
            val_data, event_handlers)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize_handlers(event_handlers)

        for handler in train_begin:
            handler.train_begin(self)

        while not self.stop_training:
            for handler in epoch_begin:
                handler.epoch_begin(self)
            for batch in train_data:
                for handler in batch_begin:
                    handler.batch_begin(self, batch=batch)
                _, label, pred, loss = self.fit_batch(batch, batch_axis)
                for handler in batch_end:
                    handler.batch_end(self, batch=batch, label=label,
                                      pred=pred, loss=loss)
                if self.stop_training:
                    break
            for handler in epoch_end:
                handler.epoch_end(self)

        for handler in train_end:
            handler.train_end(self)
        return self

    # ---- handler plumbing (MXNet's :360-:447) ---------------------------
    def _prepare_default_handlers(self, val_data, event_handlers):
        event_handlers = list(event_handlers or [])
        added = []
        if not any(isinstance(h, StoppingHandler) for h in event_handlers):
            event_handlers.append(StoppingHandler(self.max_epoch,
                                                  self.max_batch))
        if not any(isinstance(h, MetricHandler) for h in event_handlers):
            event_handlers.append(MetricHandler(
                self.train_metrics + self.train_loss_metrics))
            added.append("MetricHandler")
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler)
                        for h in event_handlers):
            event_handlers.append(ValidationHandler(val_data,
                                                    self.evaluate))
            added.append("ValidationHandler")
        if not any(isinstance(h, LoggingHandler) for h in event_handlers):
            metrics = self.train_metrics + self.train_loss_metrics
            if val_data is not None:
                metrics = metrics + self.val_metrics + self.val_loss_metrics
            event_handlers.append(LoggingHandler(metrics=metrics))
            added.append("LoggingHandler")
        if added:
            self.logger.info("default handlers added: %s",
                             ", ".join(added))
        event_handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return event_handlers

    @staticmethod
    def _categorize_handlers(event_handlers):
        train_begin, epoch_begin, batch_begin = [], [], []
        batch_end, epoch_end, train_end = [], [], []
        for h in event_handlers:
            if isinstance(h, TrainBegin):
                train_begin.append(h)
            if isinstance(h, EpochBegin):
                epoch_begin.append(h)
            if isinstance(h, BatchBegin):
                batch_begin.append(h)
            if isinstance(h, BatchEnd):
                batch_end.append(h)
            if isinstance(h, EpochEnd):
                epoch_end.append(h)
            if isinstance(h, TrainEnd):
                train_end.append(h)
        return (train_begin, epoch_begin, batch_begin, batch_end,
                epoch_end, train_end)


def _clone_metric(metric):
    import copy
    return copy.deepcopy(metric)
