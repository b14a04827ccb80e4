"""Estimator event handlers: counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``.

The six event mixins and the stock handlers: ``StoppingHandler``,
``MetricHandler``, ``ValidationHandler``, ``LoggingHandler``,
``CheckpointHandler`` (``save_parameters`` files, the reference's bytes
and structural names) and ``EarlyStoppingHandler``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch epochs or max_batch batches (MXNet's :82)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.max_epoch = estimator.max_epoch
        self.max_batch = estimator.max_batch
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch == self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch == self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset metrics at epoch begin, update with batch results
    (MXNet's :122)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = list(metrics or [])
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for metric in self.metrics:
            if _is_loss_metric(metric):
                metric.update(0, loss)
            else:
                metric.update(label, pred)


def _is_loss_metric(metric):
    from ....metric import Loss
    return isinstance(metric, Loss)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every N epochs/batches (MXNet's :157)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Periodic training log lines (MXNet's :223)."""

    LOG_PER_EPOCH = 1
    LOG_PER_BATCH = 2

    def __init__(self, log_interval="epoch", metrics=None, priority=np.inf):
        self.logger = logging.getLogger(__name__)
        self.log_interval = log_interval
        self.metrics = list(metrics or [])
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin: epochs=%s", estimator.max_epoch)

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Train finished in %.3fs: %s",
                         time.time() - self.train_start,
                         _fmt_metrics(self.metrics))

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.logger.info("[Epoch %d] finished in %.3fs: %s",
                         self.current_epoch,
                         time.time() - self.epoch_start,
                         _fmt_metrics(self.metrics))
        self.current_epoch += 1

    def batch_begin(self, estimator, *args, **kwargs):
        if self.log_interval != "epoch":
            self.batch_start = time.time()

    def batch_end(self, estimator, *args, **kwargs):
        if self.log_interval != "epoch" and \
                self.batch_index % self.log_interval == 0:
            self.logger.info("[Epoch %d][Batch %d] %s",
                             self.current_epoch, self.batch_index,
                             _fmt_metrics(self.metrics))
        self.batch_index += 1


def _fmt_metrics(metrics):
    out = []
    for m in metrics:
        name, val = m.get()
        if isinstance(name, (list, tuple)):
            out.extend("%s: %.4f" % (n, v) for n, v in zip(name, val))
        else:
            out.append("%s: %.4f" % (name, val))
    return ", ".join(out)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save params (+ trainer states) periodically and keep the best model
    by a monitored metric (MXNet's :358)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.saved_checkpoints = []
        self.current_epoch = 0
        self.current_batch = 0
        if mode == "auto" and monitor is not None:
            name = monitor.get()[0]
            mode = "min" if "loss" in str(name).lower() or \
                "error" in str(name).lower() else "max"
        self.mode = mode
        self.best = np.inf if mode == "min" else -np.inf

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        self.current_epoch = 0
        self.current_batch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self._save(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self._save(estimator)

    def _save(self, estimator):
        path = os.path.join(self.model_dir, "%s-epoch%d.params"
                            % (self.model_prefix, self.current_epoch))
        estimator.net.save_parameters(path)
        self.saved_checkpoints.append(path)
        while len(self.saved_checkpoints) > self.max_checkpoints:
            old = self.saved_checkpoints.pop(0)
            if os.path.exists(old):
                os.remove(old)
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            improved = val < self.best if self.mode == "min" \
                else val > self.best
            if improved:
                self.best = val
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, "%s-best.params" % self.model_prefix))


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop training when a monitored metric stops improving
    (MXNet's :633)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if mode == "auto":
            name = monitor.get()[0]
            mode = "min" if "loss" in str(name).lower() or \
                "error" in str(name).lower() else "max"
        self.mode = mode
        if self.mode == "min":
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
        else:
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.best = self.baseline if self.baseline is not None else \
            (np.inf if self.mode == "min" else -np.inf)

    def epoch_end(self, estimator, *args, **kwargs):
        _, current = self.monitor.get()
        if current is None or (isinstance(current, float) and
                               np.isnan(current)):
            self.current_epoch += 1
            return
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            logging.getLogger(__name__).info(
                "Epoch %d: early stopping (%s did not improve)",
                self.stopped_epoch, self.monitor.get()[0])
