"""Evaluation metrics: counterpart of ``mxnet_tpu/metric.py``.

Host numpy, as in the reference: the ``EvalMetric`` registry (``create``,
``register``), ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``Loss`` (with its ``Torch`` and ``Caffe`` names), ``CustomMetric`` and
``np``. Predictions and labels may be the port's ``NDArray``s, torch
tensors on any device (bfloat16 and float16 read as float32) or numpy
arrays; each is copied to the host once per update.
"""
from __future__ import annotations

import math

import numpy
import torch

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _METRIC_REGISTRY[n] = klass
    return klass


def create(metric, *args, **kwargs):
    """reference `metric.py` create."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        klass = _METRIC_REGISTRY.get(metric.lower())
        if klass is None:
            raise ValueError("unknown metric %r (have %s)"
                             % (metric, sorted(_METRIC_REGISTRY)))
        return klass(*args, **kwargs)
    raise TypeError("metric must be str, callable, EvalMetric, or list")


def _as_numpy(x):
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return numpy.asarray(x)


def _is_array(x):
    return isinstance(x, (NDArray, torch.Tensor))


class EvalMetric:
    """Base metric (MXNet's metric.py:46)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """MXNet's metric.py:31."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))
    if wrap:
        if _is_array(labels):
            labels = [labels]
        if _is_array(preds):
            preds = [preds]
    return labels, preds


class CompositeEvalMetric(EvalMetric):
    """MXNet's metric.py:244."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}"
                              .format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def reset_local(self):
        try:
            for metric in self.metrics:
                metric.reset_local()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_global(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get_global()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    """MXNet's metric.py:377."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_label = _as_numpy(pred_label)
            label = _as_numpy(label)
            if pred_label.ndim > label.ndim:
                pred_label = pred_label.argmax(self.axis)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            correct = (pred_label == label).sum()
            self._update(float(correct), len(pred_label))


@register
class TopKAccuracy(EvalMetric):
    """MXNet's metric.py:443."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pred = _as_numpy(pred_label).astype("float32")
            pred_label = numpy.argpartition(pred, -self.top_k)
            label = _as_numpy(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self._update(float((pred_label.ravel() == label.ravel()).sum()),
                             num_samples)
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                correct = 0.0
                for j in range(top_k):
                    correct += float((
                        pred_label[:, num_classes - 1 - j].ravel() ==
                        label.ravel()).sum())
                self._update(correct, num_samples)


class _BinaryClassificationMetrics:
    """MXNet's metric.py:533 — TP/FP/TN/FN accumulators."""

    def __init__(self):
        self.true_positives = 0
        self.false_negatives = 0
        self.false_positives = 0
        self.true_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype("int32")
        pred_label = numpy.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if len(numpy.unique(label)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        pred_true = (pred_label == 1)
        pred_false = 1 - pred_true
        label_true = (label == 1)
        label_false = 1 - label_true
        self.true_positives += (pred_true * label_true).sum()
        self.false_positives += (pred_true * label_false).sum()
        self.false_negatives += (pred_false * label_true).sum()
        self.true_negatives += (pred_false * label_false).sum()

    @property
    def precision(self):
        if self.true_positives + self.false_positives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_positives)
        return 0.0

    @property
    def recall(self):
        if self.true_positives + self.false_negatives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_negatives)
        return 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (
                self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [(true_pos + false_pos), (true_pos + false_neg),
                 (true_neg + false_pos), (true_neg + false_neg)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg) - (false_pos * false_neg)) / \
            math.sqrt(denom)

    @property
    def total_examples(self):
        return self.false_negatives + self.false_positives + \
            self.true_negatives + self.true_positives

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    """MXNet's metric.py:625."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (MXNet's metric.py:714)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = self._metrics.matthewscc * \
                self._metrics.total_examples
            self.num_inst = self._metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0.0
        self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """MXNet's metric.py:826."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.global_sum_metric /
                                    self.global_num_inst))


@register
class MAE(EvalMetric):
    """MXNet's metric.py:924."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(numpy.abs(label - pred).mean(), 1)


@register
class MSE(EvalMetric):
    """MXNet's metric.py:976."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(((label - pred) ** 2.0).mean(), 1)


@register
class RMSE(EvalMetric):
    """MXNet's metric.py:1028."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(numpy.sqrt(((label - pred) ** 2.0).mean()), 1)


@register
class CrossEntropy(EvalMetric):
    """MXNet's metric.py:1080."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            cross_entropy = (-numpy.log(prob + self.eps)).sum()
            self._update(cross_entropy, label.shape[0])


@register
class NegativeLogLikelihood(EvalMetric):
    """MXNet's metric.py:1144."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, \
                (label.shape[0], num_examples)
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64),
                        numpy.int64(label)]
            nll = (-numpy.log(prob + self.eps)).sum()
            self._update(nll, num_examples)


@register
class PearsonCorrelation(EvalMetric):
    """MXNet's metric.py:1207."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            label = _as_numpy(label).ravel().astype("float64")
            pred = _as_numpy(pred).ravel().astype("float64")
            self._update(numpy.corrcoef(pred, label)[0, 1], 1)


@register
class Loss(EvalMetric):
    """Mean of the raw loss outputs (MXNet's metric.py:1278)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if _is_array(preds):
            preds = [preds]
        for pred in preds:
            pred = _as_numpy(pred)
            self._update(float(pred.sum()), pred.size)


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """MXNet's metric.py:1334."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self._update(sum_metric, num_inst)
            else:
                self._update(reval, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (MXNet's metric.py:1407)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


register(Accuracy, "acc", "accuracy")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(CrossEntropy, "ce", "cross-entropy")
register(NegativeLogLikelihood, "nll_loss", "nll-loss")
register(PearsonCorrelation, "pearsonr")
