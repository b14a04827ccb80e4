"""Losses: counterpart of ``mxnet_tpu/gluon/loss.py`` (``Loss``,
``_apply_weighting`` and ``SoftmaxCrossEntropyLoss``, the loss the
transformer LM trains with), as ``nn.Module``s.

A loss returns one value per sample: the mean over every axis but
``batch_axis``.
"""
from __future__ import annotations

from torch import nn

from ..ops import nn as _ops

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss * sample_weight * weight`` (reference ``loss.py:21``)."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise TypeError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


class Loss(nn.Module):
    """Base loss: a scalar ``weight`` and the ``batch_axis`` kept by the
    mean."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis={}, w={}".format(self._batch_axis, self._weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy against integer labels (``sparse_label``).

    ``-log_softmax(pred)[label]`` along ``axis``, op for op as the
    reference and in ``pred``'s dtype (bf16 logits give a bf16 loss);
    ``from_logits`` takes ``pred`` as log-probabilities already. A label
    below 0 is ignored: it contributes 0, as in the reference."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        if not sparse_label:
            raise NotImplementedError(
                "SoftmaxCrossEntropyLoss: only sparse_label=True is ported")
        self._axis = axis
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        valid = label >= 0
        idx = label.clamp_min(0).long().unsqueeze(self._axis)
        loss = -pred.gather(self._axis, idx)
        loss = loss * valid.to(loss.dtype).reshape(loss.shape)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
