"""Losses: counterpart of ``mxnet_tpu/gluon/loss.py``, as ``HybridBlock``s
(``nn.Module``s whose forward takes tensors; a call with NDArrays returns
an NDArray, see ``gluon.block``).

``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss`` (``from_sigmoid``
and ``pos_weight``), ``SoftmaxCrossEntropyLoss`` (sparse or dense labels),
``KLDivLoss``, ``CTCLoss`` (:mod:`mxnet_tpu_torch.ops.ctc`), ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss`` (signed or binary
labels), ``TripletLoss``, ``PoissonNLLLoss``, ``CosineEmbeddingLoss`` and
``SDMLLoss``.

Each takes the reference's arithmetic op for op, in its input's dtype
(bf16 logits give a bf16 loss), and returns one value per sample: the mean
over every axis but ``batch_axis`` (``PoissonNLLLoss``: the mean over
everything; ``TripletLoss`` and ``CTCLoss``: their own reductions, as in
the reference).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import ctc as _ctc
from ..ops import nn as _ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


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


def _softrelu(x):
    """``log(1 + exp(x))`` (the reference's ``softrelu``, ``softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Loss(HybridBlock):
    """Base loss: a scalar ``weight`` and the ``batch_axis`` kept by the
    mean."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis={}, w={}".format(self._batch_axis, self._weight)


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2``."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of ``pred`` itself with
    ``from_sigmoid``); ``pos_weight`` weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * \
                    (_softrelu(-torch.abs(pred)) + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label +
                         torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight +
                         torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy along ``axis``.

    ``sparse_label``: ``-log_softmax(pred)[label]``; a label below 0 is
    ignored (it contributes 0), as in the reference; a NaN or infinite
    label gives a NaN loss (the ``nan`` chaos kind poisons an integer
    token stream's labels so). Otherwise ``label``
    is a distribution of ``pred``'s shape: ``-sum(log_softmax(pred) *
    label)``. ``log_softmax`` is taken op for op as the reference
    (``ops.nn.log_softmax``); ``from_logits`` takes ``pred`` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            valid = label >= 0
            # a non-finite label (a poisoned batch) indexes class 0 and
            # gives a NaN loss, as its garbage deserves, where a cast of
            # NaN to an index would read out of bounds
            finite = torch.isfinite(label)
            idx = torch.where(valid & finite, label, torch.zeros_like(label))
            loss = -pred.gather(self._axis, idx.long().unsqueeze(self._axis))
            loss = loss * valid.to(loss.dtype).reshape(loss.shape)
            if label.is_floating_point():
                loss = torch.where(finite.reshape(loss.shape), loss,
                                   torch.full_like(loss, float("nan")))
        else:
            label = label.reshape(pred.shape)
            loss = -torch.sum(pred * label, dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``; ``pred`` is
    log-probabilities unless ``from_logits`` is False."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification; the last class is blank.
    ``layout`` ``"NTC"`` or ``"TNC"`` for ``pred``, ``label_layout``
    ``"NT"`` or ``"TN"`` for the labels. Returns ``(B,)`` float32."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC"):
            raise ValueError("layout must be NTC or TNC, got %r" % layout)
        if label_layout not in ("NT", "TN"):
            raise ValueError("label_layout must be NT or TN, got %r"
                             % label_layout)
        super().__init__(weight, label_layout.find("N"))
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _ctc.ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smooth L1: ``|d| - rho/2`` above ``rho``, ``d^2 / (2 rho)`` below."""

    def __init__(self, rho=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.abs(label - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for labels in {-1, 1}
    (``"signed"``) or {0, 1} (``"binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format must be signed or binary, got %s"
                             % label_format)

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        axes = tuple(i for i in range(pred.dim()) if i != self._batch_axis)
        loss = torch.sum(torch.square(positive - pred)
                         - torch.square(negative - pred), dim=axes)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, the mean over every element
    (``compute_full`` adds Stirling's term where the target is above 1)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling_factor = target * torch.log(target + 1e-12) - target \
                + 0.5 * torch.log(2 * target * np.pi + 1e-12)
            stirling_factor = stirling_factor * (target > 1)
            loss = loss + stirling_factor
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return torch.mean(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(x1, x2)`` where ``label == 1``, else ``max(0, cos -
    margin)``."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos_sim = self._cosine_similarity(input1, input2)
        label = label.reshape((-1, 1))
        loss = torch.where(label == 1, 1 - cos_sim,
                           F.relu(cos_sim - self._margin))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)

    @staticmethod
    def _cosine_similarity(x, y, axis=-1):
        x_norm = torch.sqrt(torch.sum(torch.square(x), dim=axis)) \
            .reshape((-1, 1))
        y_norm = torch.sqrt(torch.sum(torch.square(y), dim=axis)) \
            .reshape((-1, 1))
        x_dot_y = torch.sum(x * y, dim=axis).reshape((-1, 1))
        return x_dot_y / torch.clamp_min(x_norm * y_norm, 1e-12)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: for paired batches ``x1``, ``x2``,
    KL divergence between the softmax of the negative squared distances
    and smoothed identity labels, times the batch size."""

    def __init__(self, smoothing_parameter=0.3, weight=1., batch_axis=0):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    @staticmethod
    def _compute_distances(x1, x2):
        return torch.sum(torch.square(x1[:, None, :] - x2[None, :, :]),
                         dim=2)

    def _compute_labels(self, batch_size, device):
        gold = np.eye(batch_size)
        labels = gold * (1 - self.smoothing_parameter) + \
            (1 - gold) * self.smoothing_parameter / (batch_size - 1)
        return torch.from_numpy(labels.astype("float32")).to(device)

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        labels = self._compute_labels(batch_size, x1.device)
        distances = self._compute_distances(x1, x2)
        log_probabilities = _ops.log_softmax(-distances, axis=1)
        return self.kl_loss(log_probabilities, labels) * batch_size

