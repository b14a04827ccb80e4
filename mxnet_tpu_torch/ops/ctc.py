"""CTC loss: counterpart of ``mxnet_tpu/ops/ctc.py``.

The forward algorithm in log space over the extended label sequence
``[blank, l1, blank, l2, ..., blank]``, as in the reference: the same
alpha recursion, the same masks, with the LAST class as blank. Label
padding may be any value when ``label_lengths`` is given; otherwise labels
below 0 mark padding. The reference runs the recursion as one XLA loop
(``lax.scan``); here it is a plain loop over time of batched torch ops,
and the gradient comes from autograd through it. The registry op
``_ctc_loss`` (``ctc_loss``, ``CTCLoss``, ``CTCLoss_op``,
``_contrib_ctc_loss``, ``_contrib_CTCLoss``) takes the reference's
``(data, label, data_lengths, label_lengths)`` and, as the reference,
uses the lengths it is given whatever ``use_*_lengths`` say.
"""
from __future__ import annotations

import torch

from . import nn as _ops
from .registry import register

__all__ = ["ctc_loss"]

NEG_INF = -1e30


def ctc_loss(pred, labels, pred_lengths=None, label_lengths=None):
    """``pred``: ``(T, B, C)`` unnormalized activations; ``labels``:
    ``(B, L)`` integers. Returns the per-example negative log likelihood,
    shape ``(B,)``, in float32."""
    T, B, C = pred.shape
    L = labels.shape[1]
    S = 2 * L + 1
    blank = C - 1
    dev = pred.device

    logp = _ops.log_softmax(pred.to(torch.float32), axis=-1)
    labels = labels.to(torch.int64)
    if pred_lengths is None:
        pred_lengths = torch.full((B,), T, dtype=torch.int64, device=dev)
    else:
        pred_lengths = pred_lengths.to(device=dev, dtype=torch.int64)
    if label_lengths is None:
        label_lengths = (labels >= 0).to(torch.int64).sum(dim=1)
    else:
        label_lengths = label_lengths.to(device=dev, dtype=torch.int64)

    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = torch.where(labels < 0, torch.full_like(labels, blank),
                               labels)
    # a skip from s - 2 to s: where ext[s] is no blank and differs from
    # ext[s - 2]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    valid = torch.arange(S, device=dev)[None, :] < \
        (2 * label_lengths + 1)[:, None]
    neg = torch.full((B, S), NEG_INF, dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)

    alpha = neg.clone()
    alpha[:, 0] = logp[0, rows, blank]
    alpha[:, 1] = torch.where(label_lengths > 0, logp[0, rows, ext[:, 1]],
                              neg[:, 1])
    alpha = torch.where(valid, alpha, neg)
    pad1, pad2 = neg[:, :1], neg[:, :2]
    for t in range(1, T):
        a_m1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_m2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        a_m2 = torch.where(can_skip, a_m2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, a_m1), a_m2)
        new = merged + torch.gather(logp[t], 1, ext)
        new = torch.where(valid, new, neg)
        # frozen past pred_lengths: alpha carried unchanged
        alpha = torch.where((t < pred_lengths)[:, None], new, alpha)

    sl = 2 * label_lengths                  # the final blank
    last_blank = alpha[rows, sl]
    last_label = torch.where(label_lengths > 0,
                             alpha[rows, torch.clamp(sl - 1, min=0)],
                             neg[:, 0])
    return -torch.logaddexp(last_blank, last_label)


@register("_ctc_loss", aliases=("ctc_loss", "CTCLoss_op", "_contrib_ctc_loss",
                                "CTCLoss", "_contrib_CTCLoss"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="last"):
    """``data`` ``(T, B, C)``: see the module's text."""
    return ctc_loss(data, label, data_lengths, label_lengths)
