"""The legacy loss layers: counterpart of ``mxnet_tpu/ops/loss_ops.py``.

``LinearRegressionOutput``, ``MAERegressionOutput`` and
``LogisticRegressionOutput`` pass their data forward (the logistic one
through a sigmoid) and ignore the gradient that reaches them: their
backward is the loss's own, ``out - label`` (``sign(out - label)`` for
MAE) times ``grad_scale / num_output``, where ``num_output`` is the
product of the output's non-batch dims. The label takes no gradient.
``SoftmaxOutput`` (the same kind of layer) is in :mod:`.nn`.

``IdentityAttachKLSparseReg`` is the identity, as the reference's.
``ROIPooling`` max-pools each ROI (``rois (R, 5)`` rows ``[batch, x1, y1,
x2, y2]``, corners rounded half to even after ``spatial_scale``) into a
``pooled_size`` grid of MXNet's integer bins; an empty bin gives 0. The
rectangle's max is taken over its columns, then its rows, for a block of
ROIs at a time.
"""
from __future__ import annotations

import torch

from . import _jnp
from .registry import register

__all__ = ["LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput", "IdentityAttachKLSparseReg",
           "ROIPooling"]


def _regression_output(name, transform, grad_fn):
    class _Output(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = transform(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, grad):
            out, label = ctx.saved_tensors
            num_output = 1
            for d in out.shape[1:]:
                num_output *= d
            g = grad_fn(out, label.reshape(out.shape).to(out.dtype)) * (
                ctx.grad_scale / num_output)
            return g.to(out.dtype), None, None

    def op(data, label, grad_scale=1.0):
        return _Output.apply(data, label, float(grad_scale))

    op.__name__ = name
    op.__doc__ = "The reference's ``%s`` (see the module's text)." % name
    return op


LinearRegressionOutput = _regression_output(
    "LinearRegressionOutput", lambda x: x, lambda out, label: out - label)
MAERegressionOutput = _regression_output(
    "MAERegressionOutput", lambda x: x,
    lambda out, label: torch.sign(out - label))
LogisticRegressionOutput = _regression_output(
    "LogisticRegressionOutput", torch.sigmoid, lambda out, label: out - label)

register("LinearRegressionOutput",
         aliases=("linear_regression_output",))(LinearRegressionOutput)
register("MAERegressionOutput",
         aliases=("mae_regression_output",))(MAERegressionOutput)
register("LogisticRegressionOutput",
         aliases=("logistic_regression_output",))(LogisticRegressionOutput)


@register("IdentityAttachKLSparseReg")
def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    return data.clone()


ROI_BLOCK = 1 << 27           # masked values a block of ROIs may hold


def _bins(start, size, n_bins, length, device):
    """``(R, n_bins, length)``: which positions fall in each bin."""
    i = torch.arange(n_bins, device=device)
    lo = start[:, None] + torch.div(i * size[:, None], n_bins,
                                    rounding_mode="floor")
    hi = start[:, None] + torch.div((i + 1) * size[:, None] + n_bins - 1,
                                    n_bins, rounding_mode="floor")
    pos = torch.arange(length, device=device)
    return (pos >= lo[..., None]) & (pos < hi[..., None])


@register("ROIPooling", aliases=("_npx_roi_pooling",))
def ROIPooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """``data (N, C, H, W)`` -> ``(R, C, ph, pw)``."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    dev = data.device
    b = _jnp.clip_index(_jnp.astype(rois[:, 0], torch.int32), N)
    x1, y1, x2, y2 = (_jnp.astype(torch.round(rois[:, i] * spatial_scale),
                                  torch.int32).long() for i in range(1, 5))
    rows = _bins(y1, torch.clamp_min(y2 - y1 + 1, 1), ph, H, dev)
    cols = _bins(x1, torch.clamp_min(x2 - x1 + 1, 1), pw, W, dev)
    ninf = torch.full((), float("-inf"), dtype=data.dtype, device=dev)
    out = []
    step = max(1, ROI_BLOCK // max(1, C * H * W * max(ph, pw)))
    for s in range(0, rois.shape[0], step):
        img = data[b[s:s + step]]                       # (r, C, H, W)
        m1 = torch.where(cols[s:s + step, None, None], img[:, :, :, None],
                         ninf).amax(-1)                 # (r, C, H, pw)
        m2 = torch.where(rows[s:s + step, None, :, :, None],
                         m1[:, :, None], ninf).amax(3)  # (r, C, ph, pw)
        out.append(torch.where(torch.isfinite(m2), m2,
                               torch.zeros((), dtype=m2.dtype, device=dev)))
    return torch.cat(out) if out else torch.zeros((0, C, ph, pw),
                                                  dtype=data.dtype,
                                                  device=dev)
