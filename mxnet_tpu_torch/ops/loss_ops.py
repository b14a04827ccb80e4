"""The legacy loss layers: counterpart of ``mxnet_tpu/ops/loss_ops.py``.

``LinearRegressionOutput``, ``MAERegressionOutput`` and
``LogisticRegressionOutput`` pass their data forward (the logistic one
through a sigmoid) and ignore the gradient that reaches them: their
backward is the loss's own, ``out - label`` (``sign(out - label)`` for
MAE) times ``grad_scale / num_output``, where ``num_output`` is the
product of the output's non-batch dims. The label takes no gradient.
``SoftmaxOutput`` (the same kind of layer) is in :mod:`.nn`.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput"]


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
