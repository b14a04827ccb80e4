"""Basic layers: ``Dense``, ``Dropout``, ``Embedding``, ``LayerNorm``.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``, as
``HybridBlock``s (so ``nn.Module``s) whose ``forward`` takes tensors; a
call with NDArrays goes through ``gluon.Block.__call__``.
Parameters keep Gluon's leaf names and shapes (``weight`` ``(out, in)``,
``bias``, ``gamma``, ``beta``), so a state dict maps one to one onto the
reference's ``collect_params()`` (see ``mxnet_tpu_torch/convert.py``).
Shapes are given at construction (no deferred inference). Every layer takes
an explicit ``device`` (:func:`~mxnet_tpu_torch.context.default_device`)
and ``dtype``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...context import default_device
from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm"]


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def _xavier_(w):
    """Gluon's ``Xavier()`` default: uniform, average fan, magnitude 3."""
    fan_out, fan_in = w.shape[0], w.shape[1]
    bound = (3.0 / ((fan_in + fan_out) / 2.0)) ** 0.5
    with torch.no_grad():
        w.uniform_(-bound, bound)


class Dense(HybridBlock):
    """Fully-connected layer: ``weight (units, in_units)``, optional
    ``bias (units,)``. With ``flatten`` the input is flattened to
    ``(batch, -1)``; without, the last axis is contracted."""

    # the reference layer's init default of each parameter (read by
    # gluon.parameter.collect_params)
    _param_init = {"weight": None, "bias": "zeros"}

    def __init__(self, units, in_units, use_bias=True, flatten=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self._flatten = flatten
        self.weight = _param((units, in_units), device, dtype)
        self.bias = _param((units,), device, dtype) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self):
        _xavier_(self.weight)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return _ops.FullyConnected(x, self.weight, self.bias,
                                   flatten=self._flatten)


class Dropout(HybridBlock):
    """Dropout of ``rate`` (mask size 1 on ``axes``): in training mode the
    lowbias32 ``Dropout`` op with a fresh key from
    :func:`~mxnet_tpu_torch.random.next_key`; the identity otherwise."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return _ops.Dropout(x, p=self._rate, axes=self._axes,
                            train=self.training)

    def extra_repr(self):
        return "p = {}, axes={}".format(self._rate, self._axes)


# tables of at most this many rows take their weight gradient as a one-hot
# product (see _Lookup)
_ONE_HOT_ROWS = 1024


class _Lookup(torch.autograd.Function):
    """``weight[ids]`` with a weight gradient that is bitwise repeatable.

    ``F.embedding``'s CUDA backward is not where one id repeats many times:
    BERT's two segment rows take 4096 gradient rows each at batch 64,
    sequence 128, and their sums differed between two runs in the last
    bits. Here a table of at most ``_ONE_HOT_ROWS`` rows takes the product
    of the ids' one-hot matrix with the gradient (one matmul, float32
    accumulation); a larger one an ``index_put_`` accumulation in float32,
    which sorts the ids and adds each id's rows in their order."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        ids = ids.reshape(-1)
        grad = grad.reshape(ids.numel(), -1)
        if ctx.rows <= _ONE_HOT_ROWS:
            hot = nn.functional.one_hot(ids, ctx.rows).to(grad.dtype)
            return None, hot.t() @ grad
        acc = grad.new_zeros((ctx.rows, grad.shape[1]), dtype=torch.float32)
        acc.index_put_((ids,), grad.float(), accumulate=True)
        return None, acc.to(grad.dtype)


class Embedding(HybridBlock):
    """Embedding lookup: ``weight (input_dim, output_dim)``; integer ids
    of any integer dtype. The weight gradient is the same, bit for bit,
    in every run (:class:`_Lookup`)."""

    _param_init = {"weight": None}

    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.weight = _param((input_dim, output_dim), device, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        _xavier_(self.weight)

    def forward(self, x):
        return _Lookup.apply(x.long(), self.weight)


class LayerNorm(HybridBlock):
    """Layer norm over ``axis`` with ``gamma``/``beta`` of
    ``(in_channels,)``, eps 1e-5."""

    _param_init = {"gamma": "ones", "beta": "zeros"}

    def __init__(self, in_channels, axis=-1, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = _param((in_channels,), device, dtype)
        self.beta = _param((in_channels,), device, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return _ops.LayerNorm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)
