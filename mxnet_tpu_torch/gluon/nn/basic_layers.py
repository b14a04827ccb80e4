"""Basic layers: ``Dense``, ``Embedding``, ``LayerNorm``.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``, as ``nn.Module``s.
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

__all__ = ["Dense", "Embedding", "LayerNorm"]


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def _xavier_(w):
    """Gluon's ``Xavier()`` default: uniform, average fan, magnitude 3."""
    fan_out, fan_in = w.shape[0], w.shape[1]
    bound = (3.0 / ((fan_in + fan_out) / 2.0)) ** 0.5
    with torch.no_grad():
        w.uniform_(-bound, bound)


class Dense(nn.Module):
    """Fully-connected layer: ``weight (units, in_units)``, optional
    ``bias (units,)``. With ``flatten`` the input is flattened to
    ``(batch, -1)``; without, the last axis is contracted."""

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


class Embedding(nn.Module):
    """Embedding lookup: ``weight (input_dim, output_dim)``; integer ids
    of any integer dtype."""

    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self.weight = _param((input_dim, output_dim), device, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        _xavier_(self.weight)

    def forward(self, x):
        return nn.functional.embedding(x.long(), self.weight)


class LayerNorm(nn.Module):
    """Layer norm over ``axis`` with ``gamma``/``beta`` of
    ``(in_channels,)``, eps 1e-5."""

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
