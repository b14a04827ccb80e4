"""Activation blocks: counterparts of
``mxnet_tpu/gluon/nn/activations.py`` (``Activation`` lives in
``basic_layers``), each a ``HybridBlock`` over the ``LeakyReLU`` op of the
port or a sigmoid."""
from __future__ import annotations

from ... import initializer as init_mod
from ...ops import nn as _ops
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, prefix=None, params=None):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be >= 0."
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def _sym_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of shape ``(1,)``
    (``Constant(0.25)`` by default)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer is None:
            alpha_initializer = init_mod.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def forward(self, x):
        self._ready(x)
        return _ops.LeakyReLU(x, self._parameters["alpha"], act_type="prelu")

    def _sym_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` where not positive."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops.LeakyReLU(x, act_type="elu", slope=self._alpha)

    def _sym_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU with the SELU constants."""

    def forward(self, x):
        return _ops.LeakyReLU(x, act_type="selu")

    def _sym_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * _ops.sigmoid(_ops._const(self._beta, x) * x)

    def _sym_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """The exact (erf) GELU."""

    def forward(self, x):
        return _ops.LeakyReLU(x, act_type="gelu")

    def _sym_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
