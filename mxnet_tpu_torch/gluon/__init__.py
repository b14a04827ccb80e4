"""Gluon-style layers as ``nn.Module``s (counterpart of ``mxnet_tpu.gluon``)."""
from . import nn

__all__ = ["nn"]
