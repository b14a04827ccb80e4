"""Gluon (counterpart of ``mxnet_tpu.gluon``): layers and losses as
``nn.Module``s, parameters under the reference's names, the eager
``Trainer`` and the utilities."""
from . import loss, nn, parameter, trainer, utils
from .parameter import Parameter, ParameterDict, collect_params
from .trainer import Trainer

__all__ = ["loss", "nn", "parameter", "trainer", "utils", "Parameter",
           "ParameterDict", "collect_params", "Trainer"]
