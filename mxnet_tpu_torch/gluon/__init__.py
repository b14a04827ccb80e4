"""Gluon (counterpart of ``mxnet_tpu.gluon``): ``Block`` and
``HybridBlock`` (``torch.nn.Module``s), the layers and losses, the model
zoo, parameters under the reference's names, the eager ``Trainer``, the
utilities and ``data``."""
from . import block, loss, model_zoo, nn, parameter, trainer, utils
from . import data
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict, collect_params)
from .trainer import Trainer

__all__ = ["block", "data", "loss", "model_zoo", "nn", "parameter", "trainer",
           "utils", "Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "collect_params", "Trainer"]
