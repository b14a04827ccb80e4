"""Gluon (counterpart of ``mxnet_tpu.gluon``): ``Block``,
``HybridBlock`` (``torch.nn.Module``s) and ``SymbolBlock``, the layers and losses, the
recurrent cells and layers (``rnn``), the model zoo, parameters under the
reference's names, the eager ``Trainer``, the utilities, ``data`` and
``contrib`` (its layers, cells and the ``Estimator``)."""
from . import block, loss, model_zoo, nn, parameter, rnn, trainer, utils
from . import data
from . import contrib
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict, collect_params)
from .trainer import Trainer

__all__ = ["block", "contrib", "data", "loss", "model_zoo", "nn", "parameter",
           "rnn", "trainer",
           "utils", "Block", "HybridBlock", "SymbolBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "collect_params", "Trainer"]
