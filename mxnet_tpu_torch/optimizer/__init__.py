"""Optimizers (counterpart of ``mxnet_tpu.optimizer``): the pure update
rules, the ``Optimizer`` classes, ``create`` and ``Updater``."""
from . import optimizer
from .optimizer import (DCASGD, FTML, LAMB, LARS, LBSGD, NAG, SGD, SGLD,
                        AdaDelta, AdaGrad, Adam, Adamax, Ftrl, Nadam,
                        Optimizer, RMSProp, Signum, Test, Updater, create,
                        get_updater, register)

__all__ = ["optimizer", "Optimizer", "register", "create", "SGD", "Signum",
           "FTML", "LARS", "LBSGD", "DCASGD", "NAG", "SGLD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam",
           "LAMB", "Test", "Updater", "get_updater"]
