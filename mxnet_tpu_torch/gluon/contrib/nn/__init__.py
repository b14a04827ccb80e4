"""Counterpart of ``mxnet_tpu.gluon.contrib.nn``."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__  # noqa: F401
