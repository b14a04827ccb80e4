"""Counterpart of ``mxnet_tpu.gluon.contrib.rnn``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_cell import __all__  # noqa: F401
