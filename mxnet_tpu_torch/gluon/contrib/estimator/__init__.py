"""Counterpart of ``mxnet_tpu.gluon.contrib.estimator``."""
from .estimator import Estimator  # noqa: F401
from .event_handler import *  # noqa: F401,F403
