"""Counterpart of ``mxnet_tpu.gluon.contrib``: the contrib layers
(``nn``), cells (``rnn``) and the ``Estimator`` fit API
(``estimator``)."""
from . import nn
from . import rnn
from . import estimator
