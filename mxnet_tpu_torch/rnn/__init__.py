"""Counterpart of ``mxnet_tpu.rnn`` (the legacy ``mx.rnn``):
``BucketSentenceIter`` and ``encode_sentences``, and the legacy cell
names, which are the Gluon cells (one implementation serves both, as in
the reference)."""
from .io import BucketSentenceIter, encode_sentences
from ..gluon.rnn import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                         BidirectionalCell, DropoutCell, ZoneoutCell,
                         ResidualCell)
