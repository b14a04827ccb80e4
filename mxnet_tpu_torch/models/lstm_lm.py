"""The word language model: counterpart of ``mxnet_tpu/models/lstm_lm.py``
(the reference's ``example/gluon/word_language_model`` ``RNNModel``).

Embedding, then an ``LSTM``, ``GRU`` or Elman ``RNN`` stack, then a
``Dense`` decoder over the vocabulary, with ``Dropout`` after the
embedding and after the stack. Built as the reference builds it (name
scopes, parameters from ``initialize``), so ``collect_params`` and
``save_parameters`` give the reference's names; with ``tie_weights`` the
decoder shares the embedding's weight (``Dense(..., params=
encoder.params)``: one tensor, its bias named ``embedding<n>_bias``).
``forward`` takes ``(T, B)`` token ids (any dtype) and optionally the
states from :meth:`RNNModel.begin_state`; it returns the ``(T, B, V)``
logits, and the new states when states were given.
"""
from __future__ import annotations

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["RNNModel"]


class RNNModel(HybridBlock):
    """Embedding -> (LSTM/GRU/RNN) -> Dense decoder, optionally tied."""

    def __init__(self, mode="lstm", vocab_size=10000, num_embed=200,
                 num_hidden=200, num_layers=2, dropout=0.5, tie_weights=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed,
                                        weight_initializer=None)
            if mode == "lstm":
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
            elif mode == "gru":
                self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            else:
                self.rnn = rnn.RNN(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed,
                                   activation="relu" if mode == "rnn_relu"
                                   else "tanh")
            if tie_weights:
                assert num_embed == num_hidden
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        params=self.encoder.params)
            else:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=num_hidden)
            self.num_hidden = num_hidden

    def forward(self, inputs, hidden=None):
        emb = self.drop(self.encoder(inputs))
        if hidden is None:
            return self.decoder(self.drop(self.rnn(emb)))
        output, hidden = self.rnn(emb, hidden)
        return self.decoder(self.drop(output)), hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)
