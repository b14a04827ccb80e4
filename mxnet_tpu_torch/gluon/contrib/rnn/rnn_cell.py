"""Contrib recurrent cells: counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``.

``VariationalDropoutCell`` (one dropout mask per sequence, drawn at its
first step and kept across the steps until ``reset``) and ``LSTMPCell``
(an LSTM whose hidden state is projected, state ``[r, c]``), written as
the reference's over the port's ``nd``.
"""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, HybridRecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Apply Gal & Ghahramani variational dropout: ONE mask per sequence,
    shared across time steps (MXNet's contrib/rnn/rnn_cell.py:35)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _initialize_mask(self, F, name, rate, like):
        """Draw the sequence-persistent mask on first step."""
        mask = F.Dropout(F.ones_like(like), p=rate)
        return mask

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._initialize_mask(
                    F, "in", self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._initialize_mask(
                    F, "st", self.drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._initialize_mask(
                    F, "out", self.drop_outputs, output)
            output = output * self._output_mask
        return output, states

    def __repr__(self):
        return "VariationalDropoutCell(%s)" % self.base_cell


class LSTMPCell(HybridRecurrentCell):
    """LSTM with hidden-state projection (reference
    contrib/rnn/rnn_cell.py LSTMPCell; arXiv:1402.1128). State layout:
    [projected hidden (num_projection), cell (num_hidden)]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, x):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]

    def __repr__(self):
        return "LSTMPCell(%d -> %d -> %d)" % (
            self.i2h_weight.shape[1] or 0, self._hidden_size,
            self._projection_size)
