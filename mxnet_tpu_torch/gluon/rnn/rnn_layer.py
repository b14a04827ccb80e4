"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``: counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``.

Parameters are the reference's, ``{l,r}<i>_{i2h,h2h}_{weight,bias}`` per
layer ``i`` and direction (``l`` forward, ``r`` backward), from
``self.params.get`` with ``input_size=0`` inferred at the first call, so
that ``collect_params`` and ``save_parameters`` name them as the reference
does. ``forward`` takes tensors in the ``TNC`` or ``NTC`` layout and, when
given, the states (a tensor or a list: h, and c for LSTM, each ``(L*D, B,
H)``); it returns the output, and the new states when states were given.
Each (layer, direction) runs :func:`~mxnet_tpu_torch.ops.rnn.
rnn_scan_layer` (cuDNN on the card, the plain per-step loop on the CPU);
between layers, in training, the lowbias32 ``Dropout`` with fresh key
words, as the reference's ``F.Dropout``.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ...ndarray import ndarray as _nd
from ...ops import nn as _ops
from ...ops.rnn import rnn_scan_layer as _scan

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        self.__dict__["_mode"] = mode  # _alias() runs in Block.__init__
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        if projection_size:
            raise NotImplementedError("LSTMP projection_size is not supported")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     (ng * nh, ni), i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     (ng * nh, nh), h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     (ng * nh,), i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     (ng * nh,), h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def extra_repr(self):
        shape = self.l0_i2h_weight.shape
        s = "{} -> {}, {}".format(shape[1] if shape[1] else None,
                                  shape[0] // self._gates, self._layout)
        if self._num_layers != 1:
            s += ", num_layers={}".format(self._num_layers)
        if self._dropout != 0:
            s += ", dropout={}".format(self._dropout)
        if self._dir == 2:
            s += ", bidirectional"
        return s

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, inputs, *states):
        ni = inputs.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "{}{}_i2h_weight".format(j, i)).shape = \
                    (ng * nh, ni)
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``ctx`` and ``dtype`` from ``kwargs``;
        the current context, the card unless a scope says otherwise)."""
        states = []
        for info in self.state_info(batch_size):
            info.update(kwargs)
            shape = info.pop("shape")
            states.append(_nd.zeros(shape, **{k: v for k, v in info.items()
                                              if k in ("dtype", "ctx")}))
        return states

    def forward(self, inputs, states=None):
        self._ready(inputs)
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        if isinstance(states, torch.Tensor):
            states = [states]
        out, new_states = self._forward_kernel(inputs, states)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, new_states

    def _forward_kernel(self, inputs, states):
        """Stack the layers and directions over the scan primitive."""
        t = self._parameters
        h_all = states[0]
        c_all = states[1] if len(states) > 1 else None
        x = inputs
        h_outs, c_outs = [], []
        for i in range(self._num_layers):
            dir_outs = []
            for d, j in enumerate(["l", "r"][:self._dir]):
                idx = i * self._dir + d
                res = _scan(x, t["%s%d_i2h_weight" % (j, i)],
                            t["%s%d_h2h_weight" % (j, i)],
                            t["%s%d_i2h_bias" % (j, i)],
                            t["%s%d_h2h_bias" % (j, i)], h_all[idx],
                            c_all[idx] if self._mode == "lstm" else None,
                            mode=self._mode, reverse=d == 1)
                dir_outs.append(res[0])
                h_outs.append(res[1])
                if self._mode == "lstm":
                    c_outs.append(res[2])
            x = dir_outs[0] if self._dir == 1 else torch.cat(dir_outs, dim=2)
            if self._dropout and i < self._num_layers - 1:
                x = _ops.Dropout(x, p=self._dropout, train=self.training)
        new_states = [torch.stack(h_outs, dim=0)]
        if self._mode == "lstm":
            new_states.append(torch.stack(c_outs, dim=0))
        return x, new_states


class RNN(_RNNLayer):
    """Elman RNN with ``tanh`` or ``relu``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Long short-term memory, gates ``i, f, g, o``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Gated recurrent unit, gates ``r, z, n``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
