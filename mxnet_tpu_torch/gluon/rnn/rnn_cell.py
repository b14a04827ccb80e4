"""Recurrent cells: counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``.

``RecurrentCell``/``HybridRecurrentCell``, ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``SequentialRNNCell``, ``HybridSequentialRNNCell``,
``DropoutCell``, ``ModifierCell``, ``ZoneoutCell``, ``ResidualCell`` and
``BidirectionalCell``, written as the reference's are: parameters from
``self.params.get`` (``i2h``/``h2h`` ``weight`` and ``bias``, shapes
deferred until the first call), ``hybrid_forward(F, ...)`` over NDArrays
with ``F`` the port's ``nd``, and ``unroll`` stepping the cell over time
(``valid_length`` masks the outputs through ``SequenceMask``).
``begin_state`` makes zeros on the current context (the card unless a
``with mx.cpu():`` scope or ``ctx=`` says otherwise).
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ...ndarray import ndarray as _nd

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, _nd.NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[axis]
            inputs = [x.squeeze(axis=axis) for x in
                      _split_axis(inputs, inputs.shape[axis], axis)]
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = _nd.stack(*[i for i in inputs], axis=axis)
    return inputs, axis, batch_size


def _split_axis(x, num, axis):
    from ... import ndarray as F
    return F.split(x, num_outputs=num, axis=axis)


def _mask_like(F, data, p):
    return F.Dropout(data.ones_like(), p=p, mode="always")


class RecurrentCell(Block):
    """Base cell (MXNet's rnn_cell.py:77)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base cell " \
            "cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info = dict(info)
                shape = info.pop("shape")
                info.pop("__layout__", None)
                info.update(kwargs)
            else:
                shape = (0, 0)
                info = dict(kwargs)
            info = {k: v for k, v in info.items() if k in ("ctx", "dtype")}
            states.append(_nd.zeros(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """MXNet's rnn_cell.py:190."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = self.begin_state(batch_size, ctx=inputs[0].ctx) \
            if begin_state is None else begin_state
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            from ... import ndarray as F
            stacked = _nd.stack(*outputs, axis=axis)
            stacked = F.SequenceMask(stacked, valid_length,
                                     use_sequence_length=True,
                                     axis=layout.find("T"))
            outputs = stacked if merge_outputs else \
                [o.squeeze(axis=axis) for o in
                 _split_axis(stacked, length, axis)]
            return outputs, states
        if merge_outputs:
            outputs = _nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """MXNet's rnn_cell.py:363."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman cell (MXNet's rnn_cell.py:380)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, *states):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def __repr__(self):
        s = "{name}({mapping}"
        if hasattr(self, "_activation"):
            s += ", {_activation}"
        s += ")"
        shape = self.i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None, shape[0])
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        i2h_plus_h2h = i2h + h2h
        output = self._get_activation(F, i2h_plus_h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """MXNet's rnn_cell.py:472 (gate order i,f,c,o, as cuDNN's)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, x, *states):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.split(gates, num_outputs=4, axis=1)
        in_gate = self._get_activation(F, slice_gates[0],
                                       self._recurrent_activation)
        forget_gate = self._get_activation(F, slice_gates[1],
                                           self._recurrent_activation)
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation)
        out_gate = self._get_activation(F, slice_gates[3],
                                        self._recurrent_activation)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """MXNet's rnn_cell.py:599 (gate order r,z,n)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, x, *states):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells (MXNet's rnn_cell.py:706)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        return s.format(name=self.__class__.__name__,
                        modstr="\n".join(
                            "({i}): {m}".format(i=i, m=m)
                            for i, m in self._modules.items()))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._modules.values())
        for cell in self._modules.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)

    def forward(self, *args):
        raise NotImplementedError


class HybridSequentialRNNCell(HybridRecurrentCell):
    """MXNet's rnn_cell.py:788."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)


class DropoutCell(HybridRecurrentCell):
    """MXNet's rnn_cell.py:884."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self._rate = rate
        self._axes = axes

    def __repr__(self):
        return "{name}(rate={_rate}, axes={_axes})".format(
            name=self.__class__.__name__, **self.__dict__)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Wraps a base cell (MXNet's rnn_cell.py:931)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def __repr__(self):
        return "{name}({base_cell})".format(name=self.__class__.__name__,
                                            base_cell=self.base_cell)


class ZoneoutCell(ModifierCell):
    """MXNet's rnn_cell.py:986."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: _mask_like(F, like, p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = next_output.zeros_like()
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """MXNet's rnn_cell.py:1049."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    """MXNet's rnn_cell.py:1089."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        return "{name}(forward={l_cell}, backward={r_cell})".format(
            name=self.__class__.__name__,
            l_cell=self._modules["l_cell"],
            r_cell=self._modules["r_cell"])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._modules.values(),
                                  batch_size=batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = self.begin_state(batch_size, ctx=inputs[0].ctx) \
            if begin_state is None else begin_state
        states = begin_state
        l_cell, r_cell = self._modules.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        from ... import ndarray as F
        outputs = [F.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = _nd.stack(*outputs, axis=axis)
        states = l_states + r_states
        return outputs, states
