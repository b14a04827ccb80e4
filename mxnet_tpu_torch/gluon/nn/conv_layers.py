"""Convolution and pooling layers: counterparts of
``mxnet_tpu/gluon/nn/conv_layers.py``.

``Conv1D``-``Conv3D``, ``Conv1DTranspose``-``Conv3DTranspose``, the max,
average and global pooling layers in 1-3 dimensions and
``ReflectionPad2D``, channels first (``NCW``, ``NCHW``, ``NCDHW``). Each
is a ``HybridBlock`` whose ``forward`` takes tensors and calls the
``Convolution``, ``Deconvolution``, ``Pooling`` or ``pad`` op of the port
(and whose ``_sym_forward`` composes the same op into a Symbol graph).
Parameters are made as the reference's: ``weight`` ``(channels,
in_channels / groups, *kernel)`` (a transposed convolution's ``(in_channels,
channels / groups, *kernel)``) and ``bias`` ``(channels,)`` through
``self.params.get``, ``in_channels=0`` inferred at the first call.
"""
from __future__ import annotations

from ...ops import core as _core
from ...ops import nn as _ops
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """A convolution (``op_name="Convolution"``) or a transposed one
    (``"Deconvolution"``), with an optional ``activation``."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            n = len(kernel_size)
            self._op = _ops.Convolution if op_name == "Convolution" \
                else _ops.Deconvolution
            self._kwargs = {
                "kernel": kernel_size, "stride": _tuple(strides, n),
                "dilate": _tuple(dilation, n), "pad": _tuple(padding, n),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            self._op_name = op_name
            self._groups = groups
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + "_")

    def _alias(self):
        return "conv"

    def infer_shape(self, x):
        w = list(self.weight.shape)
        if self._op is _ops.Convolution:
            w[1] = x.shape[1] // self._groups
        else:
            w[0] = x.shape[1]
        self.weight.shape = tuple(w)

    def forward(self, x):
        self._ready(x)
        out = self._op(x, self._parameters["weight"],
                       self._parameters.get("bias"), **self._kwargs)
        return out if self.act is None else self.act(out)

    def _sym_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        shape = self.weight.shape
        return "{0} -> {1}, kernel_size={2}, stride={3}".format(
            shape[1] if shape[1] else None, shape[0], self._kwargs["kernel"],
            self._kwargs["stride"])


def _kernel(kernel_size, n):
    kernel_size = _tuple(kernel_size, n)
    assert len(kernel_size) == n, "kernel_size must be %d ints" % n
    return kernel_size


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _kernel(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _kernel(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _kernel(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _ConvTranspose(_Conv):
    def __init__(self, n, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        output_padding = _tuple(output_padding, n)
        super().__init__(channels, _kernel(kernel_size, n), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)
        self.outpad = output_padding


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class _Pooling(HybridBlock):
    """Pooling through the ``Pooling`` op; ``ceil_mode`` is the ``full``
    convention; ``strides`` default to ``pool_size``."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _tuple(strides, len(pool_size)),
            "pad": _tuple(padding, len(pool_size)),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def forward(self, x):
        return _ops.Pooling(x, **self._kwargs)

    def _sym_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join("%s=%s" % kv for kv in self._kwargs.items())


def _pool_cls(name, n, pool_type, layout):
    def __init__(self, pool_size=(2,) * n, strides=None, padding=0,
                 layout=layout, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        _Pooling.__init__(self, _tuple(pool_size, n), strides, padding,
                          ceil_mode, False, pool_type, layout,
                          count_include_pad if pool_type == "avg" else None,
                          **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__":
                                    "%s pooling in %d-D (%s)."
                                    % (pool_type.title(), n, layout)})


def _global_cls(name, n, pool_type, layout):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * n, None, 0, True, True, pool_type,
                          layout, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__":
                                    "Global %s pooling in %d-D (%s)."
                                    % (pool_type, n, layout)})


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
MaxPool1D, MaxPool2D, MaxPool3D = (
    _pool_cls("MaxPool%dD" % n, n, "max", _LAYOUTS[n]) for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (
    _pool_cls("AvgPool%dD" % n, n, "avg", _LAYOUTS[n]) for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_cls("GlobalMaxPool%dD" % n, n, "max", _LAYOUTS[n])
    for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_cls("GlobalAvgPool%dD" % n, n, "avg", _LAYOUTS[n])
    for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes: ``padding`` an int (every
    side) or the ``pad`` op's 8 widths."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def forward(self, x):
        return _core.pad.fn(x, mode="reflect", pad_width=self._padding)

    def _sym_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
