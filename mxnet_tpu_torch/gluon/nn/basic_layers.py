"""Basic layers: counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``.

``Sequential``, ``HybridSequential``, ``Dense``, ``Dropout``,
``Embedding``, ``BatchNorm``, ``InstanceNorm``, ``LayerNorm``,
``GroupNorm``, ``Flatten``, ``Lambda``, ``HybridLambda`` and
``Activation``, as ``HybridBlock``s (so ``nn.Module``s) whose ``forward``
takes tensors; a call with NDArrays goes through ``gluon.Block.__call__``,
and a call with Symbols composes each layer's reference op
(``_sym_forward``).
Parameters keep Gluon's leaf names and shapes (``weight`` ``(out, in)``,
``bias``, ``gamma``, ``beta``, ``running_mean``, ``running_var``).

Two ways to make parameters:

- given a ``device``, ``Dense``, ``Embedding`` and ``LayerNorm`` allocate
  their tensors at construction with their shapes given (the port's
  transformer models build them so); a state dict maps one to one onto
  the reference's ``collect_params()`` (see ``mxnet_tpu_torch/convert.py``);
- otherwise a layer creates its parameters as the reference's does
  (``self.params.get``): a 0 in a shape (``in_units=0``,
  ``in_channels=0``) is inferred at the first call, and the tensors are
  made by ``initialize(ctx=...)`` on that context (the current one when
  None: the card, or ``mx.cpu()`` inside ``with mx.cpu():``). The model
  zoo's layers are all made this way.

``BatchNorm`` keeps float32 parameters under ``cast`` to a 16-bit type
and writes its moving statistics through ``_tape.aux_write``: in place
eagerly, as extra outputs inside a ``CachedOp``, ``functionalize`` or a
``ShardedTrainer`` step.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ... import _tape
from ...base import dtype_name
from ...context import default_device
from ...ndarray.ndarray import NDArray
from ...ops import core as _core
from ...ops import nn as _ops
from ..block import Block, HybridBlock, _unwrap_out, _wrap

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Activation"]


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def _xavier_(w):
    """Gluon's ``Xavier()`` default: uniform, average fan, magnitude 3."""
    fan_out, fan_in = w.shape[0], w.shape[1]
    bound = (3.0 / ((fan_in + fan_out) / 2.0)) ** 0.5
    with torch.no_grad():
        w.uniform_(-bound, bound)


class Sequential(Block):
    """Blocks run one after another (a ``Block``: its children may take
    NDArrays or tensors)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def hybridize(self, active=True, **kwargs):
        if self._modules and all(isinstance(c, HybridBlock)
                                 for c in self._modules.values()):
            warnings.warn(
                "All children of this Sequential layer '%s' are HybridBlocks. "
                "Consider using HybridSequential for the best performance."
                % self.prefix, stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Hybridizable ``Sequential``."""

    add = Sequential.add
    forward = Sequential.forward
    __getitem__ = Sequential.__getitem__
    __len__ = Sequential.__len__
    __iter__ = Sequential.__iter__


class Activation(HybridBlock):
    """``relu``, ``sigmoid``, ``tanh``, ``softrelu`` or ``softsign``."""

    def __init__(self, activation, prefix=None, params=None):
        self.__dict__["_act_type"] = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return _ops.Activation(x, act_type=self._act_type)

    def _sym_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Dense(HybridBlock):
    """Fully-connected layer: ``weight (units, in_units)``, optional
    ``bias (units,)``, an optional ``activation``. With ``flatten`` the
    input is flattened to ``(batch, -1)``; without, the last axis is
    contracted. Given a ``device``, the tensors are made now (``in_units``
    required, ``Xavier``-drawn until ``initialize``); without one, as the
    reference's layer (``in_units=0`` is inferred at the first call)."""

    # the reference layer's init default of each parameter (read by
    # gluon.parameter.collect_params)
    _param_init = {"weight": None, "bias": "zeros"}

    def __init__(self, units, in_units=0, use_bias=True, flatten=True,
                 device=None, dtype=torch.float32, activation=None,
                 weight_initializer=None, bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._flatten = flatten
        self._units = units
        if device is not None:
            if not in_units:
                raise ValueError("Dense on a device needs in_units")
            device = default_device(device)
            self.weight = _param((units, in_units), device, dtype)
            self.bias = _param((units,), device, dtype) if use_bias else None
            self.reset_parameters()
        else:
            with self.name_scope():
                self.weight = self.params.get(
                    "weight", shape=(units, in_units), dtype=dtype,
                    init=weight_initializer, allow_deferred_init=True)
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True) \
                    if use_bias else None
        with self.name_scope():
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + "_")

    def reset_parameters(self):
        _xavier_(self.weight)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def infer_shape(self, x):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        self._ready(x)
        out = _ops.FullyConnected(x, self._parameters["weight"],
                                  self._parameters.get("bias"),
                                  flatten=self._flatten)
        return out if self.act is None else self.act(out)

    def _sym_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten, no_bias=bias is None)
        return out if self.act is None else self.act(out)


class Dropout(HybridBlock):
    """Dropout of ``rate`` (mask size 1 on ``axes``): in training mode the
    lowbias32 ``Dropout`` op with a fresh key from
    :func:`~mxnet_tpu_torch.random.next_key`; the identity otherwise."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return _ops.Dropout(x, p=self._rate, axes=self._axes,
                            train=self.training)

    def _sym_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def extra_repr(self):
        return "p = {}, axes={}".format(self._rate, self._axes)


# tables of at most this many rows take their weight gradient as a one-hot
# product (see _Lookup)
_ONE_HOT_ROWS = 1024


class _Lookup(torch.autograd.Function):
    """``weight[ids]`` with a weight gradient that is bitwise repeatable.

    ``F.embedding``'s CUDA backward is not where one id repeats many times:
    BERT's two segment rows take 4096 gradient rows each at batch 64,
    sequence 128, and their sums differed between two runs in the last
    bits. Here a table of at most ``_ONE_HOT_ROWS`` rows takes the product
    of the ids' one-hot matrix with the gradient (one matmul, float32
    accumulation); a larger one an ``index_put_`` accumulation in float32,
    which sorts the ids and adds each id's rows in their order."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        ids = ids.reshape(-1)
        grad = grad.reshape(ids.numel(), -1)
        if ctx.rows <= _ONE_HOT_ROWS:
            hot = nn.functional.one_hot(ids, ctx.rows).to(grad.dtype)
            return None, hot.t() @ grad
        acc = grad.new_zeros((ctx.rows, grad.shape[1]), dtype=torch.float32)
        acc.index_put_((ids,), grad.float(), accumulate=True)
        return None, acc.to(grad.dtype)


class Embedding(HybridBlock):
    """Embedding lookup: ``weight (input_dim, output_dim)``; integer ids
    of any integer dtype (float ids are truncated). The weight gradient is
    the same, bit for bit, in every run (:class:`_Lookup`). Given a
    ``device``, the weight is made now (``Xavier``-drawn until
    ``initialize``); without one, as the reference's layer
    (``self.params.get``, made by ``initialize(ctx=...)``; ``params=``
    shares another block's, as a tied decoder shares the encoder's).
    ``sparse_grad`` is accepted; the gradient is dense."""

    _param_init = {"weight": None}

    def __init__(self, input_dim, output_dim, device=None,
                 dtype=torch.float32, weight_initializer=None,
                 sparse_grad=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        if device is not None:
            device = default_device(device)
            self.weight = _param((input_dim, output_dim), device, dtype)
            self.reset_parameters()
        else:
            with self.name_scope():
                self.weight = self.params.get(
                    "weight", shape=(input_dim, output_dim), dtype=dtype,
                    init=weight_initializer)

    def reset_parameters(self):
        _xavier_(self.weight)

    def forward(self, x):
        self._ready(x)
        return _Lookup.apply(x.long(), self._parameters["weight"])

    def _sym_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    """Layer norm over ``axis`` with ``gamma``/``beta`` of
    ``(in_channels,)``, eps 1e-5."""

    _param_init = {"gamma": "ones", "beta": "zeros"}

    def __init__(self, in_channels, axis=-1, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = _param((in_channels,), device, dtype)
        self.beta = _param((in_channels,), device, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return _ops.LayerNorm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)

    def _sym_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


def _scalar(v, like):
    """``v`` rounded to ``like``'s dtype, as a Python number: JAX rounds a
    Python number to a low-precision tensor's dtype before the product
    (made on the host: a device tensor would cost a copy and a sync)."""
    return torch.tensor(v, dtype=like.dtype).item()


def _norm_param(block, name, trained, init, in_channels, **kwargs):
    """A normalization layer's ``(in_channels,)`` parameter, deferred."""
    return block.params.get(name, grad_req="write" if trained else "null",
                            shape=(in_channels,), init=init,
                            allow_deferred_init=True, **kwargs)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` with moving statistics.

    In training (``autograd.train_mode()``, a ``ShardedTrainer`` step)
    without ``use_global_stats`` it normalizes by the batch's statistics
    (the ``BatchNorm`` op) and writes ``momentum * running + (1 - momentum)
    * batch`` into ``running_mean``/``running_var`` in their dtype
    (``_tape.aux_write``); otherwise it normalizes by the moving
    statistics. ``scale=False`` fixes gamma at 1 (no gradient),
    ``center=False`` keeps beta out of training. ``cast`` to float16 or
    bfloat16 keeps every parameter float32, as the reference's does."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = _norm_param(self, "gamma", scale, gamma_initializer,
                                     in_channels, differentiable=scale)
            self.beta = _norm_param(self, "beta", center, beta_initializer,
                                    in_channels, differentiable=center)
            self.running_mean = _norm_param(
                self, "running_mean", False, running_mean_initializer,
                in_channels, differentiable=False)
            self.running_var = _norm_param(
                self, "running_var", False, running_variance_initializer,
                in_channels, differentiable=False)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"
        super().cast(dtype)

    def forward(self, x):
        self._ready(x)
        t = self._parameters
        gamma, beta = t["gamma"], t["beta"]
        mean, var = t["running_mean"], t["running_var"]
        if not self.training or self._kwargs["use_global_stats"]:
            return _ops.BatchNorm(x, gamma, beta, mean, var, train=False,
                                  **self._kwargs)
        out, bmean, bvar = _ops.BatchNorm(x, gamma, beta, mean, var,
                                          output_mean_var=True, train=True,
                                          **self._kwargs)
        m = self._momentum
        with torch.no_grad():
            for run, batch in ((mean, bmean), (var, bvar)):
                new = _scalar(m, run) * run \
                    + _scalar(1 - m, run) * batch.to(run.dtype)
                _tape.aux_write(NDArray._bind(run), new)
        return out

    def _sym_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)


class InstanceNorm(HybridBlock):
    """Instance normalization (over each sample's and channel's spatial
    axes; ``axis`` is the channel axis). ``scale=False`` by default, as in
    the reference."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = _norm_param(self, "gamma", scale, gamma_initializer,
                                     in_channels)
            self.beta = _norm_param(self, "beta", center, beta_initializer,
                                    in_channels)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        self._ready(x)
        g, b = self._parameters["gamma"], self._parameters["beta"]
        if self._axis == 1:
            return _ops.InstanceNorm(x, g, b, eps=self._epsilon)
        x = x.transpose(1, self._axis)
        return _ops.InstanceNorm(x, g, b, eps=self._epsilon) \
            .transpose(1, self._axis)

    def _sym_forward(self, F, x, gamma, beta):
        if self._axis != 1:
            raise NotImplementedError(
                "InstanceNorm over axis %d has no symbolic form (a Symbol "
                "has no swapaxes)" % self._axis)
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalization of ``num_groups`` channel groups."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._axis = 1
        with self.name_scope():
            self.gamma = _norm_param(self, "gamma", scale, gamma_initializer,
                                     in_channels)
            self.beta = _norm_param(self, "beta", center, beta_initializer,
                                    in_channels)

    infer_shape = InstanceNorm.infer_shape

    def forward(self, x):
        self._ready(x)
        return _ops.GroupNorm(x, self._parameters["gamma"],
                              self._parameters["beta"],
                              num_groups=self._num_groups, eps=self._epsilon)

    def _sym_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Flatten(HybridBlock):
    """Flatten to ``(batch, -1)``."""

    def forward(self, x):
        return _core.Flatten.fn(x)

    def _sym_forward(self, F, x):
        return F.Flatten(x)


def _lambda_impl(function):
    if isinstance(function, str):
        from ... import ndarray as nd
        return getattr(nd, function), function
    if callable(function):
        return function, function.__name__
    raise ValueError("Unrecognized function in lambda: %r" % function)


class Lambda(Block):
    """A function as a ``Block``: a name in ``nd``, or a callable over
    NDArrays (tensor inputs are wrapped and the outputs unwrapped)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl, self._func_name = _lambda_impl(function)

    def forward(self, *args):
        if any(isinstance(a, torch.Tensor) for a in args):
            return _unwrap_out(self._func_impl(*[_wrap(a) for a in args]))
        return self._func_impl(*args)

    def extra_repr(self):
        return self._func_name


class HybridLambda(HybridBlock):
    """A function ``f(F, x, *args)`` as a ``HybridBlock`` (``F`` is the
    port's ``nd``); a name in ``nd`` calls that op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            name = function
            self._func = lambda F, *args: getattr(F, name)(*args)
            self._func_name = function
        else:
            self._func, self._func_name = _lambda_impl(function)

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def extra_repr(self):
        return self._func_name
