"""Weight initializers: counterpart of ``mxnet_tpu/initializer.py``.

Numpy, copied from the reference (the port imports nothing of it): the
registry (``register``, ``registry``, ``create``, ``dumps``), ``InitDesc``,
dispatch by the parameter name's suffix, and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``Mixed`` and ``Load``.

Every initializer fills a numpy host array from numpy's global random
state, exactly as the reference does, so the same seed
(``mxnet_tpu_torch.random.seed`` seeds numpy, as ``mx.random.seed`` does)
and the same parameter order give the reference's values bit for bit. Given
a ``torch.Tensor`` instead of a numpy array, an initializer fills a host
array of the tensor's shape (in its numpy dtype; float32 for bfloat16) and
then copies it into the tensor, on the tensor's device and in its dtype,
under ``torch.no_grad()``: the values are never drawn with torch.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

__all__ = ["InitDesc", "Initializer", "register", "registry", "create",
           "Zero", "One", "Constant", "Uniform", "Normal", "Orthogonal",
           "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "Mixed", "Load"]

_HOST_DTYPES = {torch.float16: _np.float16, torch.float64: _np.float64}


def _host_array(value):
    """``value`` (a tensor, array or nested list) as a numpy array; a
    bfloat16 tensor as float32."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return _np.asarray(value)


def _on_host(fill):
    """Wrap ``fill(self, name, arr)`` so that a ``torch.Tensor`` ``arr`` is
    filled through a numpy host array and copied in afterwards."""
    def call(self, name, arr):
        if not isinstance(arr, torch.Tensor):
            return fill(self, name, arr)
        host = _np.zeros(tuple(arr.shape),
                         _HOST_DTYPES.get(arr.dtype, _np.float32))
        fill(self, name, host)
        with torch.no_grad():
            arr.copy_(torch.from_numpy(host))
        return None
    call.__doc__ = fill.__doc__
    return call


_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lowercased name (reference
    `python/mxnet/initializer.py` mx.init.register)."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def registry():
    return dict(_INIT_REGISTRY)


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform()
    aliases = {"zeros": "zero", "ones": "one", "gaussian": "normal"}
    key = str(name).lower()
    klass = _INIT_REGISTRY.get(aliases.get(key, key))
    if klass is None:
        raise ValueError("unknown initializer %r (have: %s)"
                         % (name, sorted(_INIT_REGISTRY)))
    return klass(**kwargs)


class InitDesc(str):
    """Name + attrs describing how to init a parameter (reference
    `python/mxnet/initializer.py:62`)."""
    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: dispatch by parameter name suffix, like the
    reference's pattern matching (`python/mxnet/initializer.py:144`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    @_on_host
    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("first argument must be a name string/InitDesc")
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(json.loads(init)[0], **json.loads(init)[1])._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    # each _init_* writes into arr via arr[:] = value
    def _init_weight(self, name, arr):
        raise NotImplementedError("virtual _init_weight")

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__,
                           ", ".join("%s=%r" % kv for kv in self._kwargs.items()))


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        import numbers
        if isinstance(self.value, numbers.Number):
            arr[:] = self.value
        else:
            arr[:] = _host_array(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[:] = _np.random.uniform(-self.scale, self.scale, arr.shape)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[:] = _np.random.normal(0, self.sigma, arr.shape)


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape)


def _fan(shape, factor_type):
    hw = int(_np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    return fan_in, fan_out


@register
class Xavier(Initializer):
    """reference `python/mxnet/initializer.py` Xavier: uniform/normal with
    magnitude scaled by avg/in/out fan."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 1:
            raise ValueError("Xavier requires at least 1D weight %s" % name)
        fan_in, fan_out = _fan(shape, self.factor_type)
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type %r" % self.factor_type)
        scale = _np.sqrt(self.magnitude / max(factor, 1e-12))
        if self.rnd_type == "uniform":
            arr[:] = _np.random.uniform(-scale, scale, shape)
        elif self.rnd_type == "gaussian":
            arr[:] = _np.random.normal(0, scale, shape)
        else:
            raise ValueError("Unknown random type %r" % self.rnd_type)


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel (deconv init)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = _np.zeros(int(_np.prod(shape)), dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (reference initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        v = _np.zeros(arr.shape)
        num_hidden = arr.shape[0] // 4
        v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v

    # the tensor this initializer targets IS a bias, so direct calls on a
    # "*_bias" name must hit the same logic (the Parameter path arrives via
    # attrs["__init__"] -> _init_weight, reference initializer.py:517)
    _init_bias = _init_weight


class Mixed:
    """Apply different initializers by name regex (reference Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers mismatched")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    @_on_host
    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise ValueError("parameter %s did not match any pattern" % name)


@register
class Load:
    """Init from a dict of saved arrays, fall back to default_init."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    @_on_host
    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src = _host_array(src)
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("shape mismatch for %s" % name)
            arr[:] = src
        else:
            if self.default_init is None:
                raise ValueError("no initializer provided for %s" % name)
            self.default_init(name, arr)
