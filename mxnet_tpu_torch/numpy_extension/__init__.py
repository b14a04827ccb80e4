"""``mx.npx``: the numpy-extension namespace (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``): the registry's operators
through an :class:`_OpProxy` that returns ``mx.np`` arrays, the common
entry points by name, and the numpy-mode flags (``set_np`` and its kin
are flags; ``use_np*`` the identity: numpy semantics are always on)."""
from __future__ import annotations

from ..ndarray.ndarray import NDArray as _NDArrayBase
from ..ops.registry import get_op as _get_op

_np_mode = [False]


def set_np(shape=True, array=True, dtype=False):
    _np_mode[0] = True


def reset_np():
    _np_mode[0] = False


def is_np_array():
    return _np_mode[0]


def is_np_shape():
    return _np_mode[0]


def use_np(func):
    return func


use_np_shape = use_np
use_np_array = use_np


class _OpProxy:
    """A registry op whose results come back as ``mx.np`` arrays (on the
    same tensors)."""

    def __init__(self, op):
        self._op = op

    def __call__(self, *args, **kwargs):
        from .. import numpy as np_mod
        return np_mod._as_np(self._op(*args, **kwargs))


def __getattr__(name):
    op = _get_op(name)
    if op is not None:
        return _OpProxy(op)
    raise AttributeError("module 'mxnet_tpu_torch.numpy_extension' has no "
                         "attribute %r" % name)


def softmax(data, axis=-1, **kwargs):
    return __getattr__("softmax")(data, axis=axis, **kwargs)


def log_softmax(data, axis=-1, **kwargs):
    return __getattr__("log_softmax")(data, axis=axis, **kwargs)


def relu(data):
    return __getattr__("relu")(data)


def sigmoid(data):
    return __getattr__("sigmoid")(data)


def batch_norm(x, gamma, beta, running_mean, running_var, **kwargs):
    return __getattr__("BatchNorm")(x, gamma, beta, running_mean,
                                    running_var, **kwargs)


def convolution(data=None, weight=None, bias=None, **kwargs):
    return __getattr__("Convolution")(data, weight, bias, **kwargs)


def fully_connected(x, weight, bias=None, **kwargs):
    return __getattr__("FullyConnected")(x, weight, bias, **kwargs)


def pooling(data, **kwargs):
    return __getattr__("Pooling")(data, **kwargs)


def one_hot(data, depth, **kwargs):
    return __getattr__("one_hot")(data, depth=depth, **kwargs)


def pick(data, index, axis=-1, **kwargs):
    return __getattr__("pick")(data, index, axis=axis, **kwargs)


def reshape_like(lhs, rhs):
    return __getattr__("reshape_like")(lhs, rhs)


def topk(data, axis=-1, k=1, **kwargs):
    return __getattr__("topk")(data, axis=axis, k=k, **kwargs)


def seed(seed_state=None, ctx="all"):
    from .. import random as _random
    _random.seed(0 if seed_state is None else int(seed_state))


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              out=None):
    """Bernoulli draws of ``prob`` or ``sigmoid(logit)`` (exactly one of
    them), on the probability's device (an array's, else the context's)."""
    if (prob is None) == (logit is None):
        raise ValueError("exactly one of prob / logit must be given")
    from .. import numpy as np_mod
    from .. import random as _random
    from ..ops.numpy_ops import _npi_bernoulli
    from ..context import Context
    src = prob if prob is not None else logit
    val = src._data if isinstance(src, _NDArrayBase) else src
    kw = {"prob": val} if prob is not None else {"logit": val}
    dev = np_mod._device(ctx) if not isinstance(src, _NDArrayBase) \
        else val.device
    draw = _npi_bernoulli.fn(size=size, ctx=Context.from_device(dev),
                          dtype=dtype or "float32", key=_random.next_key(),
                          **kw)
    return np_mod.ndarray(draw)


def waitall():
    from ..ndarray import ndarray as _nd
    _nd.waitall()


def load(fname):
    from ..ndarray import ndarray as _nd
    from .. import numpy as np_mod
    out = _nd.load(fname)
    if isinstance(out, dict):
        return {k: np_mod._as_np(v) for k, v in out.items()}
    return [np_mod._as_np(v) for v in out]


def save(fname, data):
    from ..ndarray import ndarray as _nd
    _nd.save(fname, data)
