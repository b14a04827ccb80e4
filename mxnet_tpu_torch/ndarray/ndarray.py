"""NDArray: a mutable handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``, whose handle is over an
immutable ``jax.Array``. The port keeps the reference's semantics, not
MXNet-C's shared-storage views:

- mutation (``x[:] =``, ``x[i] =``, ``+=``, ``out=``) rebinds ``_data`` to
  a new tensor, so an array made from another one before (``reshape``,
  ``copy``) does not see the change;
- the handles that :meth:`gluon.Parameter.data` and ``grad`` return are
  bound to a module's own tensor: mutating one writes into that tensor in
  place (under ``torch.no_grad``), so the module sees it;
- ``attach_grad`` makes the handle a leaf of torch's autograd with the
  reference's ``grad_req`` (``_tape.hook_grad_req``); a rebind keeps it a
  leaf and keeps its gradient, so ``p -= lr * p.grad`` leaves ``p``
  marked;
- ``wait_to_read`` synchronizes the tensor's device.

Creation functions take ``ctx`` (a :class:`~mxnet_tpu_torch.context
.Context`); without one they use :func:`~mxnet_tpu_torch.context
.current_context`, which is the card unless a ``with mx.cpu():`` scope is
open. ``save``/``load`` read and write the reference's ``.params`` bytes
(:mod:`.serialization`).
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import _tape
from ..base import dtype_np, dtype_name, numeric_types, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "concat", "stack", "save", "load", "waitall",
           "from_numpy", "from_dlpack", "to_dlpack_for_read",
           "to_dlpack_for_write"]


def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def _host(t):
    """A tensor as a numpy array of its own (bfloat16 through
    ``base.dtype_np``): a CPU tensor's memory is copied, never shared, as
    the reference's ``asnumpy`` never aliases its array."""
    on_host = t.device.type == "cpu"
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        np_bf16 = dtype_np("bfloat16")
        return t.float().numpy().astype(np_bf16) \
            if isinstance(np_bf16, _np.dtype) else t.float().numpy()
    return t.numpy().copy() if on_host else t.numpy()


def _tensor(source, ctx=None, dtype=None):
    """``source`` (a tensor, numpy array, scalar or nested list) as a
    tensor on ``ctx``'s device."""
    if isinstance(source, torch.Tensor):
        t = source
        if ctx is not None:
            t = t.to(ctx.torch_device)
    else:
        host = _np.asarray(source)
        if not host.flags.writeable:
            host = host.copy()      # torch would share read-only memory
        if dtype is None and host.dtype == _np.float64:
            host = host.astype(_np.float32)
        if host.dtype.name == "bfloat16":
            host = host.astype(_np.float32)
            dtype = dtype or "bfloat16"
        t = torch.as_tensor(host, device=_device(ctx))
    if dtype is not None and t.dtype != torch_dtype(dtype):
        t = t.to(torch_dtype(dtype))
    return t


class NDArray:
    """Multi-dimensional array on a device context."""

    __slots__ = ("_data", "_grad", "_grad_req", "_leaf", "_bound",
                 "_pass_grad", "_stype", "_ctx", "__weakref__")

    def __init__(self, data, ctx=None, dtype=None, stype="default"):
        if isinstance(data, NDArray):
            data = data._data
        self._data = _tensor(data, ctx, dtype)
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"
        self._leaf = False
        self._bound = False
        self._pass_grad = None
        self._stype = stype

    @classmethod
    def _bind(cls, tensor):
        """A handle bound to ``tensor`` (a module's parameter or its
        gradient): mutation writes into the tensor in place."""
        out = cls.__new__(cls)
        out._data = tensor
        out._grad = None
        out._grad_req = "null"
        out._leaf = False
        out._bound = True
        out._pass_grad = None
        out._stype = "default"
        return out

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self):
        return dtype_np(self._data.dtype)

    @property
    def stype(self):
        return self._stype

    @property
    def ctx(self) -> Context:
        """The array's context: the one it was made on (a logical device
        such as ``cpu(1)`` keeps its id) while the data stays on that
        context's device, else its device's."""
        made = getattr(self, "_ctx", None)
        if made is not None and made.torch_device == self._data.device:
            return made
        return Context.from_device(self._data.device)

    context = ctx

    @property
    def grad(self):
        """The gradient handle (None unless ``attach_grad``); after a
        backward pass it holds that pass's gradient (``"write"``) or the
        sum (``"add"``)."""
        if self._grad is None:
            return None
        g = self._data.grad
        if g is not None and self._grad._data is not g:
            self._grad._data = g
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # ---- host interop -----------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """Blocking copy to the host."""
        return _host(self._data)

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # ---- device movement --------------------------------------------------
    def as_in_context(self, ctx) -> "NDArray":
        if ctx == self.ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), ctx=other)
        if isinstance(other, NDArray):
            other._rebind_out(self._data.to(other._data.device,
                                            other._data.dtype))
            return other
        raise TypeError("copyto expects NDArray or Context")

    def copy(self):
        return NDArray(self._data.clone())

    def astype(self, dtype, copy=True):
        if not copy and dtype_name(dtype) == dtype_name(self._data.dtype):
            return self
        from . import _op_proxy
        return _op_proxy.cast(self, dtype=dtype)

    def tostype(self, stype):
        """A copy in storage ``stype`` (``"default"``, ``"row_sparse"`` or
        ``"csr"``: :mod:`.sparse`)."""
        from .sparse import _to_stype
        return _to_stype(self, stype)

    # ---- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark as a differentiable leaf with a zero gradient (dense
        whatever ``stype`` asks, as the reference's)."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % grad_req)
        self._grad_req = grad_req
        self._leaf = True
        self._pass_grad = {}
        self._data = self._data.detach()
        if grad_req == "null":
            self._grad = None
            return self
        self._data.requires_grad_(True)
        self._data.grad = torch.zeros_like(self._data)
        self._grad = NDArray(self._data.grad)
        _tape.hook_grad_req(self._data, self)
        return self

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ---- mutation ---------------------------------------------------------
    @property
    def _is_leaf(self):
        return self._leaf

    def _set_data(self, val):
        """Rebind to ``val`` (a bound handle copies into its tensor in
        place); a leaf stays a leaf and keeps its gradient."""
        if self._bound:
            with torch.no_grad():
                self._data.copy_(val)
            return
        if not self._leaf:
            self._data = val
            return
        old = self._data
        new = val.detach().clone() if val is old else val.detach()
        if self._grad_req != "null":
            new.requires_grad_(True)
            new.grad = old.grad
            _tape.hook_grad_req(new, self)
        self._data = new

    def _rebind_out(self, val):
        """``out=`` target: rebind (no longer a leaf), or write in place
        when bound."""
        if self._bound:
            self._set_data(val)
        else:
            self._data = val
            self._leaf = False

    def __setitem__(self, key, value):
        from ..ops import _jnp
        if isinstance(value, NDArray):
            v = value._data
        elif isinstance(value, numeric_types):
            v = value
        else:
            v = torch.as_tensor(_np.asarray(value), device=self._data.device)
        if self._bound:
            with torch.no_grad():
                _jnp.setitem(self._data, _canonical_index(key), v)
            return
        if key is None or key is Ellipsis or (isinstance(key, slice) and
                                              key == slice(None)):
            if isinstance(v, numeric_types):
                self._set_data(torch.full_like(self._data, v))
            else:
                self._set_data(v.to(self._data.dtype).expand(
                    self._data.shape).clone())
            return
        new = self._data.clone()
        _jnp.setitem(new, _canonical_index(key), v)
        self._set_data(new)

    def __getitem__(self, key):
        from . import _op_proxy
        return _op_proxy._index(self, key=_canonical_index(key))

    # ---- operators --------------------------------------------------------
    def _binop(self, other, name, reverse=False):
        from . import _op_proxy
        fn = getattr(_op_proxy, name)
        if not isinstance(other, (NDArray,) + numeric_types):
            other = array(other, ctx=self.ctx)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o):
        return self._binop(o, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "subtract")

    def __rsub__(self, o):
        return self._binop(o, "subtract", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "multiply")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "divide")

    def __rtruediv__(self, o):
        return self._binop(o, "divide", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "mod")

    def __rmod__(self, o):
        return self._binop(o, "mod", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "power")

    def __rpow__(self, o):
        return self._binop(o, "power", reverse=True)

    def __matmul__(self, o):
        return self._binop(o, "matmul")

    def __neg__(self):
        return self._binop(-1, "multiply")

    def __abs__(self):
        from . import _op_proxy
        return _op_proxy.abs(self)

    def __eq__(self, o):
        return self._binop(o, "equal")

    def __ne__(self, o):
        return self._binop(o, "not_equal")

    def __lt__(self, o):
        return self._binop(o, "lesser")

    def __le__(self, o):
        return self._binop(o, "lesser_equal")

    def __gt__(self, o):
        return self._binop(o, "greater")

    def __ge__(self, o):
        return self._binop(o, "greater_equal")

    def __hash__(self):
        return id(self)

    def _inplace(self, other, name):
        res = self._binop(other, name)
        if self._leaf or self._bound:
            self._set_data(res._data)
        else:
            self._data = res._data
        return self

    def __iadd__(self, o):
        return self._inplace(o, "add")

    def __isub__(self, o):
        return self._inplace(o, "subtract")

    def __imul__(self, o):
        return self._inplace(o, "multiply")

    def __itruediv__(self, o):
        return self._inplace(o, "divide")

    # ---- shape ops (delegate to op namespace) -----------------------------
    def reshape(self, *shape, **kwargs):
        from . import _op_proxy
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _op_proxy.reshape(self, shape=shape)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        from . import _op_proxy
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _op_proxy.transpose(self, axes=axes if axes else None)

    def swapaxes(self, a1, a2):
        from . import _op_proxy
        return _op_proxy.swapaxes(self, dim1=a1, dim2=a2)

    def expand_dims(self, axis):
        from . import _op_proxy
        return _op_proxy.expand_dims(self, axis=axis)

    def squeeze(self, axis=None):
        from . import _op_proxy
        return _op_proxy.squeeze(self, axis=axis)

    def flatten(self):
        from . import _op_proxy
        return _op_proxy.Flatten(self)

    def broadcast_to(self, shape):
        from . import _op_proxy
        return _op_proxy.broadcast_to(self, shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def slice_axis(self, axis, begin, end):
        from . import _op_proxy
        return _op_proxy.slice_axis(self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        from . import _op_proxy
        return _op_proxy.take(self, indices, axis=axis, mode=mode)

    def tile(self, reps):
        from . import _op_proxy
        return _op_proxy.tile(self, reps=reps)

    def repeat(self, repeats, axis=None):
        from . import _op_proxy
        return _op_proxy.repeat(self, repeats=repeats, axis=axis)

    def pick(self, index, axis=-1, keepdims=False):
        from . import _op_proxy
        return _op_proxy.pick(self, index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        from . import _op_proxy
        return _op_proxy.one_hot(self, depth=depth, on_value=on_value,
                                 off_value=off_value)

    # ---- reductions and elementwise methods -------------------------------
    def _reduce(self, name, axis=None, keepdims=False):
        from . import _op_proxy
        return getattr(_op_proxy, name)(self, axis=axis, keepdims=keepdims)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        from . import _op_proxy
        return _op_proxy.norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from . import _op_proxy
        return _op_proxy.argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from . import _op_proxy
        return _op_proxy.argmin(self, axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        from . import _op_proxy
        return _op_proxy.clip(self, a_min=a_min, a_max=a_max)

    def _unary(self, name):
        from . import _op_proxy
        return getattr(_op_proxy, name)(self)

    def abs(self):
        return self._unary("abs")

    def sqrt(self):
        return self._unary("sqrt")

    def square(self):
        return self._unary("square")

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def relu(self):
        return self._unary("relu")

    def sigmoid(self):
        return self._unary("sigmoid")

    def tanh(self):
        return self._unary("tanh")

    def softmax(self, axis=-1):
        from . import _op_proxy
        return _op_proxy.softmax(self, axis=axis)

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data.detach()))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data.detach()))

    def as_nd_ndarray(self):
        return self

    def as_np_ndarray(self):
        """An ``mx.np.ndarray`` over the same tensor (the autograd link
        survives)."""
        from ..numpy import _as_np
        return _as_np(self)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(map(str, self.shape)), self.ctx)

    # ---- numpy protocol ---------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _canonical_index(key):
    """NDArray parts of an index as tensors (floating ones as int64)."""
    if isinstance(key, NDArray):
        key = key._data
    if isinstance(key, tuple):
        return tuple(_canonical_index(k) for k in key)
    if isinstance(key, torch.Tensor) and key.is_floating_point():
        return key.long()
    return key


# ---- creation -------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` (float64 host data
    becomes float32 unless ``dtype`` says otherwise); a numpy array's
    memory is not shared, even on the CPU."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data.detach().clone()
    elif isinstance(source_array, torch.Tensor):
        source_array = source_array.detach().clone()
    out = NDArray(source_array, ctx=ctx, dtype=dtype)
    if isinstance(source_array, _np.ndarray) and \
            out._data.device.type == "cpu" and \
            out._data.data_ptr() == source_array.ctypes.data:
        out._data = out._data.clone()     # torch.as_tensor shared it
    return out


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    from . import _op_proxy
    return _op_proxy._arange(start, stop, step, repeat, ctx=ctx, dtype=dtype)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    host = _np.eye(N, M if M else N, k=k)
    return NDArray(host, ctx=ctx, dtype=dtype or "float32")


def concat(*arrays, dim=1):
    from . import _op_proxy
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return _op_proxy.concat(*arrays, dim=dim)


def stack(*arrays, axis=0):
    from . import _op_proxy
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return _op_proxy.stack(*arrays, axis=axis)


def from_numpy(a, zero_copy=False):
    return array(a)


def from_dlpack(cap):
    return NDArray(torch.from_dlpack(cap))


def to_dlpack_for_read(arr):
    return arr._data.detach().__dlpack__()


to_dlpack_for_write = to_dlpack_for_read


def waitall():
    """Wait for every queued op on the current device."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---- serialization (reference NDArray::Save/Load, mx.nd.save/load) --------

def save(fname, data):
    """Save an NDArray, a list or a dict of NDArrays in the reference's
    binary list container: files written here load in the reference and
    vice versa."""
    from . import serialization
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        serialization.save_ndarrays(fname, [a._data for a in data])
    elif isinstance(data, dict):
        keys = list(data.keys())
        serialization.save_ndarrays(fname, [data[k]._data for k in keys],
                                    keys)
    else:
        raise TypeError("save expects NDArray, list, or dict")


def load(fname, ctx=None):
    """Load a file written by :func:`save` or by the reference: a dict of
    NDArrays when it holds names, else a list, on ``ctx`` (the current
    context when None)."""
    from . import serialization
    arrays, names = serialization.load_ndarrays(fname)
    if names:
        return {k: NDArray(a, ctx=ctx, dtype=a.dtype)
                for k, a in zip(names, arrays)}
    return [NDArray(a, ctx=ctx, dtype=a.dtype) for a in arrays]
