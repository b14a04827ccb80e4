"""``mx.np``: the NumPy-compatible array frontend.

Counterpart of ``mxnet_tpu/numpy/__init__.py``, which gives ``mx.np`` the
functions of ``jax.numpy`` over the NDArray handles. The port computes
each function with torch ops on the handles' tensors, on their device,
and gives every result the reference's dtype, which is jnp's under x64
(:func:`mxnet_tpu_torch.ops._jnp.result_dtype`): ``ones``, ``zeros``,
``linspace`` and ``eye`` default to float64, ``arange`` of ints to int64,
``array`` of Python data to float32 (bool stays bool); a Python scalar is
weak (``int32 + 1`` is int32, ``int32 + 1.5`` float64); ``sum`` of int32
is int64 and ``mean`` of int32 float32. MXNet 1.6 itself gives float32
for ``np.ones``; the port follows the reference. Float-to-integer casts
saturate and out-of-range gather indices clamp (``x[idx]``) or fill
(``take``, ``take_along_axis``), as in jnp.

:class:`ndarray` is the port's ``NDArray`` with NumPy's methods, ``T``
and indexing. Recording is torch's autograd: a function runs its torch
ops with grad mode on while ``autograd.record()`` records
(:func:`_wrap_record`), so gradients reach ``attach_grad`` leaves through
``mx.np`` as through ``nd``. The functions whose output shape depends on
the values (``nonzero``, ``unique``, ``argwhere``, boolean indexing, ...)
read the count from the device and raise inside a ``CachedOp`` capture.

NumPy's dispatch protocol: ``numpy.sum(a)`` on an ``mx.np`` array calls
this module's ``sum`` (``__array_function__``), and a NumPy ufunc with
``out=`` writes the result into the ``mx.np`` target
(``__array_ufunc__``).
"""
from __future__ import annotations

import builtins
import math

import numpy as _onp
import torch

from .. import _tape
from ..base import dtype_name as _dtype_name
from ..base import dtype_np, torch_dtype as _torch_dtype
from ..context import Context as _Context, current_context
from ..ndarray.ndarray import NDArray as _NDArrayBase
from ..ops import _jnp
from ..ops import core as _ops_core
from ..ops.core import _block_scan, _cbrt, _rounded
from ..ops import numpy_ops as _nops
from ..ops.numpy_ops import _wide
from ..ops.numpy_ops import eager_only as _eager_only

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
euler_gamma = _onp.euler_gamma

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
_np = _onp

_SLOTS = ("_data", "_grad", "_grad_req", "_leaf", "_bound", "_pass_grad",
          "_stype")


# ---- operands and results -------------------------------------------------

def _device(ctx=None):
    return (ctx if isinstance(ctx, _Context) else current_context()) \
        .torch_device


def _host_tensor(a, device):
    """A numpy array (or Python data, as jnp reads it: floats float64,
    ints int64) as a tensor of its dtype on ``device``."""
    a = _onp.array(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(_onp.float32),
                               device=device).bfloat16()
    return torch.as_tensor(a, device=device)


def _unwrap(a, device=None):
    """An operand as a tensor (a Python scalar stays a scalar)."""
    if isinstance(a, _NDArrayBase):
        return a._data
    if isinstance(a, (torch.Tensor, bool, int, float)) or a is None:
        return a
    if isinstance(a, (_onp.ndarray, _onp.generic, list, tuple)):
        return _host_tensor(a, device if device is not None else _device())
    return a


def _first_device(args):
    for a in args:
        if isinstance(a, _NDArrayBase):
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
    return _device()


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return ndarray(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def _wrap_record(name, fn, *arrays):
    """Run ``fn`` on the operands' tensors, with torch's grad mode on while
    ``autograd.record()`` records, and wrap the result(s) as
    :class:`ndarray`. ``name`` names the function in errors."""
    dev = _first_device(arrays)
    vals = [_unwrap(a, dev) for a in arrays]
    with torch.set_grad_enabled(_tape.is_recording()):
        return _wrap(fn(*vals))


def _as_np(arr):
    """``arr`` (an NDArray, or a tuple of them) as :class:`ndarray`
    handles over the same tensors, so the autograd link survives."""
    if isinstance(arr, (tuple, list)):
        return type(arr)(_as_np(a) for a in arr)
    if isinstance(arr, _NDArrayBase) and not isinstance(arr, ndarray):
        out = ndarray.__new__(ndarray)
        for s in _SLOTS:
            setattr(out, s, getattr(arr, s))
        return out
    return arr


def _full(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


def _cast(dt, *xs):
    """Operands in dtype ``dt``: tensors cast, Python scalars made 0-d
    tensors of ``dt`` on the first tensor's device."""
    dev = _first_device(xs)
    return [x.to(dt) if isinstance(x, torch.Tensor) else
            _full(_scalar(x, dt), dt, dev) for x in xs]


def _scalar(x, dt):
    if dt == torch.bool:
        return bool(x)
    if dt.is_floating_point:
        return _rounded(float(x), dt)
    if dt.is_complex:
        return complex(x)
    return int(x)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim if ndim else a for a in axis)
    return (axis % ndim if ndim else axis,)


def _np_dtype(dtype):
    return None if dtype is None else _torch_dtype(dtype)


# ---- the ndarray class ----------------------------------------------------

class ndarray(_NDArrayBase):
    """``mx.np.ndarray``: an NDArray with NumPy semantics."""

    def __repr__(self):
        return "array(%s)" % _onp.array2string(self.asnumpy(),
                                               separator=", ")

    def __getitem__(self, key):
        key = _index_key(self, key)
        return _wrap_record("getitem", lambda v: _jnp.getitem(v, key), self)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    _ARITH = {"add": "add", "subtract": "subtract", "multiply": "multiply",
              "divide": "true_divide", "mod": "remainder", "power": "power",
              "matmul": "matmul"}
    _COMPARE = {"equal": torch.eq, "not_equal": torch.ne,
                "lesser": torch.lt, "lesser_equal": torch.le,
                "greater": torch.gt, "greater_equal": torch.ge}

    def _binop(self, other, name, reverse=False):
        """The reference's operators (its NDArray ops under jnp's rules):
        arithmetic as this module's functions, a comparison 1/0 in the
        left operand's float dtype (float32 for a non-float one)."""
        if not isinstance(other, (_NDArrayBase, bool, int, float)):
            other = asarray(other)
        a, b = (other, self) if reverse else (self, other)
        if name in self._ARITH:
            return globals()[self._ARITH[name]](a, b)
        cmp = self._COMPARE[name]

        def run(x, y):
            dt = _jnp.result_dtype("promote", x, y)
            out_dt = x.dtype if isinstance(x, torch.Tensor) and \
                x.is_floating_point() else torch.float32
            x, y = _cast(dt, x, y)
            return cmp(x, y).to(out_dt)
        return _wrap_record(name, run, a, b)

    def __abs__(self):
        return absolute(self)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return reshape(self, shape)

    def astype(self, dtype, copy=True):
        return _wrap_record("astype", lambda v: _jnp.astype(v, dtype), self)

    def item(self):
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    def as_nd_ndarray(self):
        out = _NDArrayBase.__new__(_NDArrayBase)
        for s in _SLOTS:
            setattr(out, s, getattr(self, s))
        return out

    def as_np_ndarray(self):
        return self

    def __array_function__(self, func, types, args, kwargs):
        fn = globals().get(func.__name__)
        if fn is None:
            mod = globals().get(getattr(func, "__module__", "")
                                .rsplit(".", 1)[-1])
            fn = getattr(mod, func.__name__, None) if mod else None
        if fn is None:
            return NotImplemented
        return fn(*args, **kwargs)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        fn = globals().get(ufunc.__name__)
        if fn is None:
            return NotImplemented
        out = kwargs.pop("out", None)
        result = fn(*inputs, **kwargs)
        if out is None:
            return result
        targets = out if isinstance(out, tuple) else (out,)
        results = result if isinstance(result, tuple) else (result,)
        if len(targets) != len(results) or not builtins.all(
                isinstance(t, _NDArrayBase) for t in targets):
            return NotImplemented
        for t, r in zip(targets, results):
            _tape.assign(t, r._data)
        return targets[0] if len(targets) == 1 else targets

    def _method(name):
        def m(self, *args, **kwargs):
            return globals()[name](self, *args, **kwargs)
        m.__name__ = name
        return m

    for _mname in ("sum", "mean", "std", "var", "prod", "max", "min",
                   "argmax", "argmin", "cumsum", "cumprod", "all", "any",
                   "clip", "round", "take", "repeat", "squeeze", "ravel",
                   "flatten", "swapaxes", "trace", "diagonal", "nonzero",
                   "searchsorted", "dot"):
        locals()[_mname] = _method(_mname)
    del _method, _mname

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes if axes else None)

    @property
    def T(self):
        return self.transpose()

    def copy(self):
        return copy(self)


def _index_key(arr, key):
    """An index in jnp's terms: NDArray parts as tensors, a floating array
    refused, a boolean array eager only (``_jnp.getitem`` then clamps the
    integers and takes negative steps)."""
    key = key if isinstance(key, tuple) else (key,)
    key = tuple(k._data if isinstance(k, _NDArrayBase) else k for k in key)
    key = tuple(_host_tensor(k, arr._data.device)
                if isinstance(k, (list, _onp.ndarray)) else k for k in key)
    used = builtins.sum(k.dim() if isinstance(k, torch.Tensor) and
                        k.dtype == torch.bool else
                        0 if k is None or k is Ellipsis else 1 for k in key)
    out, axis = [], 0
    for k in key:
        if k is Ellipsis:
            axis += arr.ndim - used
        elif k is None:
            pass
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            _eager_only("boolean indexing")
            axis += k.dim()
        elif isinstance(k, torch.Tensor):
            if k.is_floating_point():
                raise TypeError("Indexer must have integer or boolean "
                                "type, got indexer with type %s"
                                % _dtype_name(k.dtype))
            axis += 1
        else:
            axis += 1
        out.append(k)
    return tuple(out)


# ---- creation --------------------------------------------------------------

def array(object, dtype=None, ctx=None):
    """A copy of ``object``: Python data and float64 numpy arrays become
    float32 (bool stays bool), as the reference's ``array``."""
    if isinstance(object, _NDArrayBase):
        out = ndarray(object._data.to(_device(ctx)) if ctx is not None
                      else object._data)
        return out.astype(dtype) if dtype is not None else out
    from_py = not isinstance(object, (_onp.ndarray, torch.Tensor))
    if isinstance(object, torch.Tensor):
        object = object.detach().cpu().numpy()
    a = _onp.array(object, dtype=dtype_np(dtype) if dtype else None)
    if dtype is None and (a.dtype == _onp.float64 or
                          (from_py and a.dtype.kind in "iu")):
        a = a.astype(_onp.float32)
    return ndarray(_host_tensor(a, _device(ctx)))


def asarray(a, dtype=None, ctx=None):
    if isinstance(a, ndarray) and dtype is None:
        return a
    return array(a, dtype=dtype, ctx=ctx)


ascontiguousarray = asarray


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None, ctx=None, **kwargs):
    return ndarray(torch.zeros(_shape(shape), dtype=_np_dtype(dtype)
                                or torch.float64, device=_device(ctx)))


def ones(shape, dtype=None, ctx=None, **kwargs):
    return ndarray(torch.ones(_shape(shape), dtype=_np_dtype(dtype)
                               or torch.float64, device=_device(ctx)))


empty = zeros


def full(shape, fill_value, dtype=None, ctx=None, **kwargs):
    dev = _device(ctx)
    fill = _unwrap(fill_value, dev)
    dt = _np_dtype(dtype) or _jnp.result_dtype("promote", fill)
    if isinstance(fill, torch.Tensor):
        return ndarray(fill.to(dt).expand(_shape(shape)).clone())
    return ndarray(torch.full(_shape(shape), _scalar(fill, dt), dtype=dt,
                               device=dev))


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    """``jnp.arange``: int64 for Python ints, float64 if any bound is a
    float."""
    if stop is None:
        start, stop = 0, start
    dt = _np_dtype(dtype) or _jnp.result_dtype("promote", start, stop, step)
    n = builtins.max(int(math.ceil((stop - start) / step)), 0)
    dev = _device(ctx)
    if not dt.is_floating_point:
        return ndarray(torch.arange(int(start), int(start) + n * int(step),
                                     int(step), device=dev)[:n].to(dt))
    return ndarray((torch.arange(n, dtype=dt, device=dev) *
                     _scalar(step, dt) + _scalar(start, dt)))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    from ..ops.tensor_extra import _linspace
    dt = _np_dtype(dtype) or _jnp.result_dtype("inexact", start, stop)
    v = _linspace.fn(float(start), float(stop), int(num), endpoint,
                  ctx=_Context.from_device(_device(ctx)), dtype=dt)
    if retstep:
        div = (int(num) - 1) if endpoint else int(num)
        return ndarray(v), (stop - start) / div if div > 0 else nan
    return ndarray(v)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None):
    dt = _np_dtype(dtype) or torch.float64
    return ndarray(_nops.logspace.fn(start, stop, num, endpoint, base,
                              ctx=_Context.from_device(_device(ctx)),
                              dtype=dt))


def eye(N, M=None, k=0, dtype=None, ctx=None):
    dev = _device(ctx)
    M = N if M is None else M
    rows = torch.arange(N, device=dev).reshape(-1, 1)
    return ndarray((torch.arange(M, device=dev) - rows == int(k))
                    .to(_np_dtype(dtype) or torch.float64))


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def tri(N, M=None, k=0, dtype=None, ctx=None):
    dev = _device(ctx)
    M = N if M is None else M
    rows = torch.arange(N, device=dev).reshape(-1, 1)
    return ndarray((torch.arange(M, device=dev) <= rows + int(k))
                    .to(_np_dtype(dtype) or torch.float32))


def indices(dimensions, dtype=None, ctx=None):
    return ndarray(_nops._npi_indices.fn(dimensions, dtype or "int64",
                                 ctx=_Context.from_device(_device(ctx))))


def _window(name):
    def fn(M, dtype=None, ctx=None):
        return ndarray(getattr(_nops, "_npi_" + name).fn(
            M, ctx=_Context.from_device(_device(ctx)),
            dtype=dtype or "float32"))
    fn.__name__ = name
    return fn


blackman = _window("blackman")
hamming = _window("hamming")
hanning = _window("hanning")


def bartlett(M, dtype=None, ctx=None):
    dev = _device(ctx)
    if M < 1:
        return ndarray(torch.zeros((0,), dtype=_np_dtype(dtype or "float32"),
                                    device=dev))
    return ndarray(torch.bartlett_window(M, periodic=False,
                                          dtype=torch.float64, device=dev)
                    .to(_np_dtype(dtype or "float32")))


def kaiser(M, beta, dtype=None, ctx=None):
    dev = _device(ctx)
    if M < 1:
        return ndarray(torch.zeros((0,), dtype=_np_dtype(dtype or "float32"),
                                    device=dev))
    if M == 1:
        return ndarray(torch.ones((1,), dtype=_np_dtype(dtype or "float32"),
                                   device=dev))
    n = torch.arange(M, dtype=torch.float64, device=dev)
    alpha = (M - 1) / 2.0
    beta = torch.tensor(float(beta), dtype=torch.float64, device=dev)
    w = torch.special.i0(beta * torch.sqrt(1 - ((n - alpha) / alpha) ** 2)) \
        / torch.special.i0(beta)
    return ndarray(w.to(_np_dtype(dtype or "float32")))


def zeros_like(a, dtype=None, order="C", ctx=None):
    return _wrap_record("zeros_like", lambda v: torch.zeros_like(
        v, dtype=_np_dtype(dtype)), a)


def ones_like(a, dtype=None, order="C", ctx=None):
    return _wrap_record("ones_like", lambda v: torch.ones_like(
        v, dtype=_np_dtype(dtype)), a)


def full_like(a, fill_value, dtype=None, ctx=None):
    def run(v):
        dt = _np_dtype(dtype) or v.dtype
        return torch.full(v.shape, _scalar(fill_value, dt), dtype=dt,
                          device=v.device)
    return _wrap_record("full_like", run, a)


# ---- elementwise: the generated families ----------------------------------

def _inexact_unary(tfn):
    def run(v, *args, **kwargs):
        return tfn(v.to(_jnp.result_dtype("inexact", v)), *args, **kwargs)
    return run


def _identity_if_int(tfn):
    def run(v):
        return tfn(v) if v.is_floating_point() else v.clone()
    return run


def _spacing(v):
    toward = torch.where(v < 0, _full(-inf, v.dtype, v.device),
                         _full(inf, v.dtype, v.device))
    return torch.nextafter(v, toward) - v


def _angle(v):
    """``arctan2(0, v)``: pi where the sign bit is set (-0.0 too), NaN at
    NaN."""
    if not v.is_floating_point():
        v = v.to(torch.float64)
    return torch.where(torch.isnan(v), v, torch.where(
        torch.signbit(v), _full(math.pi, v.dtype, v.device),
        _full(0.0, v.dtype, v.device)))


def _sort(v, axis=-1, kind=None, order=None, stable=True, descending=False):
    if axis is None:
        v, axis = v.reshape(-1), 0
    out = torch.sort(v, dim=axis, stable=True, descending=descending).values
    return out


def _argsort(v, axis=-1, kind=None, order=None, stable=True,
             descending=False):
    if axis is None:
        v, axis = v.reshape(-1), 0
    return torch.argsort(v, dim=axis, stable=True, descending=descending)


def _argwhere(v):
    _eager_only("argwhere")
    return torch.nonzero(v)


def _flatnonzero(v):
    _eager_only("flatnonzero")
    return torch.nonzero(v.reshape(-1)).reshape(-1)


def _rint(v):
    if not v.is_floating_point():
        return v.to(torch.float64)
    return torch.round(v)


def _square(v):
    v = v.to(_jnp.result_dtype("numeric", v))
    return v * v


def _invert(v):
    return torch.logical_not(v) if v.dtype == torch.bool else \
        torch.bitwise_not(v)


def _abs(v):
    return v.clone() if v.dtype == torch.bool else torch.abs(v)


_UNARY_FNS = {
    "abs": _abs, "absolute": _abs, "sign": _ops_core.sign.fn,
    "sqrt": _inexact_unary(torch.sqrt), "cbrt": _inexact_unary(_cbrt),
    "square": _square, "exp": _inexact_unary(torch.exp),
    "expm1": _inexact_unary(torch.expm1), "log": _inexact_unary(torch.log),
    "log2": _inexact_unary(torch.log2), "log10": _inexact_unary(torch.log10),
    "log1p": _inexact_unary(torch.log1p), "sin": _inexact_unary(torch.sin),
    "cos": _inexact_unary(torch.cos), "tan": _inexact_unary(torch.tan),
    "arcsin": _inexact_unary(torch.asin),
    "arccos": _inexact_unary(torch.acos),
    "arctan": _inexact_unary(torch.atan),
    "sinh": _inexact_unary(torch.sinh), "cosh": _inexact_unary(torch.cosh),
    "tanh": _inexact_unary(torch.tanh),
    "arcsinh": _inexact_unary(torch.asinh),
    "arccosh": _inexact_unary(torch.acosh),
    "arctanh": _inexact_unary(torch.atanh),
    "floor": _identity_if_int(torch.floor),
    "ceil": _identity_if_int(torch.ceil),
    "trunc": _identity_if_int(torch.trunc),
    "fix": _identity_if_int(torch.trunc), "rint": _rint,
    "negative": torch.neg, "positive": lambda v: v.clone(),
    "reciprocal": _inexact_unary(torch.reciprocal),
    "degrees": _inexact_unary(torch.rad2deg),
    "radians": _inexact_unary(torch.deg2rad),
    "deg2rad": _inexact_unary(torch.deg2rad),
    "rad2deg": _inexact_unary(torch.rad2deg),
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "isposinf": torch.isposinf, "isneginf": torch.isneginf,
    "logical_not": torch.logical_not, "signbit": torch.signbit,
    "iscomplex": lambda v: torch.zeros(v.shape, dtype=torch.bool,
                                       device=v.device),
    "isreal": lambda v: torch.ones(v.shape, dtype=torch.bool,
                                   device=v.device),
    "sort": _sort, "argsort": _argsort, "copy": lambda v, order=None:
    v.clone(), "conj": lambda v: v.clone(), "conjugate": lambda v: v.clone(),
    "real": lambda v: v.clone(), "imag": torch.zeros_like, "angle": _angle,
    "exp2": _inexact_unary(torch.exp2), "invert": _invert,
    "bitwise_not": _invert, "sinc": _inexact_unary(torch.sinc),
    "i0": _inexact_unary(lambda v: torch.special.i0(_wide(v)).to(v.dtype)),
    "fabs": _inexact_unary(torch.abs), "spacing": _inexact_unary(_spacing),
    "argwhere": _argwhere, "flatnonzero": _flatnonzero,
}

_UNARY = ["abs", "absolute", "sign", "sqrt", "cbrt", "square", "exp",
          "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
          "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
          "arccosh", "arctanh", "floor", "ceil", "trunc", "rint", "fix",
          "negative", "reciprocal", "degrees", "radians", "isnan", "isinf",
          "isfinite", "logical_not", "sort", "argsort", "copy", "conj",
          "real", "imag", "angle", "exp2", "positive", "invert",
          "signbit", "sinc", "i0", "isposinf", "isneginf", "iscomplex",
          "isreal", "bitwise_not", "conjugate", "fabs", "spacing",
          "argwhere", "flatnonzero"]


def _make_unary(name):
    tfn = _UNARY_FNS[name]

    def fn(x, *args, **kwargs):
        kwargs.pop("out", None)
        return _wrap_record(name, lambda v: tfn(v, *args, **kwargs), x)
    fn.__name__ = name
    return fn


for _n in _UNARY:
    globals()[_n] = _make_unary(_n)
deg2rad = _make_unary("deg2rad")
rad2deg = _make_unary("rad2deg")


def _promoted(rule, tfn, result=None):
    """A binary function: both operands cast to ``rule``'s dtype of the
    pair, then ``tfn`` (its result cast to ``result`` when given)."""
    def run(a, b, *args, **kwargs):
        dt = _jnp.result_dtype(rule, a, b)
        a, b = _cast(dt, a, b)
        out = tfn(a, b, *args, **kwargs)
        return out.to(result) if result is not None else out
    return run


def _remainder(a, b):
    """``remainder``; an integer one by zero gives 0 (XLA's), where torch
    raises."""
    if a.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a),
                       torch.remainder(a, torch.where(zero, torch.ones_like(b),
                                                      b)))


def _floor_divide(a, b):
    """``floor_divide``; a float one by ±0 gives NaN (jnp's ``fmod``-based
    quotient), an integer one XLA's values (-1, or -2 for a nonzero
    dividend; the largest value unsigned)."""
    if a.is_floating_point():
        return torch.where(b == 0, _full(float("nan"), a.dtype, a.device),
                           torch.floor_divide(a, b))
    zero = b == 0
    q = torch.floor_divide(a, torch.where(zero, torch.ones_like(b), b))
    info = torch.iinfo(a.dtype) if a.dtype != torch.bool else None
    by0 = torch.full_like(a, info.max) if info is not None and \
        info.min == 0 else -1 - (a != 0).to(a.dtype)
    return torch.where(zero, by0, q)


def _fmod(a, b):
    if a.is_floating_point():
        return torch.fmod(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a),
                       torch.fmod(a, torch.where(zero, torch.ones_like(b), b)))


def _power(a, b):
    if isinstance(b, int) and not isinstance(b, bool) and \
            isinstance(a, torch.Tensor):
        a = a.to(_jnp.result_dtype("numeric", a))
        return torch.pow(a, b)
    return _promoted("numeric", torch.pow)(a, b)


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() == 1 and b.dim() <= 2:
        return torch.matmul(a, b) if a.dtype != torch.bool else \
            torch.matmul(a.int(), b.int()).bool()
    return torch.tensordot(a, b, dims=([-1], [-2]))


def _matmul(a, b):
    if a.dtype == torch.bool:
        return torch.matmul(a.int(), b.int()) > 0
    return torch.matmul(a, b)


def _inner(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dtype == torch.bool:
        return torch.tensordot(a.int(), b.int(), dims=([-1], [-1])) > 0
    return torch.tensordot(a, b, dims=([-1], [-1]))


def _vdot(a, b):
    a, b = a.reshape(-1), b.reshape(-1)
    if a.dtype == torch.bool:
        return torch.dot(a.int(), b.int()) > 0
    return torch.dot(a, b)


def _heaviside(x, h):
    """jnp's ``where(x < 0, 0, where(x > 0, 1, h))``: NaN gives ``h``."""
    return torch.where(x < 0, torch.zeros_like(x),
                       torch.where(x > 0, torch.ones_like(x), h))


def _shift(tfn):
    """A shift on integers (booleans shift as int32, the result type)."""
    return _promoted("numeric", tfn)


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.movedim(a, axisa, -1), torch.movedim(b, axisb, -1)
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b), -1, axisc)


def _polyval(p, x):
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def _conv_full(a, v):
    """numpy's full 1-D convolution (``conv1d`` is a correlation)."""
    k = v.shape[0]
    wide = a.dtype if a.is_floating_point() else torch.float64
    out = torch.nn.functional.conv1d(
        a.to(wide).reshape(1, 1, -1), torch.flip(v.to(wide), (0,))
        .reshape(1, 1, -1), padding=k - 1)
    return out.reshape(-1).to(a.dtype)


def _trim_mode(full, n_a, n_v, mode):
    n = builtins.max(n_a, n_v)
    m = builtins.min(n_a, n_v)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    return full[m - 1:n]


def _convolve(a, v, mode="full", precision=None, preferred_element_type=None):
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    return _trim_mode(_conv_full(a, v), a.shape[0], v.shape[0], mode)


def _correlate(a, v, mode="valid", precision=None,
               preferred_element_type=None):
    swap = a.shape[0] < v.shape[0]
    x, y = (v, a) if swap else (a, v)
    out = _trim_mode(_conv_full(x, torch.flip(y, (0,))), x.shape[0],
                     y.shape[0], mode)
    return torch.flip(out, (0,)) if swap else out


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _take_along_axis(arr, idx, axis, mode=None, fill_value=None):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    return _jnp.take_fill(arr, idx, axis)


def _ldexp(a, b):
    if isinstance(b, torch.Tensor) and b.is_floating_point():
        raise ValueError("ldexp: the exponent must be an integer array")
    dev = _first_device((a, b))
    a = a if isinstance(a, torch.Tensor) else _full(
        a, _jnp.result_dtype("promote", a), dev)
    b = b if isinstance(b, torch.Tensor) else _full(int(b), torch.int64,
                                                    dev)
    return _nops._ldexp(a, b)


_BINARY_FNS = {
    "add": _promoted("promote", torch.add),
    "subtract": _promoted("promote", torch.sub),
    "multiply": _promoted("promote", torch.mul),
    "divide": _promoted("inexact", torch.true_divide),
    "true_divide": _promoted("inexact", torch.true_divide),
    "mod": _promoted("numeric", _remainder),
    "remainder": _promoted("numeric", _remainder),
    "power": _power, "float_power": _promoted("inexact", torch.pow),
    "maximum": _promoted("promote", torch.maximum),
    "minimum": _promoted("promote", torch.minimum),
    "hypot": _promoted("inexact", torch.hypot),
    "arctan2": _promoted("inexact", torch.atan2),
    "logaddexp": _promoted("inexact", torch.logaddexp),
    "logaddexp2": _promoted("inexact", torch.logaddexp2),
    "copysign": _promoted("inexact", torch.copysign),
    "fmod": _promoted("numeric", _fmod),
    "fmax": _promoted("promote", torch.fmax),
    "fmin": _promoted("promote", torch.fmin),
    "equal": _promoted("promote", torch.eq),
    "not_equal": _promoted("promote", torch.ne),
    "greater": _promoted("promote", torch.gt),
    "greater_equal": _promoted("promote", torch.ge),
    "less": _promoted("promote", torch.lt),
    "less_equal": _promoted("promote", torch.le),
    "logical_and": _promoted("promote", torch.logical_and),
    "logical_or": _promoted("promote", torch.logical_or),
    "logical_xor": _promoted("promote", torch.logical_xor),
    "bitwise_and": _promoted("promote", torch.bitwise_and),
    "bitwise_or": _promoted("promote", torch.bitwise_or),
    "bitwise_xor": _promoted("promote", torch.bitwise_xor),
    "left_shift": _shift(torch.bitwise_left_shift),
    "right_shift": _shift(torch.bitwise_right_shift),
    "matmul": _promoted("promote", _matmul),
    "dot": _promoted("promote", _dot),
    "vdot": _promoted("promote", _vdot),
    "outer": _promoted("promote", _outer),
    "inner": _promoted("promote", _inner),
    "cross": _promoted("promote", _cross),
    "kron": _promoted("promote", torch.kron),
    "gcd": _promoted("promote", torch.gcd),
    "lcm": _promoted("promote", torch.lcm),
    "heaviside": _promoted("inexact", _heaviside),
    "ldexp": _ldexp,
    "floor_divide": _promoted("numeric", _floor_divide),
    "nextafter": _promoted("inexact", torch.nextafter),
    "polyval": _promoted("inexact", _polyval),
    "convolve": _promoted("inexact", _convolve),
    "correlate": _promoted("inexact", _correlate),
    "isclose": _promoted("promote", _isclose),
    "take_along_axis": lambda a, i, *args, **kw: _take_along_axis(
        a, i, *args, **kw),
}

_BINARY = ["add", "subtract", "multiply", "divide", "true_divide", "mod",
           "remainder", "power", "float_power", "maximum", "minimum",
           "hypot", "arctan2", "logaddexp", "copysign", "fmod", "fmax",
           "fmin", "equal", "not_equal", "greater", "greater_equal", "less",
           "less_equal", "logical_and", "logical_or", "logical_xor",
           "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
           "right_shift", "matmul", "dot", "outer", "inner", "cross",
           "kron", "gcd", "lcm", "heaviside", "ldexp", "floor_divide",
           "nextafter", "logaddexp2", "polyval", "convolve", "correlate",
           "isclose", "take_along_axis"]


def _make_binary(name):
    tfn = _BINARY_FNS[name]

    def fn(a, b, *args, **kwargs):
        kwargs.pop("out", None)
        return _wrap_record(name, lambda x, y: tfn(x, y, *args, **kwargs),
                            a, b)
    fn.__name__ = name
    return fn


for _n in _BINARY:
    globals()[_n] = _make_binary(_n)
vdot = _make_binary("vdot")


# ---- reductions and the other axis functions ------------------------------

def _reduce_dims(v, axis, keepdims, fn):
    """``fn(v, dim)`` over each axis of ``axis`` (one at a time, from the
    last: for torch reductions that take one dim)."""
    axes = sorted(_axes(axis, v.dim()), reverse=True)
    if axis is None:
        out = fn(v.reshape(-1), 0) if v.dim() else fn(v.reshape(1), 0)
        return out.reshape((1,) * v.dim()) if keepdims else out
    for d in axes:
        v = fn(v, d)
        if keepdims:
            v = v.unsqueeze(d)
    return v


def _sum(v, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None, promote_integers=True):
    dt = _np_dtype(dtype) or _jnp.result_dtype("sum", v)
    acc = torch.int64 if not dt.is_floating_point and dt not in (
        torch.bool, torch.uint64) else (torch.float32 if dt in (
            torch.float16, torch.bfloat16) else dt)
    if dt == torch.uint64:
        acc = torch.int64
    w = v.to(acc)
    res = w.sum() if axis is None else w.sum(dim=_axes(axis, v.dim()),
                                            keepdim=keepdims)
    if axis is None and keepdims:
        res = res.reshape((1,) * v.dim())
    if initial is not None:
        res = res + initial
    return res.to(dt)


def _prod(v, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None, promote_integers=True):
    dt = _np_dtype(dtype) or _jnp.result_dtype("sum", v)
    acc = torch.int64 if not dt.is_floating_point else _wide(
        torch.empty((), dtype=dt)).dtype
    res = _reduce_dims(v.to(acc), axis, keepdims,
                       lambda t, d: torch.prod(t, dim=d))
    if initial is not None:
        res = res * initial
    return res.to(dt)


def _mean(v, axis=None, dtype=None, out=None, keepdims=False, where=None):
    dt = _np_dtype(dtype) or _jnp.result_dtype("inexact", v)
    w = _wide(v.to(dt))
    res = w.mean() if axis is None else w.mean(dim=_axes(axis, v.dim()),
                                               keepdim=keepdims)
    if axis is None and keepdims:
        res = res.reshape((1,) * v.dim())
    return res.to(dt)


def _moment(fn):
    def run(v, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None, mean=None, correction=None):
        return _nops._moment(fn, v, axis, dtype,
                             ddof if correction is None else correction,
                             keepdims)
    return run


def _extreme(tfn):
    def run(v, axis=None, out=None, keepdims=False, initial=None,
            where=None):
        w = v.to(torch.uint8) if v.dtype == torch.bool else v
        res = tfn(w) if axis is None else tfn(w, dim=_axes(axis, v.dim()),
                                               keepdim=keepdims)
        if axis is None and keepdims:
            res = res.reshape((1,) * v.dim())
        return res.to(v.dtype)
    return run


def _arg_extreme(tfn):
    def run(v, axis=None, out=None, keepdims=False):
        if v.dtype == torch.bool:
            v = v.to(torch.uint8)
        if axis is None:
            res = tfn(v.reshape(-1), 0)
            return res.reshape((1,) * v.dim()) if keepdims else res
        return tfn(v, axis, keepdim=keepdims)
    return run


def _accumulate(tfn):
    def run(v, axis=None, dtype=None, out=None):
        dt = _np_dtype(dtype) or _jnp.result_dtype("accumulate", v)
        if axis is None:
            v, axis = v.reshape(-1), 0
        if tfn is torch.cumsum and dt.is_floating_point and v.shape[axis]:
            return _block_scan(v.to(dt), axis % v.dim())
        return tfn(v.to(dt), axis, dtype=dt)
    return run


def _logical_reduce(tfn):
    def run(v, axis=None, out=None, keepdims=False, where=None):
        w = v.bool()
        if axis is None:
            res = tfn(w)
            return res.reshape((1,) * v.dim()) if keepdims else res
        return _reduce_dims(w, axis, keepdims, lambda t, d: tfn(t, dim=d))
    return run


def _quantile_core(v, q, axis, keepdims, nan_aware):
    dt = _jnp.result_dtype("inexact", v)
    w = _wide(v.to(dt))
    qt = torch.as_tensor(q, dtype=w.dtype, device=w.device)
    fn = torch.nanquantile if nan_aware else torch.quantile
    if axis is None:
        res = fn(w.reshape(-1), qt)
        if keepdims:
            res = res.reshape(res.shape + (1,) * v.dim())
        return res.to(dt)
    axes = _axes(axis, v.dim())
    if len(axes) > 1:
        rest = [d for d in range(v.dim()) if d not in axes]
        moved = w.permute(rest + list(axes)).reshape(
            [v.shape[d] for d in rest] + [-1])
        res = fn(moved, qt, dim=-1)
        if keepdims:
            for d in sorted(axes):
                res = res.unsqueeze(d + (qt.dim()))
        return res.to(dt)
    return fn(w, qt, dim=axes[0], keepdim=keepdims).to(dt)


def _quantile(nan_aware, scale=1.0):
    def run(v, q, axis=None, out=None, overwrite_input=False,
            method="linear", keepdims=False, **kw):
        if isinstance(q, torch.Tensor):
            q = q / scale
        else:
            q = _onp.asarray(q, dtype=_onp.float64) / scale
        return _quantile_core(v, q, axis, keepdims, nan_aware)
    return run


def _median(nan_aware):
    def run(v, axis=None, out=None, overwrite_input=False, keepdims=False):
        return _quantile_core(v, 0.5, axis, keepdims, nan_aware)
    return run


def _nan_filled(v, fill):
    if not v.is_floating_point():
        return v
    return torch.where(torch.isnan(v), _full(fill, v.dtype, v.device), v)


def _nansum(v, axis=None, dtype=None, out=None, keepdims=False, **kw):
    return _sum(_nan_filled(v, 0.0), axis, dtype, keepdims=keepdims)


def _nanprod(v, axis=None, dtype=None, out=None, keepdims=False, **kw):
    return _prod(_nan_filled(v, 1.0), axis, dtype, keepdims=keepdims)


def _nanmean(v, axis=None, dtype=None, out=None, keepdims=False, **kw):
    dt = _np_dtype(dtype) or _jnp.result_dtype("inexact", v)
    w = _wide(v.to(dt))
    dims = None if axis is None else _axes(axis, v.dim())
    res = torch.nanmean(w, dim=dims, keepdim=keepdims)
    if axis is None and keepdims:
        res = res.reshape((1,) * v.dim())
    return res.to(dt)


def _nanmoment(take_sqrt):
    def run(v, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **kw):
        dt = _np_dtype(dtype) or _jnp.result_dtype("inexact", v)
        w = _wide(v.to(dt))
        dims = tuple(range(w.dim())) if axis is None else \
            _axes(axis, v.dim())
        ok = ~torch.isnan(w)
        n = ok.sum(dim=dims, keepdim=True)
        mean = torch.where(ok, w, 0).sum(dim=dims, keepdim=True) / n
        dev = torch.where(ok, w - mean, 0)
        res = (dev * dev).sum(dim=dims, keepdim=True) / (n - ddof)
        if take_sqrt:
            res = torch.sqrt(res)
        if not keepdims:
            res = res.reshape([s for i, s in enumerate(res.shape)
                               if i not in dims])
        return res.to(dt)
    return run


def _nanextreme(tfn, fill):
    base = _extreme(tfn)

    def run(v, axis=None, out=None, keepdims=False, **kw):
        if not v.is_floating_point():
            return base(v, axis, keepdims=keepdims)
        res = base(_nan_filled(v, fill), axis, keepdims=keepdims)
        allnan = _extreme(torch.amin)(torch.isnan(v), axis,
                                      keepdims=keepdims)
        return torch.where(allnan, _full(nan, v.dtype, v.device), res)
    return run


def _nanarg(tfn, fill):
    base = _arg_extreme(tfn)

    def run(v, axis=None, out=None, keepdims=False):
        return base(_nan_filled(v, fill), axis, keepdims=keepdims)
    return run


def _nanaccumulate(tfn, fill):
    base = _accumulate(tfn)

    def run(v, axis=None, dtype=None, out=None):
        return base(_nan_filled(v, fill), axis, dtype)
    return run


def _ptp(v, axis=None, out=None, keepdims=False):
    return _extreme(torch.amax)(v, axis, keepdims=keepdims) - \
        _extreme(torch.amin)(v, axis, keepdims=keepdims)


def _count_nonzero(v, axis=None, keepdims=False):
    return _sum(v != 0, axis, keepdims=keepdims).to(torch.int64)


def _average(v, axis=None, weights=None, returned=False, keepdims=False):
    if weights is None:
        avg = _mean(v, axis, keepdims=keepdims)
        if returned:
            count = v.numel() if axis is None else int(_onp.prod(
                [v.shape[d] for d in _axes(axis, v.dim())]))
            return avg, torch.full_like(avg, count)
        return avg
    dt = _jnp.result_dtype("inexact", v, weights)
    w = weights.to(dt)
    if axis is not None and w.dim() == 1 and v.dim() > 1:
        shape = [1] * v.dim()
        shape[_axes(axis, v.dim())[0]] = -1
        w = w.reshape(shape)
    total = _sum(v.to(dt) * w, axis, keepdims=keepdims)
    scl = _sum(torch.broadcast_to(w, v.shape).to(dt), axis,
               keepdims=keepdims)
    avg = total / scl
    return (avg, scl) if returned else avg


def _transpose(v, axes=None):
    return v.permute(tuple(axes)) if axes is not None else \
        v.permute(tuple(reversed(range(v.dim()))))


def _squeeze(v, axis=None):
    if axis is None:
        return v.squeeze()
    for d in _axes(axis, v.dim()):
        if v.shape[d] != 1:
            raise ValueError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
    return v.squeeze(_axes(axis, v.dim()))


def _expand_dims(v, axis):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    n = v.dim() + len(axes)
    for d in sorted(a % n for a in axes):
        v = v.unsqueeze(d)
    return v


def _flip(v, axis=None):
    return torch.flip(v, _axes(axis, v.dim()))


def _roll(v, shift, axis=None):
    if axis is None:
        return torch.roll(v.reshape(-1), shift).reshape(v.shape)
    return torch.roll(v, shift, axis)


def _rot90(v, k=1, axes=(0, 1)):
    return torch.rot90(v, int(k), [int(a) for a in axes])


def _tile(v, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(v, reps)


def _repeat(v, repeats, axis=None, total_repeat_length=None):
    if isinstance(repeats, torch.Tensor):
        _eager_only("repeat with an array of counts")
    if axis is None:
        v, axis = v.reshape(-1), 0
    return torch.repeat_interleave(v, repeats, dim=axis)


def _unique(v, return_index=False, return_inverse=False,
            return_counts=False, axis=None, **kw):
    return _nops.unique.fn(v, return_index, return_inverse, return_counts,
                           axis)


def _diff(v, n=1, axis=-1, prepend=None, append=None):
    return torch.diff(v, n=n, dim=axis, prepend=prepend, append=append)


def _clip(v, a_min=None, a_max=None, out=None, min=None, max=None):
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    dt = _jnp.result_dtype("promote", v, lo, hi)
    w = v.to(dt)
    if lo is not None:
        w = torch.maximum(w, _cast(dt, lo)[0].to(w.device))
    if hi is not None:
        w = torch.minimum(w, _cast(dt, hi)[0].to(w.device))
    return w


def _round(v, decimals=0, out=None):
    if not v.is_floating_point():
        if v.dtype == torch.bool:
            raise ValueError("round of a boolean array")
        return v.clone()
    return torch.round(v, decimals=int(decimals))


def _reshape(v, shape=None, order="C", newshape=None, copy=None):
    shape = newshape if shape is None else shape
    return v.reshape(_shape(shape))


def _rollaxis(v, axis, start=0):
    axis %= v.dim()
    start = start % (v.dim() + 1) if start < 0 else start
    if axis < start:
        start -= 1
    return torch.movedim(v, axis, start)


def _atleast(n):
    def run(*vs):
        outs = []
        for v in vs:
            if n == 1:
                outs.append(v.reshape(1) if v.dim() == 0 else v)
            elif n == 2:
                outs.append(v.reshape(1, 1) if v.dim() == 0 else
                            v.reshape(1, -1) if v.dim() == 1 else v)
            else:
                outs.append(v.reshape(1, 1, 1) if v.dim() == 0 else
                            v.reshape(1, -1, 1) if v.dim() == 1 else
                            v.unsqueeze(-1) if v.dim() == 2 else v)
        return outs[0] if len(outs) == 1 else outs
    return run


def _trace(v, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    out = _nops.trace.fn(v, offset, axis1, axis2)
    return out.to(_np_dtype(dtype)) if dtype is not None else out


def _diag(v, k=0):
    return torch.diag(v, k)


def _tri_mask(fn):
    def run(v, k=0):
        return fn(v, int(k))
    return run


def _nonzero(v, size=None, fill_value=None):
    _eager_only("nonzero")
    return tuple(torch.nonzero(v, as_tuple=True)) if v.dim() else \
        (torch.nonzero(v.reshape(1)).reshape(-1),)


def _searchsorted(a, v, side="left", sorter=None, method=None):
    if sorter is not None:
        a = a[sorter]
    vv = v if isinstance(v, torch.Tensor) else _full(v, a.dtype, a.device)
    dt = _jnp.result_dtype("promote", a, vv)
    return torch.searchsorted(a.to(dt).contiguous(), vv.to(dt).contiguous(),
                              side=side).to(torch.int32)


def _partition(v, kth, axis=-1):
    """``jnp.partition``: the ``kth + 1`` smallest ascending, then the
    others descending."""
    w = torch.movedim(v, axis, -1)
    n, kth = w.shape[-1], int(kth)
    low = torch.sort(w, dim=-1, stable=True).values[..., :kth + 1]
    high = torch.sort(w, dim=-1, stable=True, descending=True) \
        .values[..., :n - kth - 1]
    return torch.movedim(torch.cat([low, high], -1), -1, axis)


def _argpartition(v, kth, axis=-1):
    """``jnp.argpartition``: the indices of the ``kth + 1`` smallest
    (ascending), then the other indices in increasing order."""
    w = torch.movedim(v, axis, -1)
    n, kth = w.shape[-1], int(kth)
    low = torch.argsort(w, dim=-1, stable=True)[..., :kth + 1]
    rest = torch.ones(w.shape, device=w.device).scatter(-1, low, 0.0)
    high = torch.argsort(rest, dim=-1, stable=True,
                         descending=True)[..., :n - kth - 1]
    return torch.movedim(torch.cat([low, high], -1), -1, axis) \
        .to(torch.int32)


def _pad_width(pad_width, ndim):
    pw = _onp.asarray(pad_width, dtype=_onp.int64)
    return _onp.broadcast_to(pw.reshape(-1, 2) if pw.size > 1 and
                             pw.ndim > 0 else pw.reshape(1, 1)
                             .repeat(2, axis=1), (ndim, 2))


def _pad(v, pad_width, mode="constant", **kwargs):
    """``numpy.pad``: ``constant`` (``constant_values``) or a mode that
    only moves values (``edge``, ``reflect``, ``symmetric``, ``wrap``),
    whose source index along each axis comes from numpy on the shape."""
    pw = _pad_width(pad_width, v.dim())
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        out = torch.full([s + int(a) + int(b) for s, (a, b)
                          in zip(v.shape, pw)], _scalar(
                              _onp.asarray(cv).reshape(-1)[0], v.dtype),
                         dtype=v.dtype, device=v.device)
        sl = tuple(slice(int(a), int(a) + s) for s, (a, _) in
                   zip(v.shape, pw))
        return out.index_put(tuple(torch.arange(
            s.start, s.stop, device=v.device).reshape(
                [-1 if j == i else 1 for j in range(v.dim())])
            for i, s in enumerate(sl)), v) if v.dim() else v.clone()
    for d, (a, b) in enumerate(pw):
        if a == 0 and b == 0:
            continue
        src = _onp.pad(_onp.arange(v.shape[d]), (int(a), int(b)), mode=mode)
        v = torch.index_select(v, d, torch.as_tensor(src, device=v.device))
    return v


def _take(a, indices, axis=None, out=None, mode=None, unique_indices=False,
          indices_are_sorted=False, fill_value=None):
    if isinstance(indices, torch.Tensor) and indices.is_floating_point():
        raise ValueError("indices must have an integer type")
    idx = indices if isinstance(indices, torch.Tensor) else \
        _full(int(indices), torch.int64, a.device)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    flat = idx.reshape(-1).long()
    if mode in ("clip",):
        sel = flat.clamp(0, n - 1)
        got = torch.index_select(a, axis, sel)
    elif mode in ("wrap",):
        got = torch.index_select(a, axis, flat % n)
    else:
        safe, ok = _jnp.scatter_mask(flat, n)
        got = torch.index_select(a, axis, safe)
        shape = [1] * a.dim()
        shape[axis] = -1
        got = torch.where(ok.reshape(shape), got,
                          _full(_jnp.fill_value(a.dtype), a.dtype, a.device))
    return got.reshape(a.shape[:axis] + tuple(idx.shape) +
                       a.shape[axis + 1:])


def _compress(condition, a, axis=None, out=None, **kw):
    _eager_only("compress")
    if axis is None:
        a, axis = a.reshape(-1), 0
    c = condition.bool().reshape(-1)
    idx = torch.nonzero(c[:a.shape[axis]]).reshape(-1)
    return torch.index_select(a, axis, idx)


def _positions(obj, n, device):
    if isinstance(obj, slice):
        return torch.arange(n, device=device)[obj]
    if isinstance(obj, torch.Tensor):
        return obj.long().reshape(-1)
    return torch.as_tensor(_onp.asarray(obj, dtype=_onp.int64).reshape(-1),
                           device=device)


def _delete(arr, obj, axis=None, **kw):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    pos = _positions(obj, n, arr.device)
    keep[torch.where(pos < 0, pos + n, pos)] = False
    _eager_only("delete")
    return torch.index_select(arr, axis, torch.nonzero(keep).reshape(-1))


def _insert(arr, obj, values, axis=None):
    """``jnp.insert``: the new slices' positions are the (clipped)
    indices, each shifted past the earlier insertions; the old slices
    fill the rest in order."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.dim()
    n = arr.shape[axis]
    dev = arr.device
    vals = values.to(arr.dtype) if isinstance(values, torch.Tensor) else \
        torch.as_tensor(_onp.asarray(values), device=dev).to(arr.dtype)
    idx = _positions(obj, n, dev)
    if idx.numel() == 1:
        if not isinstance(obj, (slice, list, tuple)) and not (
                isinstance(obj, torch.Tensor) and obj.dim()) and \
                vals.dim() > axis:
            vals = torch.movedim(vals, 0, axis)
        count = vals.shape[axis] if vals.dim() > axis else 1
        idx = idx.reshape(-1)[:1].expand(count)
    k = idx.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n)
    order = torch.argsort(idx, stable=True)
    new_at = idx.clone()
    new_at[order] += torch.arange(k, device=dev)
    keep = torch.ones(n + k, dtype=torch.bool, device=dev)
    keep[new_at] = False
    old_at = torch.nonzero(keep).reshape(-1)
    shape = list(arr.shape)
    shape[axis] = k
    out_shape = list(arr.shape)
    out_shape[axis] = n + k
    out = torch.zeros(out_shape, dtype=arr.dtype, device=dev)
    out.index_copy_(axis, new_at, torch.broadcast_to(vals, shape))
    return out.index_copy(axis, old_at, arr)


def _append(arr, values, axis=None):
    dt = _jnp.result_dtype("promote", arr, values)
    vals = values if isinstance(values, torch.Tensor) else \
        _full(_scalar(values, dt), dt, arr.device).reshape(1)
    if axis is None:
        return torch.cat([arr.reshape(-1).to(dt), vals.reshape(-1).to(dt)])
    return torch.cat([arr.to(dt), vals.to(dt)], axis)


def _resize(a, new_shape):
    shape = _shape(new_shape)
    total = int(_onp.prod(shape)) if shape else 1
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-total // flat.numel())
    return flat.repeat(reps)[:total].reshape(shape)


def _trim_zeros(filt, trim="fb"):
    _eager_only("trim_zeros")
    nz = torch.nonzero(filt).reshape(-1)
    if nz.numel() == 0:
        return filt[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else filt.shape[0]
    return filt[lo:hi]


def _ediff1d(ary, to_end=None, to_begin=None):
    if ary.dtype == torch.bool:
        raise TypeError("sub does not accept dtype bool")
    d = torch.diff(ary.reshape(-1))
    parts = [d]
    if to_begin is not None:
        parts.insert(0, torch.as_tensor(to_begin, dtype=d.dtype,
                                        device=d.device).reshape(-1))
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, dtype=d.dtype,
                                     device=d.device).reshape(-1))
    return torch.cat(parts)


def _bincount(x, weights=None, minlength=0, length=None):
    if length is None:
        _eager_only("bincount")
        length = builtins.max(int(x.max()) + 1 if x.numel() else 0,
                              int(minlength))
    idx, ok = _jnp.scatter_mask(x.reshape(-1), length)
    w = weights.reshape(-1) if weights is not None else \
        torch.ones(idx.shape, dtype=torch.int64, device=x.device)
    w = torch.where(ok, w, torch.zeros((), dtype=w.dtype, device=w.device))
    out = torch.zeros(length, dtype=w.dtype, device=x.device)
    return out.scatter_add(0, idx, w)


def _digitize(x, bins, right=False, method=None):
    dt = _jnp.result_dtype("promote", x, bins)
    x, bins = x.to(dt), bins.to(dt)
    side = "left" if right else "right"
    if bins.shape[0] > 1 and bool(bins[-1] < bins[0]):
        flipped = torch.flip(bins, (0,))
        out = bins.shape[0] - torch.searchsorted(
            flipped.contiguous(), x.contiguous(),
            side="right" if right else "left")
    else:
        out = torch.searchsorted(bins.contiguous(), x.contiguous(),
                                 side=side)
    return out.to(torch.int32)


def _bin_edges(a, bins, range_, dt):
    from ..ops.tensor_extra import _spaced
    w = a.to(dt)
    if range_ is None:
        lo, hi = w.min(), w.max()
    else:
        lo = _full(float(range_[0]), dt, a.device)
        hi = _full(float(range_[1]), dt, a.device)
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    return torch.cat([_spaced(lo, hi, int(bins), dt, a.device),
                      hi.reshape(1)])


def _histogram_bin_edges(a, bins=10, range=None, weights=None):
    if isinstance(bins, torch.Tensor):
        return bins
    return _bin_edges(a, bins, range, _jnp.result_dtype("inexact", a))


def _histogram(a, bins=10, range=None, weights=None, density=None):
    dt = _jnp.result_dtype("inexact", a)
    edges = bins.to(dt) if isinstance(bins, torch.Tensor) else \
        _bin_edges(a, bins, range, dt)
    flat = a.reshape(-1).to(dt)
    idx = torch.searchsorted(edges.contiguous(), flat.contiguous(),
                             side="right")
    idx = torch.where(flat == edges[-1], edges.shape[0] - 1, idx)
    w = weights.reshape(-1).to(dt) if weights is not None else \
        torch.ones(flat.shape, dtype=dt, device=a.device)
    ok = idx < edges.shape[0]
    counts = torch.zeros(edges.shape[0], dtype=dt, device=a.device)
    counts = counts.scatter_add(0, idx.clamp(max=edges.shape[0] - 1),
                                torch.where(ok, w, torch.zeros_like(w)))[1:]
    if density:
        counts = counts / (torch.diff(edges) * counts.sum())
    return counts, edges


def _gradient(f, *varargs, axis=None, edge_order=None):
    dt = _jnp.result_dtype("inexact", f)
    w = f.to(dt)
    axes = _axes(axis, w.dim())
    outs = []
    for i, d in enumerate(axes):
        h = float(varargs[i] if len(varargs) > 1 else varargs[0]) \
            if varargs else 1.0
        n = w.shape[d]
        h2, h1 = _full(2 * h, dt, w.device), _full(h, dt, w.device)
        inner = (w.narrow(d, 2, n - 2) - w.narrow(d, 0, n - 2)) / h2
        first = (w.narrow(d, 1, 1) - w.narrow(d, 0, 1)) / h1
        last = (w.narrow(d, n - 1, 1) - w.narrow(d, n - 2, 1)) / h1
        outs.append(torch.cat([first, inner, last], d))
    return outs[0] if len(outs) == 1 else outs


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None):
    dt = _jnp.result_dtype("inexact", m)
    x = m.to(dt)
    x = x.reshape(1, -1) if x.dim() == 1 else x
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = y.to(dt)
        yy = yy.reshape(1, -1) if yy.dim() == 1 else yy
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat([x, yy], 0)
    if ddof is None:
        ddof = 0 if bias else 1
    c = torch.cov(_wide(x), correction=int(ddof)).to(dt)
    return c.squeeze()


def _corrcoef(x, y=None, rowvar=True):
    c = _cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    c = c / d[:, None] / d[None, :]
    return torch.clamp(c, -1, 1)


def _unwrap_fn(p, discont=None, axis=-1, period=2 * math.pi):
    dt = p.dtype if p.is_floating_point() else torch.float64
    w = p.to(dt)
    dd = torch.diff(w, dim=axis)
    half = period / 2
    discont = half if discont is None else builtins.max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        _full(half, dt, p.device), ddmod)
    corr = torch.where(dd.abs() < discont, _full(0.0, dt, p.device),
                       ddmod - dd)
    zero = torch.zeros_like(w.narrow(axis, 0, 1))
    return w + torch.cat([zero, torch.cumsum(corr, axis)], axis)


def _interp(x, xp, fp, left=None, right=None, period=None):
    dt = _jnp.result_dtype("inexact", x, xp, fp)
    x, xp, fp = x.to(dt), xp.to(dt), fp.to(dt)
    n = xp.shape[0]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(),
                           side="right").clamp(1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(_onp.spacing(_onp.finfo(dtype_np(dt)).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else
                    _full(float(left), dt, x.device), f)
    return torch.where(x > xp[-1], fp[-1] if right is None else
                       _full(float(right), dt, x.device), f)


def _unravel_index(indices, shape):
    shape = _shape(shape)
    out = []
    rest = indices.long()
    total = int(_onp.prod(shape)) if shape else 1
    rest = rest.clamp(-total, total - 1)
    rest = torch.where(rest < 0, rest + total, rest)
    for s in reversed(shape):
        out.append(torch.remainder(rest, s).to(indices.dtype))
        rest = torch.div(rest, s, rounding_mode="floor")
    return tuple(reversed(out))


def _nan_to_num(v, copy=True, nan=0.0, posinf=None, neginf=None):
    return _nops.nan_to_num.fn(v, copy, nan, posinf, neginf)


def _diagonal(v, offset=0, axis1=0, axis2=1):
    return torch.diagonal(v, offset, axis1, axis2)


_AXIS_IMPL = {
    "sum": _sum, "mean": _mean, "std": _moment(torch.std),
    "var": _moment(torch.var), "prod": _prod,
    "max": _extreme(torch.amax), "min": _extreme(torch.amin),
    "amax": _extreme(torch.amax), "amin": _extreme(torch.amin),
    "argmax": _arg_extreme(torch.argmax),
    "argmin": _arg_extreme(torch.argmin),
    "cumsum": _accumulate(torch.cumsum),
    "cumprod": _accumulate(torch.cumprod),
    "all": _logical_reduce(torch.all), "any": _logical_reduce(torch.any),
    "median": _median(False), "quantile": _quantile(False),
    "percentile": _quantile(False, 100.0), "nanmean": _nanmean,
    "nansum": _nansum, "transpose": _transpose, "squeeze": _squeeze,
    "expand_dims": _expand_dims, "ravel": lambda v, order="C":
    v.reshape(-1), "flip": _flip, "flipud": lambda v: torch.flip(v, (0,)),
    "fliplr": lambda v: torch.flip(v, (1,)), "roll": _roll,
    "rot90": _rot90, "tile": _tile, "repeat": _repeat, "unique": _unique,
    "diff": _diff, "clip": _clip, "around": _round, "round": _round,
    "reshape": _reshape, "swapaxes": lambda v, a, b: v.transpose(a, b),
    "moveaxis": lambda v, s, d: torch.movedim(v, s, d),
    "rollaxis": _rollaxis, "broadcast_to": lambda v, s:
    torch.broadcast_to(v, _shape(s)), "atleast_1d": _atleast(1),
    "atleast_2d": _atleast(2), "atleast_3d": _atleast(3),
    "trace": _trace, "diagonal": _diagonal, "diag": _diag,
    "tril": _tri_mask(torch.tril), "triu": _tri_mask(torch.triu),
    "nonzero": _nonzero, "count_nonzero": _count_nonzero,
    "searchsorted": _searchsorted, "partition": _partition,
    "argpartition": _argpartition, "pad": _pad, "average": _average,
    "nan_to_num": _nan_to_num, "take": _take, "compress": _compress,
    "delete": _delete, "insert": _insert, "append": _append,
    "resize": _resize, "trim_zeros": _trim_zeros, "ediff1d": _ediff1d,
    "bincount": _bincount, "digitize": _digitize, "histogram": _histogram,
    "nanstd": _nanmoment(True), "nanvar": _nanmoment(False),
    "nanmin": _nanextreme(torch.amin, inf),
    "nanmax": _nanextreme(torch.amax, -inf),
    "nanargmin": _nanarg(torch.argmin, inf),
    "nanargmax": _nanarg(torch.argmax, -inf), "nanprod": _nanprod,
    "nancumsum": _nanaccumulate(torch.cumsum, 0.0),
    "nancumprod": _nanaccumulate(torch.cumprod, 1.0),
    "nanmedian": _median(True), "nanquantile": _quantile(True),
    "nanpercentile": _quantile(True, 100.0), "ptp": _ptp,
    "gradient": _gradient, "cov": _cov, "corrcoef": _corrcoef,
    "unwrap": _unwrap_fn, "interp": _interp,
    "unravel_index": _unravel_index,
    "histogram_bin_edges": _histogram_bin_edges,
}

_AXIS_FNS = ["sum", "mean", "std", "var", "prod", "max", "min", "amax",
             "amin", "argmax", "argmin", "cumsum", "cumprod", "all", "any",
             "median", "quantile", "percentile", "nanmean", "nansum",
             "transpose", "squeeze", "expand_dims", "ravel", "flip",
             "flipud", "fliplr", "roll", "rot90", "tile", "repeat", "unique",
             "diff", "clip", "around", "round", "reshape", "swapaxes",
             "moveaxis", "rollaxis", "broadcast_to", "atleast_1d",
             "atleast_2d", "atleast_3d", "trace", "diagonal", "diag",
             "tril", "triu", "nonzero", "count_nonzero", "searchsorted",
             "partition", "argpartition", "pad", "average", "nan_to_num",
             "take", "compress", "delete", "insert", "append", "resize",
             "trim_zeros", "ediff1d", "bincount", "digitize", "histogram",
             "nanstd", "nanvar", "nanmin", "nanmax", "nanargmin",
             "nanargmax", "nanprod", "nancumsum", "nancumprod",
             "nanmedian", "nanquantile", "nanpercentile", "ptp",
             "gradient", "cov", "corrcoef", "unwrap", "interp",
             "unravel_index", "histogram_bin_edges"]


def _make_axis_fn(name):
    tfn = _AXIS_IMPL[name]

    def fn(a, *args, **kwargs):
        kwargs.pop("out", None)
        dev = _first_device((a,) + args)
        extra = [_unwrap(x, dev) if isinstance(x, (_NDArrayBase,
                                                   _onp.ndarray))
                 else x for x in args]
        kw = {k: _unwrap(v, dev) if isinstance(v, (_NDArrayBase,
                                                   _onp.ndarray)) else v
              for k, v in kwargs.items()}
        return _wrap_record(name, lambda v: tfn(v, *extra, **kw), a)
    fn.__name__ = name
    return fn


for _n in _AXIS_FNS:
    globals()[_n] = _make_axis_fn(_n)
del _n


# ---- the explicit functions -----------------------------------------------

def _joined(name, tfn):
    def fn(seq, *args, **kwargs):
        kwargs.pop("out", None)
        seq = list(seq)

        def run(*vs):
            dt = _jnp.result_dtype("promote", *vs)
            return tfn([v.to(dt) for v in vs], *args, **kwargs)
        return _wrap_record(name, run, *seq)
    fn.__name__ = name
    return fn


def _concat(vs, axis=0):
    if axis is None:
        return torch.cat([v.reshape(-1) for v in vs])
    return torch.cat(vs, axis)


concatenate = _joined("concatenate", _concat)
stack = _joined("stack", lambda vs, axis=0: torch.stack(vs, axis))
vstack = _joined("vstack", lambda vs: torch.vstack(vs))
hstack = _joined("hstack", lambda vs: torch.hstack(vs))
dstack = _joined("dstack", lambda vs: torch.dstack(vs))
column_stack = _joined("column_stack", lambda vs: torch.column_stack(vs))


def _splits(v, indices_or_sections, axis, equal):
    n = v.shape[axis]
    if isinstance(indices_or_sections, int):
        if equal and n % indices_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(v, indices_or_sections, dim=axis))
    return tuple(torch.tensor_split(v, [int(i) for i in
                                        indices_or_sections], dim=axis))


def split(ary, indices_or_sections, axis=0):
    return _wrap_record("split", lambda v: _splits(
        v, indices_or_sections, axis, True), ary)


def array_split(ary, indices_or_sections, axis=0):
    return _wrap_record("array_split", lambda v: _splits(
        v, indices_or_sections, axis, False), ary)


def hsplit(ary, indices_or_sections):
    return _wrap_record("hsplit", lambda v: _splits(
        v, indices_or_sections, 1 if v.dim() > 1 else 0, True), ary)


def vsplit(ary, indices_or_sections):
    return _wrap_record("vsplit", lambda v: _splits(
        v, indices_or_sections, 0, True), ary)


def dsplit(ary, indices_or_sections):
    return _wrap_record("dsplit", lambda v: _splits(
        v, indices_or_sections, 2, True), ary)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)

    def run(c, a, b):
        dt = _jnp.result_dtype("promote", a, b)
        a, b = _cast(dt, a, b)
        return torch.where(c.bool(), a, b)
    return _wrap_record("where", run, condition, x, y)


def einsum(subscripts, *operands, **kwargs):
    def run(*vs):
        dt = _jnp.result_dtype("promote", *vs)
        return torch.einsum(subscripts, *[v.to(dt) for v in vs])
    return _wrap_record("einsum", run, *operands)


def tensordot(a, b, axes=2):
    def run(x, y):
        dt = _jnp.result_dtype("promote", x, y)
        return torch.tensordot(x.to(dt), y.to(dt), dims=axes)
    return _wrap_record("tensordot", run, a, b)


def meshgrid(*xi, **kwargs):
    indexing = kwargs.get("indexing", "xy")
    return _wrap_record("meshgrid", lambda *vs: tuple(
        torch.meshgrid(*vs, indexing=indexing)), *xi)


def may_share_memory(a, b, max_work=None):
    return False


def shares_memory(a, b, max_work=None):
    return False


def asnumpy(a):
    return a.asnumpy()


def isscalar(x):
    return _onp.isscalar(x)


def result_type(*arrays_and_dtypes):
    return _onp.result_type(*[a.dtype if isinstance(a, _NDArrayBase) else a
                              for a in arrays_and_dtypes])


def broadcast_arrays(*args):
    return _wrap_record("broadcast_arrays", lambda *vs: tuple(
        torch.broadcast_tensors(*vs)), *args)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(isclose(a, b, rtol, atol, equal_nan).all().item())


def array_equal(a1, a2, equal_nan=False):
    if tuple(a1.shape) != tuple(a2.shape):
        return False
    return bool(equal(a1, a2).all().item())


def set_printoptions(*args, **kwargs):
    _onp.set_printoptions(*args, **kwargs)


def genfromtxt(*args, **kwargs):
    return array(_onp.genfromtxt(*args, **kwargs))


def flatten(a, order="C"):
    return _wrap_record("flatten", lambda v: v.reshape(-1), a)


def ndim(a):
    v = _unwrap(a)
    return v.dim() if isinstance(v, torch.Tensor) else _onp.ndim(v)


def shape(a):
    v = _unwrap(a)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else _onp.shape(v)


def size(a, axis=None):
    s = shape(a)
    if axis is None:
        n = 1
        for d in s:
            n *= d
        return n
    return s[axis]


def isin(element, test_elements, assume_unique=False, invert=False):
    def run(v, t):
        dt = _jnp.result_dtype("promote", v, t)
        if dt == torch.bool:         # torch.isin takes no booleans
            dt = torch.uint8
        return torch.isin(v.to(dt), t.to(dt), invert=invert)
    return _wrap_record("isin", run, element, test_elements)


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(ar1, ar2, invert=invert).reshape(-1)


def _to_host(a):
    return a.asnumpy() if isinstance(a, _NDArrayBase) else _onp.asarray(a)


def _host_set(fn, ar1, ar2, *args):
    """A set routine of numpy (value-dependent output shape; the
    reference computes it on the host too)."""
    _eager_only(fn.__name__)
    dev = _first_device((ar1, ar2))
    out = fn(_to_host(ar1), _to_host(ar2), *args)
    if isinstance(out, tuple):
        return tuple(ndarray(_host_tensor(o, dev)) for o in out)
    return ndarray(_host_tensor(out, dev))


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    return _host_set(_onp.intersect1d, ar1, ar2, assume_unique,
                     return_indices)


def union1d(ar1, ar2):
    return _host_set(_onp.union1d, ar1, ar2)


def setdiff1d(ar1, ar2, assume_unique=False):
    return _host_set(_onp.setdiff1d, ar1, ar2, assume_unique)


def setxor1d(ar1, ar2, assume_unique=False):
    return _host_set(_onp.setxor1d, ar1, ar2, assume_unique)


def tril_indices(n, k=0, m=None):
    idx = torch.tril_indices(n, n if m is None else m, k, device=_device())
    return ndarray(idx[0]), ndarray(idx[1])


def triu_indices(n, k=0, m=None):
    idx = torch.triu_indices(n, n if m is None else m, k, device=_device())
    return ndarray(idx[0]), ndarray(idx[1])


def diag_indices(n, ndim=2):
    i = torch.arange(n, device=_device())
    return tuple(ndarray(i) for _ in range(ndim))


def vander(x, N=None, increasing=False):
    def run(v):
        n = v.shape[0] if N is None else int(N)
        p = torch.arange(n, device=v.device)
        if not increasing:
            p = torch.flip(p, (0,))
        return v[:, None] ** p[None, :].to(v.dtype)
    return _wrap_record("vander", run, x)


def put_along_axis(arr, indices, values, axis):
    """``arr`` takes ``values`` at ``indices`` along ``axis``, in place
    (an index in ``[-n, 0)`` wraps; one outside ``[-n, n)`` is dropped, as
    jnp's scatter drops it)."""
    def run(v, idx, val):
        n = v.shape[axis]
        safe, ok = _jnp.scatter_mask(idx, n)
        val = torch.broadcast_to(val.to(v.dtype) if isinstance(
            val, torch.Tensor) else _full(_scalar(val, v.dtype), v.dtype,
                                          v.device), idx.shape)
        cur = torch.gather(v, axis, safe)
        return v.scatter(axis, safe, torch.where(ok, val, cur))
    new = _wrap_record("put_along_axis", run, arr, indices, values)
    _tape.assign(arr, new._data)
    return None


def fromfunction(function, shape, dtype=float, ctx=None, **kwargs):
    return array(_onp.fromfunction(function, shape, dtype=dtype, **kwargs),
                 ctx=ctx)


def frombuffer(buffer, dtype=float, count=-1, offset=0):
    return array(_onp.frombuffer(buffer, dtype, count, offset))


def copyto(dst, src, casting="same_kind", where=True):
    """``numpy.copyto`` into an ``mx.np`` target (in place)."""
    def run(d, s, w):
        s = s.to(d.dtype) if isinstance(s, torch.Tensor) else \
            _full(_scalar(s, d.dtype), d.dtype, d.device)
        w = w.bool() if isinstance(w, torch.Tensor) else bool(w)
        return torch.where(torch.as_tensor(w, device=d.device),
                           torch.broadcast_to(s, d.shape), d)
    new = _wrap_record("copyto", run, dst, src, where)
    _tape.assign(dst, new._data)
    return None


def divmod(x1, x2):  # noqa: A001 - numpy's name
    return floor_divide(x1, x2), mod(x1, x2)  # noqa: F821


def modf(x):
    def run(v):
        v = v.to(_jnp.result_dtype("inexact", v))
        whole = torch.trunc(v)
        return v - whole, whole
    return _wrap_record("modf", run, x)


def frexp(x):
    def run(v):
        m, ex = torch.frexp(v.to(_jnp.result_dtype("inexact", v)))
        return m, ex.to(torch.int32)
    return _wrap_record("frexp", run, x)


current_context = current_context
dtype_np = dtype_np

from . import random  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
