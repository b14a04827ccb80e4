"""Core tensor operators: elementwise, broadcast, reduce, shape, indexing,
ordering and linear algebra.

Counterpart of ``mxnet_tpu/ops/core.py``, whole: every name it registers,
and every alias that the reference's other files register onto its
functions (the ``_npi_``/``_np_``/``_npx_`` spellings of its numpy
frontends, the CamelCase ``_Plus`` ... ``_Power`` family, ``less``,
``_linalg_*``, ``SparseEmbedding``). Each op is a short function over
torch tensors with the reference op's name, arguments and result dtypes
(comparisons and logical ops give 1.0/0.0 in the input's floating type,
or float32; ``argmax``/``argsort``/``topk`` float32 indices unless
``dtype`` says otherwise; ``one_hot`` float32), and the sequence ops the
recurrent cells use. Where jnp rounds differently from the obvious torch
call, the function follows jnp: constants rounded to the dtype, XLA's
``lgamma``/``digamma`` sums, the total order of ``lax.top_k`` and
``jnp.sort``, and XLA's addition order in ``cumsum``. On the card they
are stock torch ops (cuBLAS, cuSOLVER for ``linalg_*``), as XLA's were
in the reference.
"""
from __future__ import annotations

import builtins
import functools

import numpy as _np
import torch

from ..base import torch_dtype
from . import _jnp
from .registry import register, register_alias

# ---------------------------------------------------------------- arithmetic


@register("add", aliases=("broadcast_add", "broadcast_plus", "elemwise_add",
                          "_plus", "_add"))
def add(lhs, rhs):
    return lhs + rhs


@register("subtract", aliases=("broadcast_sub", "broadcast_minus",
                               "elemwise_sub", "_sub", "_minus"))
def subtract(lhs, rhs):
    return lhs - rhs


@register("multiply", aliases=("broadcast_mul", "elemwise_mul", "_mul"))
def multiply(lhs, rhs):
    return lhs * rhs


@register("divide", aliases=("broadcast_div", "elemwise_div", "_div"))
def divide(lhs, rhs):
    return lhs / rhs


@register("mod", aliases=("broadcast_mod",))
def mod(lhs, rhs):
    return lhs % rhs


@register("power", aliases=("broadcast_power", "_power"))
def power(lhs, rhs):
    return lhs ** rhs


def _tensors(lhs, rhs):
    """Both operands as tensors (a Python scalar takes the other's device
    and floating dtype)."""
    if not isinstance(lhs, torch.Tensor):
        lhs = torch.as_tensor(lhs, device=rhs.device,
                              dtype=rhs.dtype if rhs.is_floating_point()
                              else None)
    if not isinstance(rhs, torch.Tensor):
        rhs = torch.as_tensor(rhs, device=lhs.device,
                              dtype=lhs.dtype if lhs.is_floating_point()
                              else None)
    return lhs, rhs


@register("maximum", aliases=("broadcast_maximum", "_maximum"))
def maximum(lhs, rhs):
    return torch.maximum(*_tensors(lhs, rhs))


@register("minimum", aliases=("broadcast_minimum", "_minimum"))
def minimum(lhs, rhs):
    return torch.minimum(*_tensors(lhs, rhs))


@register("negative")
def negative(x):
    return -x


@register("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register("sign")
def sign(x):
    """``sign`` as jnp's: NaN stays NaN and a signed zero keeps its sign
    (``torch.sign`` gives +0 for both)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x.detach(), torch.sign(x))


@register("relu")
def relu(x):
    """``maximum(x, 0)`` as XLA computes it: -0.0 gives +0.0 and NaN stays
    NaN (``torch.relu`` keeps the sign of -0.0)."""
    return torch.where(x <= 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


for _name, _fn in (
        ("abs", torch.abs), ("round", torch.round),
        ("ceil", torch.ceil), ("floor", torch.floor), ("trunc", torch.trunc),
        ("square", torch.square), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("exp", torch.exp), ("log", torch.log),
        ("log10", torch.log10), ("log2", torch.log2),
        ("log1p", torch.log1p), ("expm1", torch.expm1),
        ("erf", torch.erf), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan), ("arcsin", torch.asin),
        ("arccos", torch.acos), ("arctan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh)):
    register(_name)(_fn)
del _name, _fn

# ------------------------------------------------------------- comparisons


def _res_dtype(lhs, rhs):
    for x in (lhs, rhs):
        if isinstance(x, torch.Tensor):
            return x.dtype if x.is_floating_point() else torch.float32
    return torch.float32


def _compare(name, aliases, fn):
    def op(lhs, rhs):
        return fn(*_tensors(lhs, rhs)).to(_res_dtype(lhs, rhs))
    op.__name__ = name
    register(name, aliases=aliases)(op)


for _name, _aliases, _fn in (
        ("equal", ("broadcast_equal", "_equal"), torch.eq),
        ("not_equal", ("broadcast_not_equal", "_not_equal"), torch.ne),
        ("greater", ("broadcast_greater", "_greater"), torch.gt),
        ("greater_equal", ("broadcast_greater_equal", "_greater_equal"),
         torch.ge),
        ("lesser", ("broadcast_lesser", "_lesser"), torch.lt),
        ("lesser_equal", ("broadcast_lesser_equal", "_lesser_equal"),
         torch.le)):
    _compare(_name, _aliases, _fn)
del _name, _aliases, _fn


@register("where")
def where(condition, x, y):
    x, y = _tensors(x, y)
    return torch.where(condition.bool(), x, y)


# ---------------------------------------------------------------- reductions


def _axes(axis, ndim, exclude=False):
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _reduce(fn, data, axis, keepdims, exclude=False):
    axes = _axes(axis, data.dim(), exclude)
    if axes is None:
        out = fn(data.reshape(-1), 0)
        return out.reshape((1,) * data.dim()) if keepdims else out
    if len(axes) == 0:
        return data
    return fn(data, axes, keepdim=keepdims)


@register("sum", aliases=("sum_axis",))
def sum(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    return _reduce(torch.sum, data, axis, keepdims, exclude)


@register("mean")
def mean(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.mean, data, axis, keepdims, exclude)


@register("prod")
def prod(data, axis=None, keepdims=False, exclude=False):
    axes = _axes(axis, data.dim(), exclude)
    if axes is None:
        out = torch.prod(data.reshape(-1))
        return out.reshape((1,) * data.dim()) if keepdims else out
    for a in sorted((a % data.dim() for a in axes), reverse=True):
        data = torch.prod(data, a, keepdim=keepdims)
    return data


@register("max", aliases=("max_axis",))
def max(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    return _reduce(torch.amax, data, axis, keepdims, exclude)


@register("min", aliases=("min_axis",))
def min(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    return _reduce(torch.amin, data, axis, keepdims, exclude)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    if ord == 1:
        return sum.fn(torch.abs(data), axis, keepdims)
    return torch.sqrt(sum.fn(torch.square(data), axis, keepdims))


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    return torch.argmax(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return torch.argmin(data, dim=axis, keepdim=keepdims).to(torch.float32)


# ------------------------------------------------------------- shape manip


def _mx_reshape(src, spec, reverse=False):
    """MXNet reshape spec: 0 copy dim, -1 infer, -2 copy rest, -3 merge two,
    -4 split (the reference's ``_mx_reshape``)."""
    if reverse:
        src = src[::-1]
        spec = spec[::-1]
    out, i, j = [], 0, 0
    spec = list(spec)
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(int(s))
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False):
    return data.reshape(_mx_reshape(tuple(data.shape), tuple(shape), reverse))


@register("transpose")
def transpose(data, axes=None):
    axes = tuple(axes) if axes else tuple(range(data.dim() - 1, -1, -1))
    return data.permute(axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


@register("expand_dims")
def expand_dims(data, axis=0):
    """``jnp.expand_dims``: a tuple ``axis`` inserts an axis at each of
    its positions in the result."""
    if isinstance(axis, int):
        return data.unsqueeze(axis)
    rank = data.dim() + len(axis)
    shape = iter(data.shape)
    new = {a % rank for a in axis}
    return data.reshape(tuple(1 if i in new else next(shape)
                              for i in range(rank)))


@register("squeeze")
def squeeze(data, axis=None):
    """``jnp.squeeze``: an ``axis`` whose size is not 1 raises
    ``ValueError`` (torch would leave it)."""
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if data.shape[a] != 1:
            raise ValueError(
                "cannot select an axis to squeeze out which has size not "
                "equal to one, got shape=%s and dimensions=%s"
                % (tuple(data.shape), axes))
    return data.squeeze(axes)


@register("Flatten", aliases=("flatten",))
def Flatten(data):
    return data.reshape(data.shape[0], -1)


@register("broadcast_to")
def broadcast_to(data, shape=None):
    shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return data.expand(tuple(shape))


@register("concat", aliases=("Concat",))
def concat(*data, dim=1, num_args=None):
    return torch.cat(data, dim=dim)


@register("_rnn_param_concat", aliases=("_npi_rnn_param_concat",))
def _rnn_param_concat(*args, dim=0, num_args=None):
    """``concat`` of an RNN's flattened parameters (the reference's
    ``ops/tensor_extra.py``)."""
    return torch.cat(args, dim=int(dim))


@register("stack")
def stack(*data, axis=0, num_args=None):
    return torch.stack(data, dim=axis)


@register("split", aliases=("SliceChannel",), n_out=0)
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    parts = torch.chunk(data, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("slice", aliases=("crop",))
def slice(data, begin=(), end=(), step=()):  # noqa: A001
    step = step or [None] * len(begin)
    idx = tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))
    return _jnp.getitem(data, idx)


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    idx = [builtins.slice(None)] * data.dim()
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    idx = [builtins.slice(None)] * data.dim()
    for a in (axes or range(data.dim())):
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("tile")
def tile(data, reps=()):
    return data.tile(tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    if axis is None:
        return data.reshape(-1).repeat_interleave(repeats)
    return data.repeat_interleave(repeats, dim=axis)


@register("flip", aliases=("reverse",))
def flip(data, axis=()):
    return torch.flip(data, (axis,) if isinstance(axis, int) else tuple(axis))


# ---------------------------------------------------------------- indexing


def _index_key(key):
    """Floating index tensors become int64 (a float NDArray used as an
    index, as MXNet allows)."""
    if isinstance(key, torch.Tensor):
        return key if not key.is_floating_point() else key.long()
    if isinstance(key, tuple):
        return tuple(_index_key(k) for k in key)
    return key


@register("_index")
def _index(data, key=None):
    """``data[key]`` as jnp reads it: integers clamp into their axis,
    negative steps are taken (:func:`._jnp.getitem`)."""
    return _jnp.getitem(data, _index_key(key))


@register("take")
def take(a, indices, axis=0, mode="clip"):
    idx = indices.long()
    n = a.shape[axis]
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = a.shape[:axis % a.dim()] + tuple(indices.shape) + \
        a.shape[axis % a.dim() + 1:]
    return out.reshape(shape)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("gather_nd")
def gather_nd(data, indices):
    return data[tuple(indices.long())]


@register("one_hot")
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    idx = indices.long()
    valid = (idx >= 0) & (idx < depth)
    oh = torch.nn.functional.one_hot(idx.clamp(0, depth - 1), depth)
    oh = (oh * valid.unsqueeze(-1)).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("embedding", aliases=("Embedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    return weight[data.long()]


# ---------------------------------------------------------------- sequences
# ``axis`` is the time axis (0 or 1); the batch axis is the other one.
# Without ``use_sequence_length`` (or a length) each op takes every step.


def _steps_mask(data, sequence_length, axis):
    """``(T, B)``-broadcastable bool mask of the steps before each
    sequence's length, shaped like ``data`` with 1s elsewhere."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    steps = torch.arange(data.shape[axis], device=data.device).reshape(shape)
    lshape = [1] * data.dim()
    batch_axis = 1 if axis == 0 else 0
    lshape[batch_axis] = data.shape[batch_axis]
    return steps < sequence_length.reshape(lshape)


@register("SequenceMask", aliases=("sequence_mask",
                                   "_npx_sequence_mask"))
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """The steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    fill = torch.full((), value, dtype=data.dtype, device=data.device)
    return torch.where(_steps_mask(data, sequence_length, axis), data, fill)


@register("SequenceLast")
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each sequence's last valid step (the last step without lengths).
    With lengths the reference takes axis 0 only (on axis 1 its
    ``take_along_axis`` index does not fit and it raises); the port takes
    either."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    last = (sequence_length.long() - 1).reshape(
        (-1,) + (1,) * (data.dim() - 2))
    t_first = data if axis == 0 else data.transpose(0, 1)
    idx = last.unsqueeze(0).expand((1,) + tuple(t_first.shape[1:]))
    return torch.gather(t_first, 0, idx).squeeze(0)


@register("SequenceReverse")
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """Each sequence's first ``length`` steps reversed in place, the rest
    kept (the whole time axis flipped without lengths). With lengths the
    reference reverses along axis 0 whatever ``axis`` says; the port
    follows ``axis``."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    t_first = data if axis == 0 else data.transpose(0, 1)
    T = t_first.shape[0]
    steps = torch.arange(T, device=data.device).unsqueeze(1)     # (T, 1)
    sl = sequence_length.long().reshape(1, -1)                   # (1, B)
    rev = torch.where(steps < sl, sl - 1 - steps, steps)         # (T, B)
    rev = rev.reshape(rev.shape + (1,) * (t_first.dim() - 2)) \
        .expand(t_first.shape)
    out = torch.gather(t_first, 0, rev)
    return out if axis == 0 else out.transpose(0, 1)


# ---------------------------------------------------------------- init-like


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("_arange", aliases=("_contrib_arange",), differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype=None):
    """The reference's ``_arange`` op; the NDArray constructor ``arange``
    takes the same arguments and a ``ctx``. The values are ``jnp.arange``'s,
    computed in the result's dtype (float32 unless asked), not float64
    values cast."""
    from ..context import Context, current_context
    if stop is None:
        start, stop = 0, start
    ctx = ctx if isinstance(ctx, Context) else current_context()
    tdt = torch_dtype(dtype)
    host = _np.float32 if tdt == torch.bfloat16 \
        else torch.empty((), dtype=tdt).numpy().dtype
    out = torch.as_tensor(_np.arange(start, stop, step, dtype=host),
                          device=ctx.torch_device).to(tdt)
    return out.repeat_interleave(repeat) if repeat > 1 else out


@register("cast", aliases=("Cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("identity", aliases=("_copy",))
def identity(data):
    return data


@register("stop_gradient", aliases=("BlockGrad",))
def stop_gradient(data):
    return data.detach()


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` holds a (before, after) pair per axis, from the first;
    ``mode`` is ``constant``, ``edge`` or ``reflect`` (the last two pad
    only the trailing axes, as the reference's callers do)."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    while pairs and pairs[0] == (0, 0) and mode != "constant":
        pairs.pop(0)
    flat = tuple(w for p in reversed(pairs) for w in p)
    if mode == "constant":
        return torch.nn.functional.pad(data, flat, value=constant_value)
    torch_mode = {"edge": "replicate", "reflect": "reflect"}[mode]
    return torch.nn.functional.pad(data, flat, mode=torch_mode)


@register("clip")
def clip(data, a_min=None, a_max=None):
    """``jnp.clip``: with neither bound the input comes back as it is."""
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


# ---------------------------------------------------------------- linalg


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.t() if transpose_a else lhs
    b = rhs.t() if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([-1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("matmul")
def matmul(lhs, rhs):
    return torch.matmul(lhs, rhs)


# ------------------------------------------------------- scalar arithmetic
# the names ``Symbol`` arithmetic emits (``x + 1.0`` is ``_plus_scalar``),
# with the reference's CamelCase spellings


@register("_plus_scalar", aliases=("_PlusScalar",))
def _plus_scalar(data, scalar=0.0):
    return data + scalar


@register("_minus_scalar", aliases=("_MinusScalar",))
def _minus_scalar(data, scalar=0.0):
    return data - scalar


@register("_rminus_scalar", aliases=("_RMinusScalar",))
def _rminus_scalar(data, scalar=0.0):
    return scalar - data


@register("_mul_scalar", aliases=("_MulScalar",))
def _mul_scalar(data, scalar=1.0):
    return data * scalar


@register("_div_scalar", aliases=("_DivScalar",))
def _div_scalar(data, scalar=1.0):
    return data / scalar


@register("_rdiv_scalar", aliases=("_RDivScalar",))
def _rdiv_scalar(data, scalar=1.0):
    return scalar / data


@register("_power_scalar", aliases=("_PowerScalar",))
def _power_scalar(data, scalar=1.0):
    return data ** scalar


@register("_rpower_scalar", aliases=("_RPowerScalar",))
def _rpower_scalar(data, scalar=1.0):
    return scalar ** data


@register("add_n", aliases=("ElementWiseSum", "_element_wise_sum"))
def add_n(*args):
    """The sum of every argument, added left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, normalization="null", valid_thresh=0.0):
    """The reference's ``make_loss``: the data, times ``grad_scale`` when
    that is not 1 (the forward is scaled, so its gradient is too)."""
    return data * grad_scale if grad_scale != 1.0 else data


# ----------------------------------------------- more elementwise math
# jnp rounds a Python constant to the array's dtype before the op; the
# constants below do the same (``_const``), so bf16 rounds as there.


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    return torch.tensor(value, dtype=dtype).item()


def _const(value, like):
    """``value`` rounded to ``like``'s dtype, as a Python number: a Python
    scalar in a jax expression is weakly typed and rounds to the array's
    dtype before the op, where torch would take it at full precision. A
    number (not a tensor) keeps the op free of host-to-device copies, as a
    CUDA graph's capture needs."""
    return _rounded(float(value), like.dtype)


@register("hypot", aliases=("broadcast_hypot", "_hypot", "_Hypot",
                            "_npi_hypot"))
def hypot(lhs, rhs):
    return torch.hypot(*_tensors(lhs, rhs))


@register("fmod")
def fmod(lhs, rhs):
    """C-style truncated modulo (numpy's ``fmod``)."""
    return torch.fmod(*_tensors(lhs, rhs))


@register("rint", aliases=("_npi_rint",))
def rint(x):
    return torch.round(x)


@register("fix", aliases=("_npi_fix",))
def fix(x):
    return torch.trunc(x)


def _cbrt(x):
    """``jnp.cbrt`` (torch has none): ``|x|^(1/3)`` with the sign of x,
    computed in float32 at least and rounded once to the dtype."""
    wide = x if x.dtype == torch.float64 else x.float()
    out = torch.copysign(torch.pow(wide.abs(), 1.0 / 3.0), wide)
    return out.to(x.dtype)


@register("cbrt", aliases=("_npi_cbrt",))
def cbrt(x):
    return _cbrt(x)


@register("rcbrt")
def rcbrt(x):
    return 1.0 / _cbrt(x)


# XLA's Lanczos approximation (g = 7, 8 terms) of lgamma and digamma, op
# for op in float32, as jax lowers ``gammaln`` and ``digamma``; torch's
# own lgamma is more accurate and differs from the reference by up to
# 4e-4 of the value near its roots. bf16 and fp16 compute in float32 and
# round once; float64 takes torch's.
_LANCZOS = tuple(float(_np.float32(c)) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7))
_F32 = {name: float(_np.float32(v)) for name, v in (
    ("pi", _np.pi), ("log_pi", _np.log(_np.pi)),
    ("log_sqrt_2pi", (_np.log(2) + _np.log(_np.pi)) / 2),
    ("inv_g_half", 1 / 7.5), ("log_g_half", _np.log(7.5)))}


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _lanczos_z(x):
    """``(reflect, z)``: x < 0.5 reflects, z = -x there, else x - 1."""
    reflect = x < 0.5
    return reflect, torch.where(reflect, -x, x + -1.0)


def _lanczos_log_t(z):
    return torch.log1p(z * _F32["inv_g_half"]) + _F32["log_g_half"]


def _upcast(fn):
    """``fn`` on float32 for float32/bf16/fp16 input, rounded back."""
    def run(x, exact64):
        if x.dtype == torch.float64:
            return exact64(x)
        return fn(x.float()).to(x.dtype)
    return run


@_upcast
def _lgamma(x):
    reflect, z = _lanczos_z(x)
    acc = torch.div(_f32(_LANCZOS[0], z), z + 1.0) + 1.0
    for k, c in enumerate(_LANCZOS[1:], 2):
        acc = acc + torch.div(_f32(c, z), z + float(k))
    t = z + 7.5
    log_t = _lanczos_log_t(z)
    log_y = ((z + 0.5) - torch.div(t, log_t)) * log_t + \
        _F32["log_sqrt_2pi"] + torch.log(acc)
    ax = torch.abs(x)
    frac = ax - torch.floor(ax)
    frac = torch.where(0.5 < frac, 1.0 - frac, frac)
    denom = torch.log(torch.sin(frac * _F32["pi"]))
    refl = torch.where(torch.isfinite(denom), (_F32["log_pi"] - denom) - log_y,
                       -denom)
    out = torch.where(reflect, refl, log_y)
    return torch.where(ax == float("inf"), float("inf"), out)


@_upcast
def _digamma(x):
    reflect, z = _lanczos_z(x)
    num = torch.zeros_like(z)
    den = torch.ones_like(z)
    for k, c in enumerate(_LANCZOS, 1):
        zk = z + float(k)
        num = num - torch.div(_f32(c, z), zk * zk)
        den = den + torch.div(_f32(c, z), zk)
    out = (_lanczos_log_t(z) + torch.div(num, den)) - \
        torch.div(_f32(7.0, z), z + 7.5)
    y = (x + torch.abs(torch.floor(x + 0.5))) * _F32["pi"]
    refl = out - torch.div(torch.cos(y) * _F32["pi"], torch.sin(y))
    out = torch.where(reflect, refl, out)
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, float("nan"), out)


@register("gamma", aliases=("_npx_gamma",))
def gamma(x):
    """``exp(gammaln(x))``, as the reference computes it."""
    return torch.exp(gammaln.fn(x))


class _Gammaln(torch.autograd.Function):
    """:func:`_lgamma` forward; the gradient is ``digamma``, as jax
    defines ``lgamma``'s (autograd through the Lanczos sum would be NaN
    where a ``where`` drops the reflected branch's ``log(0)``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _lgamma(x, torch.lgamma)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * _digamma(x, torch.digamma)


@register("gammaln")
def gammaln(x):
    return _Gammaln.apply(x)


@register("erfinv")
def erfinv(x):
    return torch.erfinv(x)


@register("digamma")
def digamma(x):
    return _digamma(x, torch.digamma)


for _name, _fn in (("arcsinh", torch.asinh), ("arccosh", torch.acosh),
                   ("arctanh", torch.atanh)):
    register(_name, aliases=("_npi_" + _name,))(_fn)
del _name, _fn


@register("degrees", aliases=("_npi_degrees", "_npi_rad2deg"))
def degrees(x):
    return x * _const(180.0 / _np.pi, x)


@register("radians", aliases=("_npi_radians", "_npi_deg2rad"))
def radians(x):
    return x * _const(_np.pi / 180.0, x)


# ------------------------------------------------------- logical ops


def _logical(name, fn, aliases=()):
    def op(lhs, rhs):
        return fn(*_tensors(lhs, rhs)).to(torch.float32)
    op.__name__ = name
    register(name, aliases=aliases)(op)


for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    _logical(_name, _fn, ("broadcast_" + _name,))
del _name, _fn


@register("logical_not", aliases=("_npi_logical_not",))
def logical_not(x):
    return torch.logical_not(x).to(torch.float32)


for _name, _fn in (("isnan", torch.isnan), ("isinf", torch.isinf),
                   ("isfinite", torch.isfinite)):
    register(_name)(lambda x, _f=_fn: _f(x).to(torch.float32))
del _name, _fn


# ---------------------------------------------------------------- ordering
# ``lax.top_k`` orders floats totally, as their bits do: -NaN < -inf < ...
# < -0.0 < 0.0 < ... < inf < NaN; jnp's sorts the same way but with every
# NaN last (and equal). The port sorts an integer key with that order
# (:func:`_order_key`), stably, so ties keep
# the reference's order on the card too (``torch.topk`` promises none): a
# descending sort or argsort is the ascending one flipped (ties: the
# higher index first), ``topk`` a stable descending sort (ties: the lower
# index first). Values are gathered from the data, so NaN bits and signed
# zeros come out as they went in.


def _order_key(data, nan_last):
    """An integer tensor that sorts as ``data`` does in total order (with
    every NaN equal and last when ``nan_last``)."""
    if not data.is_floating_point():
        return data
    if nan_last:
        data = torch.where(torch.isnan(data), float("nan"), data)
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        data.element_size()]
    bits = data.contiguous().view(ity)
    nbits = 8 * data.element_size()
    mag = torch.iinfo(ity).max
    return bits ^ (torch.bitwise_right_shift(bits, nbits - 1) & mag)


def _sort_idx(data, axis, descending=False, nan_last=True):
    return torch.sort(_order_key(data, nan_last), dim=axis,
                      descending=descending, stable=True).indices


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    idx = _sort_idx(data, axis)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(dtype))


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.gather(data, axis, _sort_idx(data, axis))
    return out if is_ascend else torch.flip(out, (axis,))


@register("topk", aliases=("_npx_topk",))
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """``lax.top_k`` along ``axis`` (of ``-data`` for ``is_ascend``):
    ``ret_typ`` ``"value"``, ``"indices"`` (in ``dtype``), ``"both"`` or
    ``"mask"`` (0/1 over the input's shape in its dtype)."""
    ax = axis % data.dim()
    keyed = -data if is_ascend else data
    idx = _sort_idx(keyed, ax, descending=True,
                    nan_last=False).narrow(ax, 0, k)
    vals = torch.gather(data, ax, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(ax, idx, 1.0)
    return idx.to(torch_dtype(dtype))


_SCAN_BLOCK = 16


def _block_scan(x, axis):
    """An inclusive prefix sum along ``axis`` whose additions round as
    XLA's rewrite of ``jnp.cumsum`` (reduce-window with base length 16)
    rounds them: left to right within blocks of 16, the blocks' totals
    scanned the same way, each block's exclusive prefix added to it."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1).movedim(-1, axis)
    nb = -(-n // _SCAN_BLOCK)
    pad = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    inner = _block_scan(pad.reshape(x.shape[:-1] + (nb, _SCAN_BLOCK)), -1)
    totals = _block_scan(inner[..., -1], -1)
    excl = torch.nn.functional.pad(totals, (1, 0))[..., :nb]
    out = torch.cat([inner[..., :1, :], inner[..., 1:, :]
                     + excl[..., 1:, None]], -2)
    return out.reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))[..., :n] \
        .movedim(-1, axis)


@register("cumsum", aliases=("_np_cumsum",))
def cumsum(data, axis=None, dtype=None):
    """``jnp.cumsum``: over the flattened data without ``axis``; floats
    add as XLA orders the additions (:func:`_block_scan`), integers keep
    their dtype and bool counts in int32. ``torch.cumsum`` would be one
    launch, but it accumulates bf16 in fp32 where the reference rounds
    every addition to bf16 (0.125 apart over 300 values), and orders fp32
    otherwise; the block order keeps both bitwise with the reference."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    if data.is_floating_point():
        out = _block_scan(data, axis) if data.shape[axis] else data
    else:
        res = torch.int32 if data.dtype == torch.bool else data.dtype
        out = torch.cumsum(data, axis).to(res)
    return out.to(torch_dtype(dtype)) if dtype else out


# ------------------------------------------------------ NaN reductions


def _nanreduce(fn, fill, data, axis, keepdims):
    if data.is_floating_point():
        data = torch.where(torch.isnan(data), torch.full((), fill,
                                                         dtype=data.dtype,
                                                         device=data.device),
                           data)
    return fn(data, axis, keepdims)


@register("nansum")
def nansum(data, axis=None, keepdims=False):
    return _nanreduce(sum.fn, 0, data, axis, keepdims)


@register("nanprod")
def nanprod(data, axis=None, keepdims=False):
    return _nanreduce(prod.fn, 1, data, axis, keepdims)


# ------------------------------------------------------ shape and indexing


@register("roll", aliases=("_np_roll",))
def roll(data, shift=0, axis=None):
    if axis is None:
        return torch.roll(data, shift)
    return torch.roll(data, shift, axis)


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * bs * bs, h // bs, w // bs)


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    """``data`` written into zeros of ``shape`` at ``gather_nd``-style
    ``indices`` (M, N) (duplicates: one of the writes)."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data)


@register("shape_array", differentiable=False)
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@register("diag")
def diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("khatri_rao")
def khatri_rao(*args):
    """The column-wise Kronecker product of (rows_i, cols) matrices."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            (-1,) + tuple(out.shape[1:]))
    return out


# ------------------------------------------------------------- AMP casts


@register("amp_cast")
def amp_cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("amp_multicast", n_out=0)
def amp_multicast(*data, num_outputs=1, cast_narrow=False):
    """Every input cast to their promoted dtype (to the first input's
    with ``cast_narrow``, as the reference does)."""
    target = data[0].dtype
    if not cast_narrow:
        for d in data[1:]:
            target = torch.promote_types(target, d.dtype)
    return tuple(d.to(target) for d in data)


# ---------------------------------------------------------------- linalg
# on the card these run on cuBLAS/cuSOLVER; callers keep TF32 off, as
# every phase of the smoke script does


def _mT(x):
    return x.transpose(-1, -2)


@register("linalg_gemm2", aliases=("_linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-3):
    a = _mT(A) if transpose_a else A
    b = _mT(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_gemm", aliases=("_linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-3):
    return linalg_gemm2.fn(A, B, transpose_a, transpose_b, alpha) + \
        beta * C


@register("linalg_potrf", aliases=("_linalg_potrf", "_npi_cholesky"))
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_syrk", aliases=("_linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    if transpose:
        return alpha * torch.matmul(_mT(A), A)
    return alpha * torch.matmul(A, _mT(A))


@register("linalg_trsm", aliases=("_linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve ``op(A) X = alpha B`` (``X op(A) = alpha B`` with
    ``rightside``) for triangular A, as the reference's
    ``solve_triangular`` calls read it."""
    a = _mT(A) if transpose else A
    if rightside:
        x = torch.linalg.solve_triangular(_mT(a), _mT(alpha * B),
                                          upper=lower)
        return _mT(x)
    return torch.linalg.solve_triangular(a, alpha * B, upper=not lower)


@register("linalg_sumlogdiag", aliases=("_linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), -1)


@register("linalg_extractdiag", aliases=("_linalg_extractdiag",))
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


# --------------------------------------------------------------- aliases
# the reference's other spellings of ops above: the ``_npi_``/``_np_``/
# ``_npx_`` names of its numpy frontends, the legacy CamelCase binary
# ops, ``less``/``less_equal`` and the contrib embedding


for _op, _names in (
        ("add", ("_npi_add", "_Plus", "_grad_add")),
        ("subtract", ("_npi_subtract", "_Minus")),
        ("multiply", ("_npi_multiply", "_Mul")),
        ("divide", ("_npi_true_divide", "_Div")),
        ("mod", ("_npi_mod", "_mod", "_Mod")),
        ("power", ("_npi_power", "_Power")),
        ("maximum", ("_npi_maximum", "_Maximum")),
        ("minimum", ("_npi_minimum", "_Minimum")),
        ("equal", ("_Equal",)), ("not_equal", ("_Not_Equal",)),
        ("greater", ("_Greater",)), ("greater_equal", ("_Greater_Equal",)),
        ("lesser", ("_Lesser", "less")),
        ("lesser_equal", ("_Lesser_Equal", "less_equal")),
        ("_plus_scalar", ("_npi_add_scalar",)),
        ("_minus_scalar", ("_npi_subtract_scalar",)),
        ("_rminus_scalar", ("_npi_rsubtract_scalar",)),
        ("_mul_scalar", ("_npi_multiply_scalar",)),
        ("_div_scalar", ("_npi_true_divide_scalar",)),
        ("_rdiv_scalar", ("_npi_rtrue_divide_scalar",)),
        ("_power_scalar", ("_npi_power_scalar",)),
        ("_rpower_scalar", ("_npi_rpower_scalar",)),
        ("abs", ("_npi_abs", "_npi_absolute")),
        ("arccos", ("_npi_arccos",)), ("arcsin", ("_npi_arcsin",)),
        ("arctan", ("_npi_arctan",)), ("cos", ("_npi_cos",)),
        ("cosh", ("_npi_cosh",)), ("sin", ("_npi_sin",)),
        ("sinh", ("_npi_sinh",)), ("tan", ("_npi_tan",)),
        ("tanh", ("_npi_tanh",)), ("exp", ("_npi_exp",)),
        ("expm1", ("_npi_expm1",)), ("log", ("_npi_log",)),
        ("log10", ("_npi_log10",)), ("log1p", ("_npi_log1p",)),
        ("log2", ("_npi_log2",)), ("sqrt", ("_npi_sqrt",)),
        ("square", ("_npi_square",)), ("ceil", ("_npi_ceil",)),
        ("floor", ("_npi_floor",)), ("trunc", ("_npi_trunc",)),
        ("sign", ("_npi_sign",)), ("negative", ("_npi_negative",)),
        ("reciprocal", ("_npi_reciprocal",)),
        ("argmax", ("_npi_argmax",)), ("argmin", ("_npi_argmin",)),
        ("cast", ("_npi_cast", "_npx_cast")), ("clip", ("_npi_clip",)),
        ("concat", ("_npi_concatenate",)), ("gather_nd", ("_npi_gather_nd",)),
        ("expand_dims", ("_npi_expand_dims",)), ("flip", ("_npi_flip",)),
        ("mean", ("_npi_mean",)), ("max", ("_np_max",)),
        ("min", ("_np_min",)), ("sum", ("_np_sum",)),
        ("prod", ("_np_prod",)), ("broadcast_to", ("_np_broadcast_to",)),
        ("identity", ("_np_copy", "BlockGrad_identity")),
        ("ones_like", ("_np_ones_like",)), ("zeros_like", ("_np_zeros_like",)),
        ("squeeze", ("_np_squeeze",)), ("repeat", ("_np_repeat",)),
        ("dot", ("_np_dot",)),
        ("reshape", ("_npi_reshape", "_np_reshape", "_npx_reshape")),
        ("transpose", ("_np_transpose",)), ("swapaxes", ("_npi_swapaxes",)),
        ("take", ("_npi_take",)), ("tile", ("_npi_tile",)),
        ("stack", ("_npi_stack",)), ("split", ("_npi_split",)),
        ("slice", ("_npi_slice", "_npx_slice")),
        ("batch_dot", ("_npx_batch_dot",)),
        ("Flatten", ("_npx_batch_flatten",)),
        ("embedding", ("_npx_embedding", "_contrib_SparseEmbedding",
                       "SparseEmbedding")),
        ("one_hot", ("_npx_one_hot",)),
        ("pick", ("_npx_pick", "choose_element_0index")),
        ("_arange", ("_npi_arange",))):
    register_alias(_op, *_names)
del _op, _names
