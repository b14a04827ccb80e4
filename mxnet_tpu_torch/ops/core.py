"""Core tensor operators: elementwise, broadcast, reduce, shape, indexing.

Counterpart of the part of ``mxnet_tpu/ops/core.py`` that ``NDArray``'s own
methods dispatch and that Gluon's layers and the two models call through
``F.``: each op is a short function over torch tensors with the
reference op's name, aliases, arguments and result dtypes (comparisons
give 1.0/0.0 in the input's floating type, or float32; ``argmax`` and
``argmin`` give float32 indices; ``one_hot`` float32), and the sequence
ops the recurrent cells use (``SequenceMask``, ``SequenceLast``,
``SequenceReverse``, ``_rnn_param_concat``). The rest of the reference's
corpus is ROADMAP Queue A item 8.
"""
from __future__ import annotations

import builtins

import numpy as _np
import torch

from ..base import torch_dtype
from .registry import register

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


for _name, _fn in (
        ("abs", torch.abs), ("sign", torch.sign), ("round", torch.round),
        ("ceil", torch.ceil), ("floor", torch.floor), ("trunc", torch.trunc),
        ("square", torch.square), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("exp", torch.exp), ("log", torch.log),
        ("log10", torch.log10), ("log2", torch.log2),
        ("log1p", torch.log1p), ("expm1", torch.expm1),
        ("erf", torch.erf), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan), ("arcsin", torch.asin),
        ("arccos", torch.acos), ("arctan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
        ("relu", torch.relu)):
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
    return data[idx]


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
    return data[_index_key(key)]


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
