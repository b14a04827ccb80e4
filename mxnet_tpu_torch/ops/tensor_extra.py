"""Tensor-op breadth: scalar comparisons and logical ops, creation,
slice assignment, index ravelling, histograms, moments, and the
multi-tensor checks of global-norm clipping and AMP.

Counterpart of ``mxnet_tpu/ops/tensor_extra.py``, with every name it
registers and the ``_npi_``/CamelCase spellings that the reference's
other files register onto its functions. Results keep the reference's
dtypes: a scalar comparison or logical op gives 1/0 in the input's dtype,
``all_finite`` and ``multi_all_finite`` a bool of shape (1,), the
histogram float counts. ``cast_storage`` and ``_sparse_retain`` are dense,
as in the reference. ``_shuffle`` draws on the data's device from the
samplers' generator (:mod:`.random_ops`).
"""
from __future__ import annotations

import builtins

import torch

from ..base import torch_dtype
from .registry import bind_key, register

# ------------------------------------------------ scalar comparisons


def _scalar_as(data, scalar):
    """``scalar`` as a 0-d tensor in ``data``'s dtype and device (a Python
    scalar is weakly typed in jnp and takes the array's dtype)."""
    return torch.tensor(scalar, dtype=data.dtype, device=data.device)


def _scalar_compare(name, fn, camel):
    def op(data, scalar=0.0):
        return fn(data, _scalar_as(data, scalar)).to(data.dtype)
    op.__name__ = name
    register(name, aliases=(camel,))(op)


for _name, _fn, _camel in (
        ("_equal_scalar", torch.eq, "_EqualScalar"),
        ("_not_equal_scalar", torch.ne, "_NotEqualScalar"),
        ("_greater_scalar", torch.gt, "_GreaterScalar"),
        ("_greater_equal_scalar", torch.ge, "_GreaterEqualScalar"),
        ("_lesser_scalar", torch.lt, "_LesserScalar"),
        ("_lesser_equal_scalar", torch.le, "_LesserEqualScalar"),
        ("_logical_and_scalar", torch.logical_and, "_LogicalAndScalar"),
        ("_logical_or_scalar", torch.logical_or, "_LogicalOrScalar"),
        ("_logical_xor_scalar", torch.logical_xor, "_LogicalXorScalar")):
    _scalar_compare(_name, _fn, _camel)
del _name, _fn, _camel


@register("_maximum_scalar", aliases=("_MaximumScalar",
                                      "_npi_maximum_scalar"))
def _maximum_scalar(data, scalar=0.0):
    return torch.maximum(data, _scalar_as(data, scalar))


@register("_minimum_scalar", aliases=("_MinimumScalar",
                                      "_npi_minimum_scalar"))
def _minimum_scalar(data, scalar=0.0):
    return torch.minimum(data, _scalar_as(data, scalar))


@register("_mod_scalar", aliases=("_ModScalar", "_npi_mod_scalar"))
def _mod_scalar(data, scalar=1.0):
    return torch.remainder(data, _scalar_as(data, scalar))


@register("_rmod_scalar", aliases=("_RModScalar", "_npi_rmod_scalar"))
def _rmod_scalar(data, scalar=1.0):
    return torch.remainder(_scalar_as(data, scalar), data)


@register("_hypot_scalar", aliases=("_HypotScalar", "_npi_hypot_scalar"))
def _hypot_scalar(data, scalar=0.0):
    return torch.hypot(data, _scalar_as(data, scalar))


def _logical_binary(name, fn, camel):
    def op(lhs, rhs):
        return fn(lhs, rhs).to(lhs.dtype)
    op.__name__ = name
    register(name, aliases=(camel,))(op)


for _name, _fn, _camel in (("_logical_and", torch.logical_and, "_Logical_And"),
                           ("_logical_or", torch.logical_or, "_Logical_Or"),
                           ("_logical_xor", torch.logical_xor,
                            "_Logical_Xor")):
    _logical_binary(_name, _fn, _camel)
del _name, _fn, _camel

# ---------------------------------------------------------------- creation


def _device(ctx):
    """The torch device of ``ctx`` (the current context when it is not a
    ``Context``): where an op without a tensor input makes its result."""
    from ..context import Context, current_context
    return (ctx if isinstance(ctx, Context) else current_context()) \
        .torch_device


def _dt(dtype, default=torch.float32):
    return default if dtype is None else torch_dtype(dtype)


def _spaced(lo, hi, div, dtype, device):
    """``div`` values ``lo * (1 - i / div) + hi * i / div`` as XLA computes
    ``jnp.linspace``'s: the division by ``div`` a multiply by its rounded
    reciprocal, ``hi / div`` folded into one factor, and the last multiply
    and add fused (one rounding: the float32 product is exact in
    float64)."""
    r = torch.tensor(1.0 / div, dtype=dtype, device=device)
    iota = torch.arange(div, dtype=dtype, device=device)
    head = lo * (1 - iota * r)
    if dtype == torch.float64:
        return head + iota * (hi * r)
    return (iota.double() * (hi * r).double() + head.double()).to(dtype)


@register("_linspace", aliases=("_npi_linspace",), differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
              dtype=None):
    """``jnp.linspace`` (:func:`_spaced`), with ``stop`` itself appended
    when ``endpoint``; integer dtypes take the floor."""
    dt, num = _dt(dtype), int(num)
    wide = dt if dt.is_floating_point else torch.float64
    dev = _device(ctx)
    if num <= 1:
        return torch.full((num,), start, dtype=wide, device=dev).to(dt)
    s = torch.tensor(start, dtype=wide, device=dev)
    e = torch.tensor(stop, dtype=wide, device=dev)
    out = _spaced(s, e, num - 1 if endpoint else num, wide, dev)
    if endpoint:
        out = torch.cat([out, e.reshape(1)])
    if not dt.is_floating_point:
        out = torch.floor(out)
    return out.to(dt)


@register("_eye", aliases=("_npi_eye",), differentiable=False)
def _eye(N=0, M=0, k=0, ctx=None, dtype=None):
    n, m, dev = int(N), int(M) if M else int(N), _device(ctx)
    rows = torch.arange(n, device=dev).reshape(n, 1)
    return (torch.arange(m, device=dev) - rows == int(k)).to(_dt(dtype))


@register("_full", aliases=("_npi_full",), differentiable=False)
def _full(shape=None, value=0.0, ctx=None, dtype=None):
    return torch.full(tuple(shape), value, dtype=_dt(dtype),
                      device=_device(ctx))


@register("_ones", aliases=("_npi_ones",), differentiable=False)
def _ones(shape=None, ctx=None, dtype=None):
    return torch.ones(tuple(shape), dtype=_dt(dtype), device=_device(ctx))


@register("_zeros", aliases=("_npi_zeros", "_zeros_without_dtype"),
          differentiable=False)
def _zeros(shape=None, ctx=None, dtype=None):
    return torch.zeros(tuple(shape), dtype=_dt(dtype), device=_device(ctx))


@register("_histogram", aliases=("_npi_histogram",), n_out=2,
          differentiable=False)
def _histogram(data, bins=10, range=None, bin_cnt=None):  # noqa: A002
    """``jnp.histogram``: float counts and the bin edges, the last bin
    closed on the right; values outside the range are not counted."""
    x = data.reshape(-1)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    if isinstance(bins, torch.Tensor) and bins.dim() >= 1:
        edges = bins.to(x.dtype)
    else:
        n = int(bin_cnt or bins)
        if range is None:
            lo, hi = x.min(), x.max()
        else:
            lo, hi = (torch.tensor(float(v), dtype=x.dtype,
                                   device=x.device) for v in range)
        flat = hi - lo == 0
        lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5,
                                                              hi)
        edges = torch.cat([_spaced(lo, hi, n, x.dtype, x.device),
                           hi.reshape(1)])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], len(edges) - 1, idx)
    counts = torch.bincount(idx, minlength=len(edges) + 1)
    return counts[1:len(edges)].to(x.dtype), edges


@register("_shuffle", aliases=("shuffle", "_np__random_shuffle"),
          differentiable=False, state_binders={"key": bind_key})
def _shuffle(data, key=None):
    """A random permutation of the first axis, drawn on the data's
    device."""
    from .random_ops import generator_for
    gen = generator_for(data.device, key)
    return data[torch.randperm(data.shape[0], generator=gen,
                               device=data.device)]


# ------------------------------------------------ indexing / assignment


@register("_ravel_multi_index", aliases=("ravel_multi_index",))
def _ravel_multi_index(data, shape=None):
    """(ndim, N) multi-indices to (N,) flat ones, each clipped to its
    dimension, in ``data``'s dtype."""
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(int(s) for s in shape):
        flat = flat * s + data[i].to(torch.int64).clamp(0, s - 1)
    return flat.to(data.dtype)


@register("_unravel_index", aliases=("unravel_index",))
def _unravel_index(data, shape=None):
    """(N,) flat indices to (ndim, N) multi-indices, in ``data``'s
    dtype."""
    flat = data.to(torch.int64)
    parts = []
    for s in reversed([int(s) for s in shape]):
        parts.append(torch.remainder(flat, s))
        flat = torch.div(flat, s, rounding_mode="floor")
    return torch.stack(parts[::-1], 0).to(data.dtype)


def _slice_tuple(shape, begin, end, step=None):
    step = step or [None] * len(shape)
    return tuple(builtins.slice(begin[i] if i < len(begin) else None,
                                end[i] if i < len(end) else None,
                                step[i] if i < len(step) else None)
                 for i in range(len(shape)))


@register("_slice_assign", aliases=("_crop_assign", "_npi_slice_assign"))
def _slice_assign(lhs, rhs, begin=(), end=(), step=None):
    out = lhs.clone()
    out[_slice_tuple(lhs.shape, begin, end, step)] = rhs
    return out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",
                                           "_npi_slice_assign_scalar"))
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=None):
    out = data.clone()
    out[_slice_tuple(data.shape, begin, end, step)] = scalar
    return out


@register("_scatter_set_nd", aliases=("_npi_scatter_set_nd",))
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    """``rhs`` written into a copy of ``lhs`` at ``gather_nd``-style
    ``indices``."""
    return lhs.index_put(tuple(indices.to(torch.int64)), rhs)


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[int(la)] = rhs.shape[int(ra)]
    return lhs.expand(tuple(shape))


@register("reshape_like", aliases=("_npx_reshape_like",))
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """``lhs`` in ``rhs``'s shape, or with ``lhs[lhs_begin:lhs_end]``'s
    dimensions replaced by ``rhs[rhs_begin:rhs_end]``'s (a negative bound
    counts from the end)."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)

    def ax(v, ndim, default):
        if v is None:
            return default
        v = int(v)
        return v + ndim if v < 0 else v

    lb, le = ax(lhs_begin, lhs.dim(), 0), ax(lhs_end, lhs.dim(), lhs.dim())
    rb, re = ax(rhs_begin, rhs.dim(), 0), ax(rhs_end, rhs.dim(), rhs.dim())
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re])
                       + tuple(lhs.shape[le:]))


@register("_split_v2", n_out=-1)
def _split_v2(data, indices=(), axis=1, squeeze_axis=False, sections=0):
    """``split_v2``: into ``sections`` equal parts, or at ``indices``."""
    axis = int(axis)
    if sections and sections > 0:
        if data.shape[axis] % int(sections):
            raise ValueError("array split does not result in an equal "
                             "division")
        parts = torch.tensor_split(data, int(sections), axis)
    else:
        parts = torch.tensor_split(data, [int(i) for i in indices], axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("argmax_channel")
def argmax_channel(data):
    """The argmax along the last axis, in the data's dtype."""
    return torch.argmax(data, -1).to(data.dtype)


@register("moments", n_out=2)
def moments(data, axes=None, keepdims=False):
    """Mean and (biased) variance over ``axes``, op for op as the
    reference: the variance is the mean of the squared deviations."""
    dims = tuple(axes) if axes is not None else tuple(range(data.dim()))
    mean = torch.mean(data, dims, keepdim=True)
    var = torch.mean(torch.square(data - mean), dims, keepdim=keepdims)
    if not keepdims:
        mean = mean.reshape(var.shape)
    return mean, var


@register("_square_sum", aliases=("square_sum",))
def _square_sum(data, axis=None, keepdims=False):
    from .core import sum as _sum
    return _sum.fn(torch.square(data), axis, keepdims)


@register("cast_storage", storage=True)
def cast_storage(data, stype=None):
    """``data`` in storage ``stype``: a sparse handle
    (``ndarray.sparse``) for ``"row_sparse"``/``"csr"``, a tensor for
    ``"default"`` (or None), as MXNet 1.6's; the values are the
    reference's, which keeps every storage dense."""
    from ..ndarray.ndarray import NDArray
    from ..ndarray.sparse import BaseSparseNDArray, _to_stype
    if isinstance(data, BaseSparseNDArray):
        return data._data if stype in (None, "default") else \
            _to_stype(data, stype)
    if stype in (None, "default"):
        return data
    return _to_stype(NDArray(data), stype)


@register("_sparse_retain", aliases=("sparse_retain",), storage=True)
def _sparse_retain(data, indices):
    """The rows at ``indices`` kept and every other row zeroed (dense, as
    the reference's); a ``RowSparseNDArray`` keeps its rows at
    ``indices`` (``ndarray.sparse.retain``)."""
    from ..ndarray.sparse import RowSparseNDArray, retain
    if isinstance(data, RowSparseNDArray):
        return retain(data, indices)
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    keep = keep.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


@register("all_finite")
def all_finite(data, init_output=True):
    return torch.isfinite(data).all().reshape(1)


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """One bool for every array: all their values finite. On the card the
    checks stay there (one ``all`` a tensor, no copy to the host)."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.reshape(1)


@register("multi_sum_sq", n_out=-1)
def multi_sum_sq(*arrays, num_arrays=1):
    """Each array's sum of squares, a 0-d tensor in its dtype."""
    return tuple(torch.sum(torch.square(a)) for a in arrays)


@register("reset_arrays", n_out=-1)
def reset_arrays(*arrays, num_arrays=1):
    return tuple(torch.zeros_like(a) for a in arrays)

