"""NumPy-semantics operators (``_npi_*``/``_np_*``/``_npx_*``).

Counterpart of ``mxnet_tpu/ops/numpy_ops.py``: its 70 names (the new
functions with their aliases and scalar variants, the boolean-mask
assigns and the three samplers) and its alias table, for every alias
whose target the port has. Results keep the reference's dtypes
(:func:`._jnp.result_dtype`).

Value-dependent shapes. ``nonzero`` and ``unique`` give a result whose
shape depends on the values, so they read the count from the device (a
sync) and run eagerly only; inside a ``CachedOp``'s CUDA-graph capture
they raise naming the op (:func:`eager_only`), as the reference cannot
trace them under ``jit``. ``_npi_boolean_mask_assign_tensor`` scatters
with ``masked_scatter`` and needs no count. ``_npi_svd`` runs on the
tensor's device (cuSOLVER on the card), with no host copy.

The samplers take the RNG key words as a state binder and draw on the
device of their context or input (``random_ops.generator_for``);
threefry is not ported, so they match the reference in distribution.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from . import _jnp
from .random_ops import generator_for
from .registry import bind_key, get_op, register, register_alias
from .tensor_extra import _device, _dt

_RNG = {"key": bind_key}

__all__ = ["eager_only"]


def eager_only(name):
    """Raise if a CUDA graph is being captured: op ``name``'s output shape
    depends on its values, which a capture cannot read."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "%s has a value-dependent output shape and cannot run inside a "
            "CachedOp's graph capture; call it eagerly" % name)


def _wide(x):
    """bf16 and fp16 computed in float32 (jnp upcasts them for
    reductions)."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def _as(x, like):
    """A Python scalar as jnp's ``asarray(scalar, like.dtype)``."""
    v = torch.tensor(scalar_value(x, like.dtype), dtype=like.dtype,
                     device=like.device)
    return v


def scalar_value(x, dtype):
    return bool(x) if dtype == torch.bool else (
        float(x) if dtype.is_floating_point else int(x))


def _inexact(*xs):
    dt = _jnp.result_dtype("inexact", *xs)
    return [x.to(dt) if isinstance(x, torch.Tensor) else x for x in xs], dt


# ------------------------------------------------------------- new ops

@register("around", aliases=("_npi_around",))
def around(x, decimals=0):
    if not x.is_floating_point():
        return x.clone()
    return torch.round(x, decimals=int(decimals))


@register("nonzero", aliases=("_npi_nonzero", "_npx_nonzero"),
          differentiable=False)
def nonzero(x):
    """Indices of the nonzero elements, (N, ndim) int64."""
    eager_only("nonzero")
    return torch.nonzero(x)


@register("rot90", aliases=("_npi_rot90",))
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), [int(a) for a in axes])


def _moment(fn, x, axis, dtype, ddof, keepdims):
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    dt = _jnp.result_dtype("inexact", x)
    out = fn(_wide(x.to(dt)), dim=axis, correction=int(ddof),
             keepdim=bool(keepdims)).to(dt)
    return out.to(torch_dtype(dtype)) if dtype is not None else out


@register("std", aliases=("_npi_std",))
def std(x, axis=None, dtype=None, ddof=0, keepdims=False):
    return _moment(torch.std, x, axis, dtype, ddof, keepdims)


@register("var", aliases=("_npi_var",))
def var(x, axis=None, dtype=None, ddof=0, keepdims=False):
    return _moment(torch.var, x, axis, dtype, ddof, keepdims)


@register("unique", aliases=("_npi_unique",), differentiable=False,
          n_out=-1)
def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """``numpy.unique`` on the device: sorted values, then (as asked) the
    first index of each, the inverse and the counts, all int64."""
    eager_only("unique")
    flat = x.reshape(-1) if axis is None else x
    dim = None if axis is None else int(axis)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    outs = [vals]
    if return_index:
        n = flat.shape[0 if dim is None else dim]
        first = torch.full((counts.shape[0],), n, dtype=torch.int64,
                           device=x.device)
        outs.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        outs.append(inv.reshape(x.shape) if axis is None and x.dim() > 1
                    else inv)
    if return_counts:
        outs.append(counts)
    return tuple(outs) if len(outs) > 1 else outs[0]


@register("_npi_svd", aliases=("svd",), n_out=3)
def _npi_svd(A):
    """``(u, s, vh)`` with ``A = u @ diag(s) @ vh``, the reduced factors,
    on ``A``'s device (cuSOLVER's QR-based ``gesvd`` on the card: its
    Jacobi default is ~1e-4 of the largest value off in float32); bf16
    and fp16 computed in float32."""
    u, s, vh = torch.linalg.svd(_wide(A), full_matrices=False,
                                driver="gesvd" if A.is_cuda else None)
    return u.to(A.dtype), s.to(A.dtype), vh.to(A.dtype)


@register("einsum", aliases=("_npi_einsum",))
def einsum(*operands, subscripts="", optimize=0):
    dt = _jnp.result_dtype("promote", *operands)
    return torch.einsum(subscripts, *[o.to(dt) for o in operands])


@register("tensordot", aliases=("_npi_tensordot",))
def tensordot(a, b, a_axes_summed=None, b_axes_summed=None, axes=None):
    dt = _jnp.result_dtype("promote", a, b)
    a, b = a.to(dt), b.to(dt)
    if a_axes_summed is not None:
        return torch.tensordot(a, b, dims=([int(i) for i in a_axes_summed],
                                           [int(i) for i in b_axes_summed]))
    return torch.tensordot(a, b, dims=2 if axes is None else axes)


@register("_npi_tensordot_int_axes")
def _npi_tensordot_int_axes(a, b, axes=2):
    return tensordot.fn(a, b, axes=int(axes))


@register("diff", aliases=("_npi_diff",))
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=int(n), dim=int(axis))


@register("copysign", aliases=("_npi_copysign",))
def copysign(x1, x2):
    (x1, x2), _ = _inexact(x1, x2)
    return torch.copysign(x1, x2)


@register("_npi_copysign_scalar")
def _npi_copysign_scalar(x, scalar=1.0):
    dt = _jnp.result_dtype("inexact", x, scalar)
    return torch.copysign(x.to(dt), torch.tensor(float(scalar), dtype=dt,
                                                 device=x.device))


@register("_npi_rcopysign_scalar")
def _npi_rcopysign_scalar(x, scalar=1.0):
    s = _as(scalar, x)
    (s, x), _ = _inexact(s, x)
    return torch.copysign(s, x)


@register("lcm", aliases=("_npi_lcm",))
def lcm(x1, x2):
    dt = _jnp.result_dtype("promote", x1, x2)
    return torch.lcm(x1.to(dt), x2.to(dt))


@register("_npi_lcm_scalar")
def _npi_lcm_scalar(x, scalar=1):
    return torch.lcm(x, torch.tensor(int(scalar), dtype=x.dtype,
                                     device=x.device))


def _ldexp(m, e):
    m = m.to(_jnp.result_dtype("inexact", m))
    return m * torch.pow(torch.tensor(2.0, dtype=m.dtype, device=m.device),
                         e.to(torch.int32).to(m.dtype))


@register("ldexp", aliases=("_npi_ldexp",))
def ldexp(x1, x2):
    return _ldexp(x1, x2)


@register("_npi_ldexp_scalar")
def _npi_ldexp_scalar(x, scalar=0):
    return _ldexp(x, torch.tensor(int(scalar), device=x.device))


@register("_npi_rldexp_scalar")
def _npi_rldexp_scalar(x, scalar=1.0):
    return _ldexp(_as(scalar, x), x)


@register("arctan2", aliases=("_npi_arctan2",))
def arctan2(x1, x2):
    (x1, x2), _ = _inexact(x1, x2)
    return torch.atan2(x1, x2)


@register("_npi_arctan2_scalar")
def _npi_arctan2_scalar(x, scalar=0.0):
    return arctan2.fn(x, _as(scalar, x))


@register("_npi_rarctan2_scalar")
def _npi_rarctan2_scalar(x, scalar=0.0):
    return arctan2.fn(_as(scalar, x), x)


@register("nan_to_num", aliases=("_npi_nan_to_num",))
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if not x.is_floating_point():
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register("_npi_indices", aliases=("indices",), differentiable=False)
def _npi_indices(dimensions=(), dtype=None, ctx=None):
    dev = _device(ctx)
    dims = [int(d) for d in dimensions]
    grids = torch.meshgrid(*[torch.arange(d, device=dev) for d in dims],
                           indexing="ij") if dims else []
    out = torch.stack(list(grids)) if dims else \
        torch.zeros((0,), device=dev)
    return out.to(_dt(dtype, torch.int32))


@register("logspace", aliases=("_npi_logspace",), differentiable=False)
def logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
             ctx=None, dtype=None):
    """``base ** linspace(...)`` in the result's float dtype (jnp's
    order)."""
    from .tensor_extra import _linspace
    dt = _dt(dtype)
    wide = dt if dt.is_floating_point else torch.float64
    lin = _linspace.fn(start, stop, num, endpoint, ctx=ctx, dtype=wide)
    return _jnp.astype(torch.pow(torch.tensor(float(base), dtype=wide,
                                              device=lin.device), lin), dt)


def _window(fn, M, ctx, dtype):
    """A numpy window computed in float64 (as jnp's under x64), then
    cast."""
    M = int(M)
    dev = _device(ctx)
    if M < 1:
        return torch.zeros((0,), dtype=_dt(dtype), device=dev)
    return fn(M, periodic=False, dtype=torch.float64,
              device=dev).to(_dt(dtype))


@register("_npi_blackman", aliases=("blackman",), differentiable=False)
def _npi_blackman(M=0, ctx=None, dtype=None):
    return _window(torch.blackman_window, M, ctx, dtype)


@register("_npi_hamming", aliases=("hamming",), differentiable=False)
def _npi_hamming(M=0, ctx=None, dtype=None):
    return _window(torch.hamming_window, M, ctx, dtype)


@register("_npi_hanning", aliases=("hanning",), differentiable=False)
def _npi_hanning(M=0, ctx=None, dtype=None):
    return _window(torch.hann_window, M, ctx, dtype)


def _stacked(fn, data):
    dt = _jnp.result_dtype("promote", *data)
    return fn([d.to(dt) for d in data])


@register("column_stack", aliases=("_npi_column_stack",))
def column_stack(*data, num_args=None):
    return _stacked(torch.column_stack, data)


@register("dstack", aliases=("_npi_dstack",))
def dstack(*data, num_args=None):
    return _stacked(torch.dstack, data)


@register("vstack", aliases=("_npi_vstack",))
def vstack(*data, num_args=None):
    return _stacked(torch.vstack, data)


@register("_npi_hsplit", n_out=-1)
def _npi_hsplit(x, indices=(), sections=0, axis=None, squeeze_axis=False):
    dim = 1 if x.dim() > 1 else 0
    if sections:
        if x.shape[dim] % int(sections):
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(x, int(sections), dim=dim))
    return tuple(torch.tensor_split(x, [int(i) for i in indices], dim=dim))


@register("tril", aliases=("_npi_tril",))
def tril(x, k=0):
    return torch.tril(x, int(k))


@register("moveaxis", aliases=("_np_moveaxis",))
def moveaxis(x, source=0, destination=0):
    src = tuple(source) if isinstance(source, (list, tuple)) else int(source)
    dst = tuple(destination) if isinstance(destination, (list, tuple)) \
        else int(destination)
    return torch.movedim(x, src, dst)


@register("trace", aliases=("_np_trace",))
def trace(x, offset=0, axis1=0, axis2=1):
    dt = _jnp.result_dtype("sum", x)
    d = torch.diagonal(x, int(offset), int(axis1), int(axis2))
    wide = torch.int64 if not dt.is_floating_point and dt != torch.uint64 \
        else dt
    return d.to(wide).sum(-1).to(dt)


@register("_npi_identity", differentiable=False)
def _npi_identity(n=0, ctx=None, dtype=None):
    return torch.eye(int(n), dtype=_dt(dtype), device=_device(ctx))


@register("share_memory", aliases=("_npi_share_memory",),
          differentiable=False)
def share_memory(a, b):
    """Whether two arrays may share memory: always False, as in the
    reference (whose arrays are immutable)."""
    return torch.zeros((), dtype=torch.bool, device=a.device)


@register("_npi_boolean_mask_assign_scalar")
def _npi_boolean_mask_assign_scalar(data, mask, value=0.0):
    return torch.where(mask.bool(), _as(value, data), data)


@register("_npi_boolean_mask_assign_tensor")
def _npi_boolean_mask_assign_tensor(data, mask, value):
    """``data`` with its masked positions set: elementwise where ``value``
    has ``data``'s shape (or one element), else the masked positions take
    ``value``'s elements in order (``masked_scatter``: no count read from
    the device)."""
    m = mask.bool()
    value = value.to(data.dtype)
    if value.shape == data.shape or value.numel() == 1:
        return torch.where(m, value.reshape(value.shape if value.shape ==
                                            data.shape else ()), data)
    return data.masked_scatter(m.expand(data.shape), value.reshape(-1))


@register("_npi_bernoulli", differentiable=False, state_binders=_RNG)
def _npi_bernoulli(prob=None, logit=None, size=None, ctx=None, dtype=None,
                   key=None):
    """Bernoulli draws of ``prob`` (or ``sigmoid(logit)``, or 0.5), of
    shape ``size`` (``prob``'s shape when None), on the context's device
    (or the probability tensor's)."""
    src = prob if isinstance(prob, torch.Tensor) else logit
    dev = src.device if isinstance(src, torch.Tensor) else _device(ctx)
    if prob is None and logit is None:
        p = torch.tensor(0.5, device=dev)
    elif prob is None:
        p = torch.sigmoid(torch.as_tensor(logit, device=dev).float())
    else:
        p = torch.as_tensor(prob, dtype=torch.float32, device=dev)
    shape = tuple(size) if size is not None else tuple(p.shape)
    u = torch.rand(shape, generator=generator_for(dev, key), device=dev)
    return (u < p).to(_dt(dtype))


@register("_npi_choice", differentiable=False, state_binders=_RNG)
def _npi_choice(a=None, size=None, replace=True, p=None, ctx=None,
                key=None, weights=None):
    """Draws from ``a`` (an int ``n``: ``arange(n)``, int64), uniformly or
    by the probabilities ``p``, with or without replacement."""
    is_pool = isinstance(a, torch.Tensor)
    dev = a.device if is_pool else _device(ctx)
    n = a.shape[0] if is_pool else int(a)
    shape = tuple(size or ())
    count = 1
    for s in shape:
        count *= int(s)
    gen = generator_for(dev, key)
    probs = p if p is not None else weights
    if probs is None and replace:
        idx = torch.randint(0, n, (count,), generator=gen, device=dev)
    elif probs is None:
        idx = torch.randperm(n, generator=gen, device=dev)[:count]
    else:
        w = torch.as_tensor(probs, device=dev).float()
        idx = torch.multinomial(w, count, replacement=bool(replace),
                                generator=gen)
    idx = idx.reshape(shape)
    return a[idx] if is_pool else idx


@register("_npi_multinomial", differentiable=False, state_binders=_RNG)
def _npi_multinomial(n=1, pvals=None, size=None, key=None):
    """Counts of ``n`` category draws by ``pvals``, shape ``size + (k,)``,
    int64."""
    p = pvals if isinstance(pvals, torch.Tensor) else \
        torch.as_tensor(pvals, dtype=torch.float64)
    dev = p.device if isinstance(pvals, torch.Tensor) else _device(None)
    p = p.to(dev).float().clamp(min=1e-30)
    k = p.shape[-1]
    shape = tuple(size or ())
    rows = 1
    for s in shape:
        rows *= int(s)
    draws = torch.multinomial(p.expand(rows, k), int(n), replacement=True,
                              generator=generator_for(dev, key))
    counts = torch.zeros((rows, k), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws))
    return counts.reshape(shape + (k,))


# ------------------------------------------------------------- aliases
# the reference's alias table (mxnet_tpu/ops/numpy_ops.py); an alias whose
# target the port does not have yet waits with it (ROIPooling, smooth_l1,
# _contrib_boolean_mask: tests/test_torch_op_faults.py lists them)

_NPI_ALIASES = {
    "linalg_inverse": ("_npi_inv",),
    "_contrib_boolean_mask": ("_npi_boolean_mask",),
    "activation": ("_npx_activation",),
    "batch_norm": ("_npx_batch_norm",),
    "convolution": ("_npx_convolution",),
    "deconvolution": ("_npx_deconvolution",),
    "dropout": ("_npx_dropout",),
    "fully_connected": ("_npx_fully_connected",),
    "layer_norm": ("_npx_layer_norm",),
    "LeakyReLU": ("_npx_leaky_relu",),
    "log_softmax": ("_npx_log_softmax",),
    "pooling": ("_npx_pooling",),
    "relu": ("_npx_relu",),
    "ROIPooling": ("_npx_roi_pooling",),
    "sigmoid": ("_npx_sigmoid",),
    "smooth_l1": ("_npx_smooth_l1",),
    "softmax": ("_npx_softmax",),
}


def register_aliases():
    """Register the table's aliases whose target exists (called once every
    op module has loaded)."""
    for target, names in _NPI_ALIASES.items():
        if get_op(target) is not None:
            register_alias(target, *names)
