"""jnp's semantics on torch tensors, where torch's differ.

The reference runs with ``jax_enable_x64`` on and takes jnp's rules as
they are. Three of them matter to the ops and to ``mx.np``:

- **Result dtypes** (:func:`result_dtype`, the one function that decides
  them): jnp's type-promotion lattice, in which a Python ``int`` or
  ``float`` is *weak* (it takes the other operand's kind where it can:
  ``int32 + 1`` is int32, ``int32 + 1.5`` float64, ``float16 + 2.5``
  float16) and integers meet floats at the float (``int64 + float16`` is
  float16); a weak result canonicalizes to int64 or float64. On top of
  the lattice, each op family has a rule: ``"inexact"`` (divide, sqrt,
  mean, ...: booleans and integers of up to 32 bits become float32,
  64-bit ones float64), ``"numeric"`` (mod, power, square: a boolean
  result becomes int32), ``"sum"`` (sum, prod, trace: booleans and
  signed integers become int64, unsigned ones uint64), ``"accumulate"``
  (cumsum, cumprod: booleans become int64), ``"bool"`` and ``"index"``
  (int64).
- **Float-to-integer casts** (:func:`astype`) saturate at the integer's
  range, truncate toward zero and send NaN to 0, where torch's wrap.
- **Out-of-range gather indices** (:func:`take_fill`, :func:`clip_index`):
  ``jnp.take`` and ``take_along_axis`` wrap an index in ``[-n, 0)`` and
  fill the others (NaN for floats, the most negative value for signed
  integers, the largest for unsigned ones, True for booleans); array
  indexing (``x[idx]``) clamps. An out-of-range scatter update is
  dropped (:func:`scatter_mask`). Torch raises on all of these.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from ..base import dtype_name, torch_dtype

__all__ = ["result_dtype", "operand_kind", "lub", "to_inexact", "astype",
           "take_fill", "clip_index", "fill_value", "scatter_mask"]

# jax/_src/dtypes.py's "standard" lattice; "i*" and "f*" are the weak
# Python int and float
_LATTICE = {
    "bool": ("i*",), "i*": ("uint8", "int8"),
    "uint8": ("int16", "uint16"), "uint16": ("int32", "uint32"),
    "uint32": ("int64", "uint64"), "uint64": ("f*",),
    "int8": ("int16",), "int16": ("int32",), "int32": ("int64",),
    "int64": ("f*",), "f*": ("bfloat16", "float16"),
    "bfloat16": ("float32",), "float16": ("float32",),
    "float32": ("float64",), "float64": (),
}
_CANONICAL = {"i*": "int64", "f*": "float64"}
_INEXACT = {"bool": "float32", "uint8": "float32", "int8": "float32",
            "uint16": "float32", "int16": "float32", "uint32": "float32",
            "int32": "float32", "int64": "float64", "uint64": "float64",
            "i*": "float64", "f*": "float64"}


@functools.lru_cache(maxsize=None)
def _above(kind):
    out = {kind}
    for nxt in _LATTICE[kind]:
        out |= _above(nxt)
    return frozenset(out)


@functools.lru_cache(maxsize=None)
def _lub(kinds):
    common = functools.reduce(frozenset.intersection,
                              (_above(k) for k in kinds))
    return next(k for k in common if common <= _above(k))


def operand_kind(x):
    """The lattice element of an operand: a dtype name for a tensor, an
    NDArray, a numpy array or scalar, a dtype or a dtype name; ``"i*"`` or
    ``"f*"`` for a Python int or float; None for None."""
    if x is None:
        return None
    if hasattr(x, "_data") and isinstance(getattr(x, "_data"), torch.Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return dtype_name(x.dtype)
    if isinstance(x, (bool, _np.bool_)):
        return "bool"
    if isinstance(x, int):
        return "i*"
    if isinstance(x, float):
        return "f*"
    if isinstance(x, (_np.ndarray, _np.generic)):
        return dtype_name(x.dtype)
    if isinstance(x, (list, tuple)):
        return operand_kind(_np.asarray(x))
    return dtype_name(x)


def lub(*kinds):
    """The least upper bound of lattice elements (weak ones kept)."""
    kinds = tuple(k for k in kinds if k is not None)
    return _lub(kinds) if len(kinds) > 1 else kinds[0]


def to_inexact(kind):
    return _INEXACT.get(kind, kind)


def result_dtype(rule, *operands):
    """The reference's dtype (a ``torch.dtype``) of an op of family
    ``rule`` (see the module docstring; ``"promote"`` is the lattice
    alone) on ``operands``."""
    if rule == "bool":
        return torch.bool
    if rule == "index":
        return torch.int64
    kind = lub(*(operand_kind(x) for x in operands))
    if rule == "inexact":
        kind = to_inexact(kind)
    kind = _CANONICAL.get(kind, kind)
    if rule == "numeric" and kind == "bool":
        kind = "int32"
    elif rule == "sum":
        if kind in ("bool", "int8", "int16", "int32"):
            kind = "int64"
        elif kind in ("uint8", "uint16", "uint32"):
            kind = "uint64"
    elif rule == "accumulate" and kind == "bool":
        kind = "int64"
    return torch_dtype(kind)


# ---- casts ----------------------------------------------------------------

def astype(x, dtype):
    """``x.astype(dtype)`` as jnp casts: float to integer saturates at the
    integer's range, truncates and sends NaN to 0; to bool is ``!= 0``."""
    dtype = torch_dtype(dtype)
    if x.dtype == dtype:
        return x
    if dtype == torch.bool:
        return x != 0
    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        wide = x.double()
        hi = float(info.max) if info.bits < 64 else 9.223372036854774784e18
        wide = torch.nan_to_num(wide, nan=0.0).trunc().clamp(
            float(info.min), hi)
        return wide.to(dtype)
    return x.to(dtype)


# ---- gathers and scatters -------------------------------------------------

def fill_value(dtype):
    """What ``jnp.take``'s "fill" mode puts at an out-of-range index."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_fill(x, idx, axis):
    """``jnp.take_along_axis(x, idx, axis)`` in its default mode: ``idx``
    (broadcast against ``x`` off ``axis``) wraps in ``[-n, 0)`` and fills
    outside ``[-n, n)``."""
    n = x.shape[axis]
    idx = idx.long()
    ok = (idx >= -n) & (idx < n)
    safe = torch.where(ok, torch.where(idx < 0, idx + n, idx),
                       torch.zeros((), dtype=idx.dtype, device=idx.device))
    shape = list(_np.broadcast_shapes(tuple(x.shape), tuple(idx.shape)))
    shape[axis] = idx.shape[axis]
    xs = list(shape)
    xs[axis] = n
    got = torch.gather(x.expand(xs), axis, safe.expand(shape))
    fill = torch.full((), fill_value(x.dtype), dtype=x.dtype,
                      device=x.device)
    return torch.where(ok.expand(shape), got, fill)


def clip_index(idx, n):
    """An index array as ``x[idx]`` reads it in jnp: negative ones wrap
    once, then every index clamps to ``[0, n)``."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def scatter_mask(idx, n):
    """The wrapped index and whether the update lands (an index outside
    ``[-n, n)`` is dropped, as jnp's scatters drop it)."""
    idx = idx.long()
    ok = (idx >= -n) & (idx < n)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1), ok


# ---- basic indexing -------------------------------------------------------
#
# jnp reads ``x[key]`` with every integer clamped into its axis (a negative
# one wrapped once) and takes slices with a negative step; it drops a write
# whose integer index lies outside ``[-n, n)``. Torch raises on both. The
# helpers below rewrite a key for torch: a slice with a negative step
# becomes the positive-step slice that reads the same elements of the axis
# flipped, so the read is ``x.flip(axes)[key]`` and a write goes through a
# flipped copy; an out-of-range index of a write points at a spare slot
# appended to its axis and cut off again.


def _key_parts(key):
    return key if isinstance(key, tuple) else (key,)


def _is_int(k):
    return isinstance(k, (int, _np.integer)) and not isinstance(
        k, (bool, _np.bool_))


def _flipped_slice(s, n):
    """The positive-step slice of the flipped axis that holds the
    elements of ``s`` (a negative step) in the same order."""
    start, stop, step = s.indices(n)
    count = len(range(start, stop, step))
    if count == 0:
        return slice(0, 0)
    first = n - 1 - start
    return slice(first, first + (count - 1) * -step + 1, -step)


def _walk(shape, key):
    """``(part, axis)`` for each part of ``key``: the axis of ``shape``
    the part indexes (None for ``None`` and ``Ellipsis``)."""
    parts = tuple(torch.as_tensor(k) if isinstance(k, (list, _np.ndarray))
                  else k for k in _key_parts(key))
    used = sum(k.dim() if isinstance(k, torch.Tensor) and
               k.dtype == torch.bool else 0 if k is None or k is Ellipsis
               else 1 for k in parts)
    axis = 0
    for k in parts:
        if k is Ellipsis:
            yield k, None
            axis += len(shape) - used
        elif k is None:
            yield k, None
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            yield k, None
            axis += k.dim()
        else:
            yield k, axis
            axis += 1


def read_key(shape, key):
    """``(flip_axes, key)``: ``x[key]`` in jnp equals
    ``x.flip(flip_axes)[key]`` in torch with the returned key."""
    out, flips = [], []
    for k, axis in _walk(shape, key):
        n = shape[axis] if axis is not None and axis < len(shape) else 0
        if axis is None or n == 0:
            pass
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            k = _flipped_slice(k, n)
            flips.append(axis)
        elif _is_int(k):
            k = min(max(int(k) + n if k < 0 else int(k), 0), n - 1)
        elif isinstance(k, torch.Tensor) and not k.is_floating_point():
            k = clip_index(k, n)
        out.append(k)
    return tuple(flips), tuple(out)


def getitem(x, key):
    """``x[key]`` with jnp's basic-indexing semantics (see above)."""
    flips, key = read_key(tuple(x.shape), key)
    return (x.flip(flips) if flips else x)[key]


def setitem(x, key, value):
    """``x[key] = value`` in place, with jnp's semantics: negative steps
    taken, a write at an out-of-range integer index dropped."""
    shape = tuple(x.shape)
    out, flips, spare = [], [], []
    for k, axis in _walk(shape, key):
        n = shape[axis] if axis is not None and axis < len(shape) else 0
        if axis is None or n == 0:
            pass
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            k = _flipped_slice(k, n)
            flips.append(axis)
        elif _is_int(k):
            if not -n <= k < n:
                k = n
                spare.append(axis)
            else:
                k = int(k) % n
        elif isinstance(k, torch.Tensor) and not k.is_floating_point():
            safe, ok = scatter_mask(k, n)
            k = torch.where(ok, safe, torch.full_like(safe, n))
            spare.append(axis)
        out.append(k)
    out = tuple(out)
    if not flips and not spare:
        x[out] = value
        return
    work = x.flip(flips) if flips else x.clone()
    for axis in sorted(set(spare)):
        pad = list(work.shape)
        pad[axis] = 1
        work = torch.cat([work, work.new_zeros(pad)], dim=axis)
    work[out] = value
    for axis in sorted(set(spare)):
        work = work.narrow(axis, 0, shape[axis])
    x.copy_(work.flip(flips) if flips else work)
