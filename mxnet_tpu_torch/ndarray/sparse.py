"""Sparse NDArrays with compressed storage: counterpart of
``mxnet_tpu/ndarray/sparse.py``.

The compressed payload is the storage: a ``RowSparseNDArray`` holds
``values (nnz_rows, ...)`` and ``indices (nnz_rows,)``, a ``CSRNDArray``
``data (nnz,)``, ``indices (nnz,)`` and ``indptr (rows + 1,)``, as tensors
on one device. Every inherited ``NDArray`` method reads ``_data``, which
here is a dense view made on first use (one scatter) and cached. After a
write to ``_data``, rebound (``x[:] = ...``, ``+=``) or in place (SGD's
row update, a bound array's ``copy_``; seen by the view's version
counter), the dense value is the truth and the payload is compressed
again when next asked for.

The sparse paths never make the dense view:

- ``dot(csr, dense)``: a gather of the dense rows at the column indices,
  scaled by the values, and a sum over each row's segment;
- ``dot(csr.T, dense)``: the products sorted by column (a stable sort),
  then a sum over each column's segment; with ``forward_stype=
  "row_sparse"`` the result is a ``RowSparseNDArray`` over the touched
  columns only (MXNet 1.6's output storage), else dense (the reference's).
  Both sums are ``torch.segment_reduce``: each segment is added in order,
  with no atomics, so ``dot`` repeats bit for bit on the card (CUDA's
  ``index_add_`` would sum in an order that changes between runs);
- ``retain`` (its mask read on the host, as the reference's), ``add``
  of two row-sparse arrays, and the row-sparse SGD update
  (``optimizer.SGD`` with ``lazy_update``).

``.params`` files hold dense arrays only: ``save`` writes a sparse
array's dense value, and reading a file entry of sparse storage raises,
as the reference does.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import dtype_np, torch_dtype
from ..context import Context
from .ndarray import NDArray, _device, array as _dense_array, \
    zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
           "dot", "retain", "add"]


def _as_tensor(x, device, dtype=None):
    if isinstance(x, NDArray):
        x = x._data
    t = x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(_np.asarray(x))
    t = t.detach().to(device)
    return t if dtype is None else t.to(dtype)


def _payload_values(x, device, dtype):
    """Stored values as a tensor on ``device``: in ``dtype`` when given,
    else in their own (a Python list of floats as float32, MXNet's
    default)."""
    if dtype is None and isinstance(x, (list, tuple)):
        dtype = "float32"
    return _as_tensor(x, device, None if dtype is None else torch_dtype(dtype))


def _source_device(x, ctx):
    if ctx is not None or not isinstance(x, (torch.Tensor, NDArray)):
        return _device(ctx)
    return (x._data if isinstance(x, NDArray) else x).device


def _compress_rows(dense):
    """A dense tensor as ``(values, indices)`` of its nonzero rows."""
    nz = torch.nonzero(dense.reshape(dense.shape[0], -1).ne(0).any(1))[:, 0]
    return dense.index_select(0, nz), nz


def _compress_csr(dense):
    if dense.dim() != 2:
        raise ValueError("csr requires 2D")
    rows, cols = torch.nonzero(dense, as_tuple=True)
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=dense.shape[0]),
                              0)
    return dense[rows, cols], cols, indptr


class BaseSparseNDArray(NDArray):
    """A dense view made on first use of ``_data`` and cached; the
    subclasses keep their payloads (``_stored``, ``_store``, ``_compress``
    and ``_densify``). ``_synced`` is the view's version counter when it
    last agreed with the payload."""
    __slots__ = ("_dense_cache", "_synced", "_shape_", "_dtype_",
                 "_device_")

    def _init_handle(self, shape, dtype, device, stype):
        self._shape_ = tuple(int(s) for s in shape)
        self._dtype_ = dtype
        self._device_ = device
        self._dense_cache = None
        self._synced = None
        self._grad = None
        self._grad_req = "null"
        self._leaf = False
        self._bound = False
        self._pass_grad = None
        self._stype = stype

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._densify()
            self._synced = self._dense_cache._version
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        self._dense_cache = value
        self._shape_ = tuple(value.shape)
        self._dtype_ = value.dtype
        self._device_ = value.device
        self._store(None)

    def _payload(self):
        """The compressed payload, compressed again from the dense view
        when that was written since the two last agreed."""
        if self._stored() is None or (
                self._dense_cache is not None
                and self._dense_cache._version != self._synced):
            self._store(self._compress(self._dense_cache))
            self._synced = self._dense_cache._version
        return self._stored()

    @property
    def shape(self):
        return self._shape_

    @property
    def ndim(self):
        return len(self._shape_)

    @property
    def size(self):
        return int(_np.prod(self._shape_))

    @property
    def dtype(self):
        return dtype_np(self._dtype_)

    @property
    def ctx(self):
        return Context.from_device(self._device_)

    context = ctx

    def tostype(self, stype):
        return _to_stype(self, stype)


class RowSparseNDArray(BaseSparseNDArray):
    """``values[nnz_rows, ...]`` at the rows ``indices[nnz_rows]``."""
    __slots__ = ("_values", "_idx")

    def __init__(self, values, indices, shape, ctx=None, dtype=None):
        dev = _source_device(values, ctx)
        v = _payload_values(values, dev, dtype)
        self._init_handle(shape, v.dtype, dev, "row_sparse")
        self._values = v.reshape((v.shape[0],) + self._shape_[1:])
        self._idx = _as_tensor(indices, dev, torch.int64).reshape(-1)

    def _densify(self):
        out = torch.zeros(self._shape_, dtype=self._dtype_,
                          device=self._device_)
        if self._values.shape[0]:
            out.index_copy_(0, self._idx, self._values.to(self._dtype_))
        return out

    def _stored(self):
        return None if self._values is None else (self._values, self._idx)

    def _store(self, payload):
        self._values, self._idx = payload or (None, None)

    @staticmethod
    def _compress(dense):
        return _compress_rows(dense)

    @property
    def indices(self):
        return NDArray(self._payload()[1])

    @property
    def data(self):
        return NDArray(self._payload()[0])

    def copy(self):
        v, i = self._payload()
        return RowSparseNDArray(v.clone(), i.clone(), self._shape_)

    def __repr__(self):
        return "<RowSparseNDArray %s @%s>" % (
            "x".join(map(str, self._shape_)), self.ctx)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows: ``data[nnz]`` at the columns
    ``indices[nnz]``, row ``r``'s entries at ``indptr[r]:indptr[r+1]``."""
    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr")

    def __init__(self, data, indices, indptr, shape, ctx=None, dtype=None):
        dev = _source_device(data, ctx)
        v = _payload_values(data, dev, dtype)
        self._init_handle(shape, v.dtype, dev, "csr")
        self._csr_data = v.reshape(-1)
        self._csr_indices = _as_tensor(indices, dev, torch.int64).reshape(-1)
        self._csr_indptr = _as_tensor(indptr, dev, torch.int64).reshape(-1)

    def _row_ids(self, payload=None):
        """The row of every stored value."""
        data, _, indptr = payload or self._payload()
        return torch.repeat_interleave(
            torch.arange(self._shape_[0], device=self._device_),
            torch.diff(indptr), output_size=data.shape[0])

    def _densify(self):
        out = torch.zeros(self._shape_, dtype=self._dtype_,
                          device=self._device_)
        if self._csr_data.shape[0]:
            out[self._row_ids(self._stored()), self._csr_indices] = \
                self._csr_data.to(self._dtype_)
        return out

    def _stored(self):
        return None if self._csr_data is None else (
            self._csr_data, self._csr_indices, self._csr_indptr)

    def _store(self, payload):
        (self._csr_data, self._csr_indices,
         self._csr_indptr) = payload or (None, None, None)

    @staticmethod
    def _compress(dense):
        return _compress_csr(dense)

    @property
    def data(self):
        return NDArray(self._payload()[0])

    @property
    def indices(self):
        return NDArray(self._payload()[1])

    @property
    def indptr(self):
        return NDArray(self._payload()[2])

    def copy(self):
        d, i, p = self._payload()
        return CSRNDArray(d.clone(), i.clone(), p.clone(), self._shape_)

    def __repr__(self):
        return "<CSRNDArray %s @%s>" % ("x".join(map(str, self._shape_)),
                                        self.ctx)


def _to_stype(arr, stype):
    """``arr`` in storage ``stype`` (a copy, as ``cast_storage`` is)."""
    if stype == arr.stype and isinstance(arr, BaseSparseNDArray):
        return arr.copy()
    if stype == "default":
        return NDArray(arr._data.detach().clone())
    if stype == "row_sparse":
        v, i = _compress_rows(arr._data.detach())
        return RowSparseNDArray(v, i, arr.shape)
    if stype == "csr":
        if arr.ndim != 2:
            raise ValueError("csr requires 2D")
        d, i, p = _compress_csr(arr._data.detach())
        return CSRNDArray(d, i, p, arr.shape)
    raise ValueError("unknown stype %r" % stype)


# ---- constructors ----------------------------------------------------------

def _dense_source(arg1, ctx, dtype):
    src = arg1 if isinstance(arg1, NDArray) else \
        NDArray(arg1, ctx=ctx, dtype=dtype)
    if ctx is not None:
        src = src.as_in_context(ctx)
    return src if dtype is None else src.astype(dtype)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from ``(data, indices, indptr)`` or from a dense
    array (an NDArray, numpy array or nested list)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        indices = _np.asarray(indices.asnumpy() if isinstance(indices, NDArray)
                              else indices, dtype=_np.int64)
        indptr = _np.asarray(indptr.asnumpy() if isinstance(indptr, NDArray)
                             else indptr, dtype=_np.int64)
        n_cols = shape[1] if shape else \
            (int(indices.max()) + 1 if indices.size else 0)
        return CSRNDArray(data, indices, indptr, (len(indptr) - 1, n_cols),
                          ctx=ctx, dtype=dtype)
    if isinstance(arg1, CSRNDArray):
        return arg1.copy()
    return _to_stype(_dense_source(arg1, ctx, dtype), "csr")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from ``(data, indices)`` or from a dense
    array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if isinstance(data, (list, tuple)):
            data = _np.asarray(data, dtype=_np.float32 if dtype is None
                               else dtype_np(dtype))
        indices = _np.asarray(indices.asnumpy() if isinstance(indices, NDArray)
                              else indices, dtype=_np.int64)
        dshape = tuple(data.shape)
        if shape:
            full_shape = tuple(shape)
            if _np.prod(dshape) and dshape[1:] != full_shape[1:]:
                raise ValueError("data shape %s inconsistent with shape %s"
                                 % (dshape, full_shape))
            if not _np.prod(dshape):
                data = _np.zeros((0,) + full_shape[1:], dtype=_np.float32
                                 if dtype is None else dtype_np(dtype))
        else:
            n_rows = int(indices.max()) + 1 if indices.size else 0
            full_shape = (n_rows,) + dshape[1:]
        return RowSparseNDArray(data, indices, full_shape, ctx=ctx,
                                dtype=dtype)
    if isinstance(arg1, RowSparseNDArray):
        return arg1.copy()
    return _to_stype(_dense_source(arg1, ctx, dtype), "row_sparse")


def zeros(stype, shape, ctx=None, dtype=None):
    dt = torch_dtype(dtype or "float32")
    dev = _device(ctx)
    if stype == "row_sparse":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros(0, dtype=torch.int64, device=dev), shape)
    if stype == "csr":
        shape = tuple(shape)
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                          torch.zeros(0, dtype=torch.int64, device=dev),
                          torch.zeros(shape[0] + 1, dtype=torch.int64,
                                      device=dev), shape)
    return _dense_zeros(shape, ctx=ctx, dtype=dtype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """A copy that keeps the source's storage type."""
    if isinstance(source_array, CSRNDArray):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    if isinstance(source_array, RowSparseNDArray):
        return row_sparse_array(source_array, ctx=ctx, dtype=dtype)
    return _dense_array(source_array, ctx=ctx, dtype=dtype)


# ---- compute on the payloads ----------------------------------------------

def _segment_sum(values, lengths):
    """Each segment's rows added in order (no atomics)."""
    if values.shape[0] == 0:
        return values.new_zeros((lengths.shape[0],) + values.shape[1:])
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """A product with a sparse operand:

    - ``csr @ dense``: dense ``(rows, k)``, each row the in-order sum of
      its stored values times the dense rows at their columns;
    - ``csr.T @ dense`` (``transpose_a``): the products sorted by column,
      each column's summed in order; dense ``(cols, k)``, or with
      ``forward_stype="row_sparse"`` a ``RowSparseNDArray`` of the
      columns that hold a value;
    - anything else: the dense product of the dense views.

    A vector ``rhs`` gives a vector."""
    if isinstance(lhs, CSRNDArray) and not transpose_b:
        data, indices, indptr = lhs._payload()
        rv = rhs._data if isinstance(rhs, NDArray) else torch.as_tensor(rhs)
        vec = rv.dim() == 1
        if vec:
            rv = rv[:, None]
        if not transpose_a:
            prod = rv.index_select(0, indices) * data[:, None].to(rv.dtype)
            out = _segment_sum(prod, torch.diff(indptr))
            return NDArray(out[:, 0] if vec else out)
        order = torch.sort(indices, stable=True).indices
        cols = indices.index_select(0, order)
        prod = rv.index_select(0, lhs._row_ids().index_select(0, order)) \
            * data.index_select(0, order)[:, None].to(rv.dtype)
        if forward_stype == "row_sparse":
            touched, counts = torch.unique_consecutive(cols,
                                                       return_counts=True)
            vals = _segment_sum(prod, counts)
            shape = (lhs.shape[1],) + tuple(rv.shape[1:])
            if vec:
                vals, shape = vals[:, 0], shape[:1]
            return RowSparseNDArray(vals, touched, shape)
        counts = torch.bincount(cols, minlength=lhs.shape[1])
        out = _segment_sum(prod, counts)
        return NDArray(out[:, 0] if vec else out)
    lv = lhs._data if isinstance(lhs, NDArray) else torch.as_tensor(lhs)
    rv = rhs._data if isinstance(rhs, NDArray) else torch.as_tensor(rhs)
    if transpose_a:
        lv = lv.t()
    if transpose_b:
        rv = rv.t()
    return NDArray(torch.matmul(lv, rv))


def retain(data, indices):
    """The rows of a ``RowSparseNDArray`` whose index is in ``indices``
    (the mask is read on the host)."""
    if not isinstance(data, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    keep = indices._data if isinstance(indices, NDArray) else \
        torch.as_tensor(_np.asarray(indices))
    values, idx = data._payload()
    keep = keep.to(idx.device, torch.int64)
    mask = (idx[:, None] == keep[None, :]).any(1)
    kept = torch.from_numpy(_np.where(mask.cpu().numpy())[0]).to(idx.device)
    return RowSparseNDArray(values.index_select(0, kept),
                            idx.index_select(0, kept), data.shape)


def add(lhs, rhs):
    """Elementwise sum; two row-sparse arrays give a row-sparse one over
    the union of their rows."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        lv, li = lhs._payload()
        rv, ri = rhs._payload()
        idx = torch.unique(torch.cat([li, ri]))
        out = torch.zeros((idx.shape[0],) + lhs.shape[1:],
                          dtype=lhs._dtype_, device=lv.device)
        out.index_add_(0, torch.searchsorted(idx, li), lv)
        out.index_add_(0, torch.searchsorted(idx, ri), rv.to(lhs._dtype_))
        return RowSparseNDArray(out, idx, lhs.shape)
    lv = lhs._data if isinstance(lhs, NDArray) else lhs
    rv = rhs._data if isinstance(rhs, NDArray) else rhs
    return NDArray(lv + rv)
