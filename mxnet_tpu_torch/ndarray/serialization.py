"""MXNet-binary NDArray serialization.

Byte-compatible reader/writer for the reference ``.params`` / ``.nd`` container
(reference ``src/ndarray/ndarray.cc:1591-1852`` NDArray::Save/Load, dmlc::Stream
serializer framing).  Layout (all little-endian):

    uint64  header   = 0x112 (kMXAPINDArrayListMagic)
    uint64  reserved = 0
    uint64  count                       # vector<NDArray>
    count × NDArray record:
        uint32  magic = 0xF993fac9      # NDARRAY_V2_MAGIC (storage-type aware)
        int32   stype = 0               # kDefaultStorage (dense)
        int32   ndim; ndim × int64 dims # TShape::Save (tuple.h:704)
        int32   dev_type; int32 dev_id  # Context::Save (base.h:157)
        int32   type_flag               # mshadow/base.h:307 dtype enum
        raw data bytes (C order)
    uint64  count                       # vector<string> names
    count × (uint64 len; len bytes)

Legacy V1 (0xF993fac8, int64 dims) and pre-V1 (magic == ndim, uint32 dims)
records are also read, as is V3 (np-shape semantics, zero-size shapes kept).

The port's copy of ``mxnet_tpu/ndarray/serialization.py``: the same
functions, writing the same bytes. :func:`save_ndarrays` also takes torch
tensors (a bf16 tensor is written as float32, as the reference writes a
bf16 array).
"""
import struct

import numpy as np
import torch

__all__ = ["save_ndarrays", "load_ndarrays", "is_mxnet_binary"]

NDARRAY_LIST_MAGIC = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA

# mshadow type_flag <-> numpy dtype (reference 3rdparty/mshadow/mshadow/base.h:307)
_FLAG_TO_DTYPE = {
    0: np.dtype("float32"),
    1: np.dtype("float64"),
    2: np.dtype("float16"),
    3: np.dtype("uint8"),
    4: np.dtype("int32"),
    5: np.dtype("int8"),
    6: np.dtype("int64"),
    7: np.dtype("bool"),
}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}


def _dtype_flag(dtype):
    dtype = np.dtype(dtype)
    flag = _DTYPE_TO_FLAG.get(dtype)
    if flag is None:
        raise TypeError(
            "dtype %s has no MXNet binary type_flag; cast first "
            "(bfloat16 arrays should be saved as float32)" % dtype)
    return flag


def _host(a):
    """``a`` as a numpy array: a torch tensor is copied to the host (bf16
    as float32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return a


def _write_ndarray(fo, arr):
    arr = np.asarray(arr, order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 — container has no flag for it
        arr = arr.astype(np.float32)
    # A V2 record with ndim==0 is the none-sentinel; genuine 0-d arrays only
    # exist under np-shape semantics, so emit a V3 record for them
    # (reference ndarray.cc:1592-1600).
    magic = NDARRAY_V3_MAGIC if arr.ndim == 0 else NDARRAY_V2_MAGIC
    fo.write(struct.pack("<I", magic))
    fo.write(struct.pack("<i", 0))                      # kDefaultStorage
    fo.write(struct.pack("<i", arr.ndim))
    fo.write(struct.pack("<%dq" % arr.ndim, *arr.shape))
    fo.write(struct.pack("<ii", 1, 0))                  # Context::CPU()
    fo.write(struct.pack("<i", _dtype_flag(arr.dtype)))
    fo.write(arr.tobytes())


def _read_exact(fi, n):
    buf = fi.read(n)
    if len(buf) != n:
        raise ValueError("invalid NDArray file format: truncated stream")
    return buf


def _read_shape(fi, dim_size):
    """Returns the dims tuple, or None for an unknown shape (ndim == -1,
    the reference's none/np-shape-unknown sentinel)."""
    (ndim,) = struct.unpack("<i", _read_exact(fi, 4))
    if ndim == -1:
        return None
    if ndim < 0 or ndim > 32:
        raise ValueError("invalid NDArray file format: bad ndim %d" % ndim)
    fmt = {8: "<%dq", 4: "<%dI"}[dim_size] % ndim
    return struct.unpack(fmt, _read_exact(fi, dim_size * ndim))


def _read_ndarray(fi):
    (magic,) = struct.unpack("<I", _read_exact(fi, 4))
    if magic in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        (stype,) = struct.unpack("<i", _read_exact(fi, 4))
        if stype != 0:
            raise NotImplementedError(
                "sparse storage type %d in binary file not supported" % stype)
        shape = _read_shape(fi, 8)
        if shape is None or (magic == NDARRAY_V2_MAGIC and len(shape) == 0):
            return np.zeros((), dtype=np.float32)  # is_none() sentinel
    elif magic == NDARRAY_V1_MAGIC:
        shape = _read_shape(fi, 8)
        if shape is None or len(shape) == 0:
            return np.zeros((), dtype=np.float32)
    else:
        # pre-V1 legacy: magic itself is ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise ValueError("invalid NDArray file format: bad magic 0x%x" % magic)
        shape = struct.unpack("<%dI" % ndim, _read_exact(fi, 4 * ndim))
        if ndim == 0:
            return np.zeros((), dtype=np.float32)
    _read_exact(fi, 8)  # Context (dev_type, dev_id) — always load to host
    (type_flag,) = struct.unpack("<i", _read_exact(fi, 4))
    dtype = _FLAG_TO_DTYPE.get(type_flag)
    if dtype is None:
        raise ValueError("unknown type_flag %d" % type_flag)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    data = _read_exact(fi, dtype.itemsize * size)
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def save_ndarrays(fname, arrays, names=None):
    """Write arrays in the reference binary list container.

    ``arrays`` items may be numpy arrays or torch tensors (host transfer
    happens one array at a time inside the write loop, so peak host memory
    is one array, not the whole checkpoint).  ``names``
    may be None/empty (positional list semantics, reference mx.nd.save of
    a list)."""
    names = list(names) if names else []
    if names and len(names) != len(arrays):
        raise ValueError("names/arrays length mismatch")
    with open(fname, "wb") as fo:
        fo.write(struct.pack("<QQ", NDARRAY_LIST_MAGIC, 0))
        fo.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_ndarray(fo, _host(a))
        fo.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            fo.write(struct.pack("<Q", len(b)))
            fo.write(b)


def load_ndarrays(fname):
    """Read the reference binary list container -> (list[np.ndarray], list[str])."""
    with open(fname, "rb") as fi:
        header, _reserved = struct.unpack("<QQ", _read_exact(fi, 16))
        if header != NDARRAY_LIST_MAGIC:
            raise ValueError("invalid NDArray file format: bad header 0x%x" % header)
        (count,) = struct.unpack("<Q", _read_exact(fi, 8))
        arrays = [_read_ndarray(fi) for _ in range(count)]
        (nname,) = struct.unpack("<Q", _read_exact(fi, 8))
        names = []
        for _ in range(nname):
            (ln,) = struct.unpack("<Q", _read_exact(fi, 8))
            names.append(_read_exact(fi, ln).decode("utf-8"))
        if names and len(names) != len(arrays):
            raise ValueError("invalid NDArray file format: name count mismatch")
        return arrays, names


def is_mxnet_binary(fname):
    """True when ``fname`` starts with the list container's magic."""
    try:
        with open(fname, "rb") as fi:
            head = fi.read(8)
        return len(head) == 8 and struct.unpack("<Q", head)[0] == NDARRAY_LIST_MAGIC
    except OSError:
        return False
