"""Base utilities: errors, numeric type tuples and dtype names.

Counterpart of ``mxnet_tpu/base.py`` (a copy, over torch dtypes as well as
numpy ones): ``MXNetError``, ``numeric_types``, ``string_types``,
``integer_types``, :func:`dtype_np`, :func:`dtype_name` and
:func:`torch_dtype`. numpy has no bfloat16; :func:`dtype_np` gives
``ml_dtypes.bfloat16`` where that package is installed, and
``torch.bfloat16`` otherwise.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = [
    "MXNetError", "string_types", "numeric_types", "integer_types",
    "dtype_np", "dtype_name", "torch_dtype", "_as_list",
]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


string_types = (str,)
numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)

_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bf16": "bfloat16",
}

_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAME = {v: k for k, v in _TORCH.items()}


def dtype_name(dtype) -> str:
    """The canonical name (``"float32"``, ``"bfloat16"``, ...) of a dtype
    given as a name, a numpy dtype or type, a ``torch.dtype``, or an array
    that has one; None is ``"float32"``."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    if isinstance(dtype, str):
        return _DTYPE_ALIASES.get(dtype, dtype)
    if not isinstance(dtype, type) and hasattr(dtype, "dtype"):
        return dtype_name(dtype.dtype)
    return _np.dtype(dtype).name


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (any form :func:`dtype_name` takes) as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[dtype_name(dtype)]


def dtype_np(dtype):
    """``dtype`` as a numpy dtype (bfloat16: see the module docstring)."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            return torch.bfloat16
        return _np.dtype(ml_dtypes.bfloat16)
    return _np.dtype(name)


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]
