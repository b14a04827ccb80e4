"""Engine control surface: counterpart of ``mxnet_tpu/engine.py``.

PyTorch's stream order is the engine: ops enqueue on the current CUDA
stream and run asynchronously. ``bulk`` and ``set_bulk_size`` are kept for
API parity (a scope that records the size and changes nothing), and
``MXNET_ENGINE_TYPE=NaiveEngine`` (or :func:`set_naive`) makes
``ops.registry.invoke`` synchronize after every op
(``torch.cuda.synchronize``), so that a device fault surfaces in the
statement that caused it.
"""
from __future__ import annotations

import contextlib

from . import config as _config

__all__ = ["bulk", "set_bulk_size", "is_naive", "set_naive"]

_bulk_size = [_config.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN")]
_naive = [_config.get("MXNET_ENGINE_TYPE") == "NaiveEngine"]


def set_bulk_size(size):
    """Set the bulk size; returns the previous one."""
    prev = _bulk_size[0]
    _bulk_size[0] = size
    return prev


@contextlib.contextmanager
def bulk(size):
    """Scope with a bulk size (API parity; dispatch is unchanged)."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def is_naive():
    return _naive[0]


def set_naive(flag=True):
    """Synchronize after every op (``MXNET_ENGINE_TYPE=NaiveEngine``)."""
    _naive[0] = bool(flag)
