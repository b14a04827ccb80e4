"""Typed serving failures.

Counterpart of the error types of ``mxnet_tpu/serving/batcher.py`` that the
generation slice raises; the ``/predict`` batcher itself is not ported yet.
``ModelServer`` maps them to HTTP codes: ``ServerBusy`` and
``ServerClosed`` to 503, ``DeadlineExceeded`` to 504, any other
``ServingError`` before the first token to 400.
"""
from __future__ import annotations

__all__ = ["ServingError", "ServerBusy", "DeadlineExceeded", "ServerClosed"]


class ServingError(RuntimeError):
    """Base class for typed serving failures."""


class ServerBusy(ServingError):
    """Bounded request queue is full: shed load (HTTP 503)."""


class DeadlineExceeded(ServingError):
    """Request expired in queue before execution (HTTP 504)."""


class ServerClosed(ServingError):
    """The server is shut down and no longer accepts work."""
