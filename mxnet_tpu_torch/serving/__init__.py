"""Serving (counterpart of ``mxnet_tpu.serving``): generation only."""
from .batcher import DeadlineExceeded, ServerBusy, ServerClosed, ServingError
from .metrics import GenerationMetrics
from .server import ModelServer

__all__ = ["ModelServer", "GenerationMetrics", "ServingError", "ServerBusy",
           "ServerClosed", "DeadlineExceeded"]
