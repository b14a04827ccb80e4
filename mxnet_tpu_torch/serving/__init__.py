"""Serving (counterpart of ``mxnet_tpu.serving``): ``/predict``
(``InferenceEngine``, ``DynamicBatcher``, ``ServingMetrics``) and
generation, behind ``ModelServer``."""
from .batcher import (DeadlineExceeded, DynamicBatcher, ServerBusy,
                      ServerClosed, ServingError)
from .engine import DEFAULT_BUCKETS, InferenceEngine
from .metrics import GenerationMetrics, ServingMetrics
from .server import ModelServer

__all__ = ["ModelServer", "InferenceEngine", "DEFAULT_BUCKETS",
           "DynamicBatcher", "ServingMetrics", "GenerationMetrics",
           "ServingError", "ServerBusy", "ServerClosed", "DeadlineExceeded"]
