"""The contrib namespace (counterpart of ``mxnet_tpu.contrib``):
``quantization`` (post-training INT8) and ``graph`` (graph ops over
``CSRNDArray``)."""
from . import graph, quantization  # noqa: F401

__all__ = ["graph", "quantization"]
