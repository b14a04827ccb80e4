"""Host-side span tracing (counterpart of ``mxnet_tpu.observability``, the
:mod:`.tracer` module only)."""
from . import tracer

__all__ = ["tracer"]
