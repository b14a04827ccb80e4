"""Model zoo: counterpart of ``mxnet_tpu.gluon.model_zoo`` (``vision``
and ``get_model``)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
