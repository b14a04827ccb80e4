"""``mx.nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``):
``nd.linalg.<name>`` is the registry's ``linalg_<name>`` op (or ``<name>``
itself), so ``nd.linalg.gemm2`` is ``nd.linalg_gemm2``."""
from ..ops.registry import get_op as _get_op


def __getattr__(name):
    op = _get_op("linalg_" + name) or _get_op(name)
    if op is None:
        raise AttributeError("no linalg operator %r" % name)
    return op
