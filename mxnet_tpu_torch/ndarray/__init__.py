"""The ``nd`` namespace (counterpart of ``mxnet_tpu.ndarray``):
:class:`NDArray`, its constructors, ``save``/``load`` over the
``.params`` container (:mod:`.serialization`), and every registered op,
generated from the registry as the reference generates its namespace."""
from .. import ops as _ops
from ..ops.registry import get_op as _get_op
from . import contrib, linalg, random  # noqa: F401
from .ndarray import (NDArray, arange, array, concat, empty, eye, from_dlpack,
                      from_numpy, full, load, ones, save, stack,
                      to_dlpack_for_read, to_dlpack_for_write, waitall, zeros)
from .serialization import is_mxnet_binary, load_ndarrays, save_ndarrays

_ops.populate_namespace(globals())


def __getattr__(name):
    op = _get_op(name)
    if op is None:
        raise AttributeError("module 'mxnet_tpu_torch.ndarray' has no "
                             "attribute %r" % name)
    return op
