"""The ``nd`` namespace (counterpart of ``mxnet_tpu.ndarray``):
:class:`NDArray`, its constructors, ``save``/``load`` over the
``.params`` container (:mod:`.serialization`), ``sparse`` (compressed
storage), ``Custom`` (a registered Python custom op, tensor inputs by
keyword too), and every registered op, generated from the registry as the
reference generates its namespace."""
from .. import ops as _ops
from ..ops.registry import get_op as _get_op
from . import contrib, linalg, random, sparse  # noqa: F401
from .ndarray import (NDArray, arange, array, concat, empty, eye, from_dlpack,
                      from_numpy, full, load, ones, save, stack,
                      to_dlpack_for_read, to_dlpack_for_write, waitall, zeros)
from .serialization import is_mxnet_binary, load_ndarrays, save_ndarrays

_ops.populate_namespace(globals())


def Custom(*args, **kwargs):
    """Run a registered Python custom op (``mxnet_tpu_torch.operator``);
    tensor inputs may be given by keyword (``Custom(data=x,
    op_type=...)``)."""
    from ..operator import normalize_custom_args
    tensors, call_kwargs = normalize_custom_args(args, kwargs)
    call_kwargs.pop("name", None)
    return _get_op("Custom")(*tensors, **call_kwargs)


def __getattr__(name):
    op = _get_op(name)
    if op is None:
        raise AttributeError("module 'mxnet_tpu_torch.ndarray' has no "
                             "attribute %r" % name)
    return op
