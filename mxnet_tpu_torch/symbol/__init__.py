"""The ``sym`` namespace (counterpart of ``mxnet_tpu.symbol``):
:class:`Symbol`, ``var``, ``Group``, ``load``, ``AttrScope``, the
subgraph backends (``subgraph``) and a symbolic constructor for every
registered op, generated from the registry as the ``nd`` namespace
is."""
from . import contrib, subgraph  # noqa: F401
from .executor import Executor
from .symbol import (AttrScope, Group, Symbol, Variable, arange, load,
                     load_json, ones, var, zeros)
from .symbol import _populate_ops, _sym_op

_populate_ops(globals())


def Custom(*args, **kwargs):
    """Compose a registered Python custom op into the graph; tensor
    inputs given by keyword take the prop's declared order."""
    from ..operator import normalize_custom_args
    tensors, call_kwargs = normalize_custom_args(args, kwargs)
    return _sym_op("Custom")(*tensors, **call_kwargs)


def __getattr__(name):
    from ..ops.registry import get_op
    if get_op(name) is not None:
        return _sym_op(name)
    raise AttributeError("module 'mxnet_tpu_torch.symbol' has no attribute "
                         "%r" % name)
