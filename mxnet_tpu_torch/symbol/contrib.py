"""``mx.sym.contrib``: the registry's ``_contrib_<name>`` ops (or
``<name>``) by their short names, and the control-flow trio. As in the
reference, ``foreach``, ``while_loop`` and ``cond`` are the NDArray
functions of ``nd.contrib``: they take Python callables and run them."""
from ..ops.contrib_ops import cond, foreach, while_loop  # noqa: F401
from ..ops.registry import get_op as _get_op
from .symbol import _sym_op


def __getattr__(name):
    if _get_op("_contrib_" + name) is not None:
        return _sym_op("_contrib_" + name)
    if _get_op(name) is not None:
        return _sym_op(name)
    raise AttributeError("no contrib symbol operator %r" % name)
