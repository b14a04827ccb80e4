"""``nd.contrib`` namespace: the control-flow trio (``foreach``,
``while_loop``, ``cond``) and the registry's ``_contrib_`` ops by their
short names, as the reference's ``ndarray/contrib.py``."""
from ..ops.contrib_ops import cond, foreach, while_loop  # noqa: F401
from ..ops.registry import get_op as _get_op


def __getattr__(name):
    op = _get_op("_contrib_" + name) or _get_op(name)
    if op is None:
        raise AttributeError("no contrib operator %r" % name)
    return op
