"""Op lookup for NDArray methods (PEP 562 module ``__getattr__``), as the
reference's ``ndarray/_op_proxy.py``."""
from ..ops.registry import get_op


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("no operator %r registered" % name)
    return op
