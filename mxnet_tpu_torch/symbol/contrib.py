"""``mx.sym.contrib``: the registry's ``_contrib_<name>`` ops (or
``<name>``) by their short names. The control-flow trio (``foreach``,
``while_loop``, ``cond``) needs the contrib operator corpus, ROADMAP
Queue A item 8."""
from ..ops.registry import get_op as _get_op
from .symbol import _sym_op

_CONTROL_FLOW = ("foreach", "while_loop", "cond")


def __getattr__(name):
    if name in _CONTROL_FLOW:
        raise NotImplementedError(
            "mx.sym.contrib.%s is not ported yet: it needs the contrib "
            "operators (ROADMAP Queue A item 8)" % name)
    if _get_op("_contrib_" + name) is not None:
        return _sym_op("_contrib_" + name)
    if _get_op(name) is not None:
        return _sym_op(name)
    raise AttributeError("no contrib symbol operator %r" % name)
