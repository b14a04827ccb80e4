"""Network summaries: counterpart of ``mxnet_tpu/visualization.py``.

``print_summary`` prints a Symbol's operator table (the reference's text,
line for line), ``block_summary`` a block's layers by forward hooks, and
``plot_network`` draws the graph with the ``graphviz`` package, raising
``ImportError`` where that is not installed. Host code only.
"""
from __future__ import annotations

__all__ = ["print_summary", "plot_network", "block_summary"]


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """One line per operator: name (op), output shape (with ``shape``,
    a ``{name: shape}`` of the inputs), parameter count and inputs;
    returns the total parameter count."""
    from .symbol.symbol import _infer_shapes, _out_key
    shapes = _infer_shapes(symbol, dict(shape)) if shape is not None else {}
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]
    print("=" * line_length)
    print("%-40s %-20s %-12s %-30s" % tuple(fields))
    print("=" * line_length)
    total = 0
    for node in symbol._toposort():
        if node._op is None:
            continue
        prev = ",".join(p._name or "?" for p, _ in node._inputs)
        params = 0
        for p, _ in node._inputs:
            if p._op is None and p._name != "data" and p._name in shapes:
                n = 1
                for d in shapes[p._name]:
                    n *= d
                params += n
        total += params
        print("%-40s %-20s %-12s %-30s" % (
            "%s (%s)" % (node._name, node._op.name),
            str(shapes.get(_out_key(node, 0), "")), str(params), prev[:30]))
    print("=" * line_length)
    print("Total params: %d" % total)
    return total


def block_summary(block, *inputs):
    """Call ``block`` on ``inputs`` and print each child layer's type,
    output shape and parameter count; returns the total."""
    rows = []
    hooks = []

    def make_hook(name):
        def hook(blk, inp, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            n_params = sum(int(t.numel()) for t in blk._parameters.values()
                           if t is not None)
            rows.append((name, type(blk).__name__, tuple(o.shape), n_params))
        return hook

    def walk(blk, prefix):
        for name, child in blk.named_children():
            hooks.append(child.register_forward_hook(make_hook(prefix + name)))
            walk(child, prefix + name + ".")

    walk(block, "")
    try:
        block(*inputs)
    finally:
        for h in hooks:
            h.remove()
    print("%-30s %-24s %-20s %-12s" % ("Layer", "Type", "Output Shape",
                                       "Param #"))
    print("-" * 90)
    total = 0
    for name, tp, shape, n in rows:
        total += n
        print("%-30s %-24s %-20s %-12d" % (name, tp, str(shape), n))
    print("-" * 90)
    print("Total params: %d" % total)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 dtype=None, node_attrs=None, hide_weights=True):
    """A ``graphviz.Digraph`` of the graph (operators as boxes; with
    ``hide_weights`` the only variable drawn is ``data``)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires the graphviz package")
    dot = Digraph(name=title)
    for node in symbol._toposort():
        if node._op is None:
            if not hide_weights or node._name == "data":
                dot.node(str(id(node)), node._name, shape="oval")
            continue
        dot.node(str(id(node)), "%s\n%s" % (node._name, node._op.name),
                 shape="box")
        for p, _ in node._inputs:
            if p._op is not None or not hide_weights or p._name == "data":
                dot.edge(str(id(p)), str(id(node)))
    return dot
