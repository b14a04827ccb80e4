"""Subgraph partitioning: counterpart of ``mxnet_tpu/symbol/subgraph.py``.

``SubgraphSelector``/``SubgraphProperty`` (the reference's
``subgraph_property.h``), ``register_subgraph_property``,
``list_backends`` and :func:`partition`, the graph pass behind
``Symbol.get_backend_symbol(backend)`` and the bind-time
``MXNET_SUBGRAPH_BACKEND`` knob. A backend's selector picks the ops a
region may hold; regions grow greedily in topological order, never across
a differing ``ctx_group`` (fusing across groups would put ops the user
placed on two devices onto one), and stay convex (no path leaves the
region and re-enters it: such a region is cut back, as the reference's
``build_subgraph.cc`` labelling does). Each region becomes one node of a
registry op named ``_subgraph_<backend>_<n>``, registered when the
region is built (so a partitioned symbol's JSON loads back in the same
process, as the reference requires its backend library loaded); the node
keeps the region's ``ctx_group``.

A region's op runs the region's own op functions, composed in the
region's order, on the same arguments, so a partitioned graph computes
what the unpartitioned one computes, bit for bit, on the CPU and on the
card; on the card a hybridized or ``Executor`` inference forward still
captures it as one CUDA graph through ``CachedOp``. A generated kernel per
region (a fused elementwise kernel) is later work (ROADMAP lead).

``TPU_ELEMWISE`` (the reference's name for its built-in backend) fuses
chains of elementwise ops.
"""
from __future__ import annotations

import itertools

from ..ops import registry as _registry
from .symbol import Symbol, _is_const, _node_args, _out_key

__all__ = ["SubgraphSelector", "SubgraphProperty",
           "register_subgraph_property", "list_backends", "partition",
           "ElementwiseFusionProperty"]

_fused_counter = itertools.count()


class SubgraphSelector:
    """Which ops join a region (``Select``, ``SelectInput``,
    ``SelectOutput``)."""

    def select(self, node) -> bool:
        """Can this node seed a new region?"""
        return False

    def select_input(self, node, producer) -> bool:
        """Grow the region from ``node`` to its input ``producer``?"""
        return self.select(producer)

    def select_output(self, node, consumer) -> bool:
        """Grow the region from ``node`` to its consumer?"""
        return self.select(consumer)

    def min_size(self) -> int:
        """Regions smaller than this stay unfused."""
        return 2


class SubgraphProperty:
    """A partitioning backend: supplies a selector and builds a region's
    op."""

    name = "base"

    def create_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def build_fused_op(self, region_name, subgraph_fn, n_out):
        """Register the region's function as the op ``region_name``."""
        return _registry.register(region_name, n_out=n_out)(subgraph_fn)


_BACKENDS: dict = {}


def register_subgraph_property(name, prop):
    _BACKENDS[name] = prop
    return prop


def list_backends():
    return sorted(_BACKENDS)


def _node_group(n):
    return n._attr.get("ctx_group") or n._attr.get("__ctx_group__")


def _collect_regions(order, selector):
    """Greedy convex regions in topological order; a differing
    ``ctx_group`` is a barrier."""
    pos = {id(n): i for i, n in enumerate(order)}
    consumers = {}
    for n in order:
        for p, _ in n._inputs:
            consumers.setdefault(id(p), []).append(n)
    assigned = {}
    regions = []
    for seed in order:
        if seed._op is None or id(seed) in assigned or \
                not selector.select(seed):
            continue
        region = {id(seed): seed}
        group = _node_group(seed)
        frontier = [seed]
        while frontier:
            node = frontier.pop()
            for p, _ in node._inputs:
                if (p._op is not None and id(p) not in assigned
                        and id(p) not in region and _node_group(p) == group
                        and selector.select_input(node, p)):
                    region[id(p)] = p
                    frontier.append(p)
            for c in consumers.get(id(node), ()):
                if (id(c) not in assigned and id(c) not in region
                        and _node_group(c) == group
                        and selector.select_output(node, c)):
                    region[id(c)] = c
                    frontier.append(c)
        # convexity: an outside node that depends on the region and feeds
        # it witnesses a path that leaves and re-enters; cut the region
        # back to the part before that node and look again
        changed = True
        while changed:
            changed = False
            lo = min(pos[i] for i in region)
            hi = max(pos[i] for i in region)
            depends = {}
            for i in range(lo, hi + 1):
                node = order[i]
                if id(node) in region:
                    continue
                depends[id(node)] = any(
                    id(p) in region or depends.get(id(p), False)
                    for p, _ in node._inputs)
            for i in range(lo + 1, hi + 1):
                mid = order[i]
                if id(mid) in region or not depends.get(id(mid)):
                    continue
                if any(id(c) in region for c in consumers.get(id(mid), ())):
                    for k in [k for k in region if pos[k] > pos[id(mid)]]:
                        del region[k]
                    changed = True
                    break
        if len(region) >= selector.min_size():
            for k in region:
                assigned[k] = len(regions)
            regions.append(sorted(region.values(), key=lambda n: pos[id(n)]))
    return regions, assigned, consumers


def _region_inputs(region):
    """The region's inputs from outside, ``(producer, out_index)`` in
    first-use order."""
    inside = {id(n) for n in region}
    out, seen = [], set()
    for n in region:
        for p, oi in n._inputs:
            if id(p) not in inside and (id(p), oi) not in seen:
                seen.add((id(p), oi))
                out.append((p, oi))
    return out


def _make_subgraph_fn(region, ext_inputs, out_nodes):
    """The region as one function of its outside inputs: each node's op
    function on its arguments, in the region's order."""
    def fn(*args):
        values = {_out_key(p, oi): args[i]
                  for i, (p, oi) in enumerate(ext_inputs)}
        for n in region:
            out = n._op.fn(*_node_args(n, values), **n._kwargs)
            if isinstance(out, (tuple, list)):
                for i, v in enumerate(out):
                    values[_out_key(n, i)] = v
            else:
                values[_out_key(n, 0)] = out
        outs = tuple(values[_out_key(n, 0)] for n in out_nodes)
        return outs if len(outs) > 1 else outs[0]
    return fn


def partition(symbol, backend):
    """A new Symbol in which each region the backend selects is one node
    of its region op."""
    prop = _BACKENDS.get(backend)
    if prop is None:
        raise ValueError("unknown subgraph backend %r (registered: %s)"
                         % (backend, list_backends()))
    order = symbol._toposort()
    regions, assigned, consumers = _collect_regions(
        order, prop.create_selector())
    if not regions:
        return symbol
    graph_outputs = {id(s) for s, _ in symbol._outputs_list()}
    region_outs = []
    for region in regions:
        inside = {id(n) for n in region}
        region_outs.append([n for n in region if id(n) in graph_outputs
                            or any(id(c) not in inside
                                   for c in consumers.get(id(n), ()))])
    mapping, fused, building = {}, {}, set()

    def mapped(p, oi):
        if id(p) in assigned:
            ri = assigned[id(p)]
            return build_region(ri), region_outs[ri].index(p)
        return clone(p), oi

    def clone(n):
        if id(n) in mapping:
            return mapping[id(n)]
        if n._op is None:
            new = n      # variables are shared, not cloned
        else:
            new = Symbol(op=n._op, kwargs=dict(n._kwargs), name=n._name,
                         attr=dict(n._attr))
            raw = getattr(n, "_raw_inputs", n._inputs)
            new._raw_inputs = [p if _is_const(p) else mapped(*p)
                               for p in raw]
            new._inputs = [p for p in new._raw_inputs if not _is_const(p)]
        mapping[id(n)] = new
        return new

    def build_region(ri):
        if ri in fused:
            return fused[ri]
        if ri in building:
            raise RuntimeError(
                "a non-convex region survived the convexity pass (backend "
                "%r, region %d)" % (backend, ri))
        building.add(ri)
        region = regions[ri]
        ext = _region_inputs(region)
        outs = region_outs[ri]
        name = "_subgraph_%s_%d" % (backend, next(_fused_counter))
        op = prop.build_fused_op(name, _make_subgraph_fn(region, ext, outs),
                                 len(outs))
        attrs = {"__subgraph__": backend,
                 "__subgraph_ops__": ",".join(n._op.name for n in region)}
        group = _node_group(region[0])
        if group is not None:
            attrs["ctx_group"] = group
        node = Symbol(op=op, kwargs={}, name=name, attr=attrs)
        node._raw_inputs = [mapped(p, oi) for p, oi in ext]
        node._inputs = list(node._raw_inputs)
        building.discard(ri)
        fused[ri] = node
        return node

    new_outputs = [mapped(s, oi) for s, oi in symbol._outputs_list()]
    if len(new_outputs) == 1 and symbol._group is None:
        node, oi = new_outputs[0]
        if oi == 0:
            return node
    g = Symbol(op=None, name="group")
    g._group = new_outputs
    return g


# selectors see the op's canonical registry name (elemwise_add and
# broadcast_add are aliases of add)
_ELEMWISE = {"relu", "sigmoid", "tanh", "exp", "log", "sqrt", "square",
             "Activation", "add", "multiply", "subtract", "divide",
             "_plus_scalar", "_mul_scalar", "_minus_scalar",
             "_div_scalar", "negative", "abs", "clip"}


class _ElementwiseSelector(SubgraphSelector):
    def select(self, node):
        return node._op is not None and node._op.name in _ELEMWISE


class ElementwiseFusionProperty(SubgraphProperty):
    """The built-in backend: chains of elementwise ops as one region op
    (the role of the reference's pointwise fusion pass)."""

    name = "TPU_ELEMWISE"

    def create_selector(self):
        return _ElementwiseSelector()


register_subgraph_property("TPU_ELEMWISE", ElementwiseFusionProperty())
