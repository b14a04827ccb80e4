"""Graph ops over CSR adjacency matrices: counterpart of
``mxnet_tpu/contrib/graph.py`` (MXNet 1.6's ``contrib/dgl_graph.cc`` and
``contrib/nnz.cc``).

Host ops, as in MXNet 1.6 (CPU-only kernels feeding a sampler pipeline):
each reads the graph's CSR payload to the host, computes in numpy (a copy
of the reference's code) and returns arrays on the graph's device. The
neighbour samplers draw from ``np.random`` (the caller seeds it, as with
the reference, so the same seed samples the same neighbours), or from
``np.random.RandomState(seed)`` when ``seed`` is given. They are
registered as ``_contrib_edge_id``, ``_contrib_getnnz`` and the five
``_contrib_dgl_*`` names (``ops/ste_graph_ops.py``).
"""
from __future__ import annotations

import numpy as np

from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import CSRNDArray

__all__ = ["edge_id", "getnnz", "dgl_adjacency", "dgl_subgraph",
           "dgl_csr_neighbor_uniform_sample",
           "dgl_csr_neighbor_non_uniform_sample", "dgl_graph_compact"]


def _csr_parts(csr):
    if not isinstance(csr, CSRNDArray):
        raise TypeError("expected a CSRNDArray, got %r" % type(csr))
    d, i, p = csr._payload()
    return (d.detach().cpu().numpy(), i.cpu().numpy().astype(np.int64),
            p.cpu().numpy().astype(np.int64))


def _host(a, dtype):
    if isinstance(a, NDArray):
        a = a.asnumpy()
    elif hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _nd(a, like):
    return NDArray(a, ctx=like.ctx, dtype=a.dtype)


def _csr(data, indices, indptr, shape, like):
    return CSRNDArray(np.asarray(data, dtype=np.float32),
                      np.asarray(indices, dtype=np.int64),
                      np.asarray(indptr, dtype=np.int64), shape,
                      ctx=like.ctx)


def edge_id(data, u, v):
    """The stored value of each edge ``(u[i], v[i])``, -1 where there is
    none."""
    d, idx, ptr = _csr_parts(data)
    uu, vv = _host(u, np.int64), _host(v, np.int64)
    out = np.full(uu.shape, -1.0, dtype=np.float32)
    for k, (a, b) in enumerate(zip(uu.ravel(), vv.ravel())):
        cols = idx[ptr[a]:ptr[a + 1]]
        hit = np.nonzero(cols == b)[0]
        if hit.size:
            out.ravel()[k] = d[ptr[a] + hit[0]]
    return _nd(out, data)


def getnnz(data, axis=None):
    """The count of stored values: in all, a row (``axis=1``) or a column
    (``axis=0``)."""
    d, idx, ptr = _csr_parts(data)
    if axis is None:
        return _nd(np.asarray(len(d), dtype=np.int64), data)
    if axis == 1:
        return _nd(np.diff(ptr).astype(np.int64), data)
    if axis == 0:
        counts = np.zeros(data.shape[1], dtype=np.int64)
        np.add.at(counts, idx, 1)
        return _nd(counts, data)
    raise ValueError("axis must be None, 0 or 1")


def dgl_adjacency(data):
    """The same sparsity pattern with every value 1."""
    d, idx, ptr = _csr_parts(data)
    return _csr(np.ones_like(d, dtype=np.float32), idx, ptr, data.shape,
                data)


def dgl_subgraph(graph, *vids, return_mapping=False):
    """The subgraph each vertex-id array induces, renumbered in its order;
    with ``return_mapping`` also same-pattern CSRs whose values are the
    edges' positions in ``graph``."""
    d, idx, ptr = _csr_parts(graph)
    outs, maps = [], []
    for vid in vids:
        v = _host(vid, np.int64).ravel()
        v = v[v >= 0]
        renum = -np.ones(graph.shape[0], dtype=np.int64)
        renum[v] = np.arange(v.size)
        sub_data, sub_idx, sub_map = [], [], []
        sub_ptr = [0]
        for r in v:
            cols = idx[ptr[r]:ptr[r + 1]]
            keep = renum[cols] >= 0
            sub_idx.extend(renum[cols[keep]])
            sub_data.extend(d[ptr[r]:ptr[r + 1]][keep])
            sub_map.extend((ptr[r] + np.nonzero(keep)[0]).tolist())
            sub_ptr.append(len(sub_idx))
        shape = (v.size, v.size)
        outs.append(_csr(sub_data, sub_idx, sub_ptr, shape, graph))
        maps.append(_csr(sub_map, sub_idx, sub_ptr, shape, graph))
    res = outs + (maps if return_mapping else [])
    return res[0] if len(res) == 1 else tuple(res)


def _neighbor_sample(graph, seeds, num_hops, num_neighbor,
                     max_num_vertices, prob=None, rng=None):
    d, idx, ptr = _csr_parts(graph)
    rng = rng or np.random
    pv = None if prob is None else _host(prob, np.float64)
    outs = []
    for seed in seeds:
        sv = _host(seed, np.int64).ravel()
        layer = {int(v): 0 for v in sv}
        frontier = list(layer)
        edges = []
        for hop in range(1, num_hops + 1):
            nxt = []
            for v in frontier:
                cols = idx[ptr[v]:ptr[v + 1]]
                vals = d[ptr[v]:ptr[v + 1]]
                if cols.size == 0:
                    continue
                if pv is None:
                    k = min(int(num_neighbor), cols.size)
                    pick = rng.choice(cols.size, size=k, replace=False)
                else:
                    w = pv[cols]
                    nz = int((w > 0).sum())
                    if nz == 0:
                        continue
                    k = min(int(num_neighbor), nz)
                    pick = rng.choice(cols.size, size=k, replace=False,
                                      p=w / w.sum())
                for j in pick:
                    nb = int(cols[j])
                    edges.append((v, nb, vals[j]))
                    if nb not in layer and len(layer) < max_num_vertices:
                        layer[nb] = hop
                        nxt.append(nb)
            frontier = nxt
        verts = np.array(sorted(layer), dtype=np.int64)
        n = verts.size
        vset = set(verts.tolist())
        varr = np.zeros(max_num_vertices + 1, np.int64)
        varr[:n] = verts
        varr[-1] = n
        larr = np.zeros(max_num_vertices, np.int64)
        larr[:n] = [layer[int(v)] for v in verts]
        rows = {}
        for (s, t, val) in edges:
            if s in vset and t in vset:
                rows.setdefault(s, {})[t] = val
        sd, si = [], []
        sp = [0]
        for r in range(graph.shape[0]):
            cols = sorted(rows.get(r, {}))
            si.extend(cols)
            sd.extend(rows[r][c] for c in cols)
            sp.append(len(si))
        outs.append((_nd(varr, graph), _csr(sd, si, sp, graph.shape, graph),
                     _nd(larr, graph)))
    return tuple([o[0] for o in outs] + [o[1] for o in outs]
                  + [o[2] for o in outs])


def _rng(seed):
    return None if seed is None else np.random.RandomState(seed)


def dgl_csr_neighbor_uniform_sample(csr, *seeds, num_args=0, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100,
                                    seed=None):
    """Uniform neighbour sampling: for each seed array, the vertices
    (``max_num_vertices + 1``, the count in the last slot), the sampled
    edges as a CSR in the graph's numbering, and each vertex's hop."""
    return _neighbor_sample(csr, seeds, int(num_hops), int(num_neighbor),
                            int(max_num_vertices), rng=_rng(seed))


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds,
                                        num_args=0, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100, seed=None):
    """The same, each neighbour drawn with its ``probability``."""
    return _neighbor_sample(csr, seeds, int(num_hops), int(num_neighbor),
                            int(max_num_vertices), prob=probability,
                            rng=_rng(seed))


def dgl_graph_compact(*args, graph_sizes=(), return_mapping=False):
    """Sampled CSRs (the first half of ``args``; their vertex arrays the
    second) cut to their ``graph_sizes`` vertices and renumbered in the
    sampled order."""
    n = len(args) // 2
    graphs, vids = args[:n], args[n:]
    if not isinstance(graph_sizes, (tuple, list)):
        graph_sizes = (graph_sizes,)
    outs = []
    for g, v, size in zip(graphs, vids, graph_sizes):
        d, idx, ptr = _csr_parts(g)
        verts = _host(v, np.int64).ravel()[:int(size)]
        renum = -np.ones(g.shape[0], dtype=np.int64)
        renum[verts] = np.arange(verts.size)
        sd, si = [], []
        sp = [0]
        for r in verts:
            cols = idx[ptr[r]:ptr[r + 1]]
            keep = renum[cols] >= 0
            order = np.argsort(renum[cols[keep]])
            si.extend(renum[cols[keep]][order])
            sd.extend(d[ptr[r]:ptr[r + 1]][keep][order])
            sp.append(len(si))
        outs.append(_csr(sd, si, sp, (verts.size, verts.size), g))
    return outs[0] if len(outs) == 1 else tuple(outs)
