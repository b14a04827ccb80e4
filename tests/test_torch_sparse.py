"""Sparse storage of the port (``ndarray/sparse.py``, ``NDArray.tostype``,
``cast_storage``/``_sparse_retain``, SGD's row-sparse lazy update, the
seven graph ops of ``contrib/graph.py``) and ``LeakyReLU`` rrelu in
training, against the JAX package on the CPU.

Payloads (``data``/``indices``/``indptr``, ``values``/``indices``) and
every integer result are bitwise. ``dot`` sums each row's (or, for
``csr.T``, each column's) products in stored order, so it repeats bit for
bit; XLA's segment sum adds in another order, so it is held to a float64
truth and to the reference within 1e-6 of the output's largest
magnitude. Lazy SGD is bitwise against the reference's ``_sgd_rowwise``,
and the rows the gradient does not name are unchanged bit for bit. The
samplers draw from ``np.random``, seeded alike for both packages. rrelu's
draws are the port's own (threefry is not ported): its range, mean, the
identity on positive inputs, one key one mask, and its gradient.
"""
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

RNG = np.random.default_rng(172)


def _sparse_dense(rows, cols, density=0.3, zero_rows=()):
    a = RNG.standard_normal((rows, cols)).astype(np.float32)
    a[RNG.random((rows, cols)) > density] = 0
    a[list(zero_rows)] = 0
    return a


A = _sparse_dense(7, 9, zero_rows=(2, 5))
B = RNG.standard_normal((9, 3)).astype(np.float32)
G = RNG.standard_normal((7, 4)).astype(np.float32)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(own, ref):
    own, ref = _np(own), _np(ref)
    assert own.dtype == ref.dtype and own.shape == ref.shape
    np.testing.assert_array_equal(own, ref)


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_tostype_payloads_and_round_trip(stype):
    ref = jmx.nd.array(A).tostype(stype)
    with tmx.cpu():
        own = tmx.nd.array(A).tostype(stype)
        assert own.stype == stype and own.shape == A.shape
        assert isinstance(own, tsp.CSRNDArray if stype == "csr"
                          else tsp.RowSparseNDArray)
        parts = ("data", "indices", "indptr") if stype == "csr" \
            else ("data", "indices")
        for p in parts:
            _same(getattr(own, p), getattr(ref, p))
        _same(own, A)
        _same(own.tostype("default"), A)
        back = own.tostype("default").tostype(stype)
        _same(back.indices, own.indices)
        copy = own.tostype(stype)
        copy[:] = 0
        _same(own, A)


def test_constructors_as_reference():
    data, idx, ptr = np.float32([1, 2, 3]), [0, 2, 1], [0, 2, 2, 3]
    vals, rows = np.ones((2, 3), np.float32), [1, 4]
    with tmx.cpu():
        pairs = [
            (tsp.csr_matrix((data, idx, ptr), shape=(3, 4)),
             jsp.csr_matrix((data, idx, ptr), shape=(3, 4))),
            (tsp.csr_matrix(A), jsp.csr_matrix(A)),
            (tsp.row_sparse_array((vals, rows), shape=(6, 3)),
             jsp.row_sparse_array((vals, rows), shape=(6, 3))),
            (tsp.row_sparse_array(A), jsp.row_sparse_array(A)),
            (tsp.zeros("csr", (3, 4)), jsp.zeros("csr", (3, 4))),
            (tsp.zeros("row_sparse", (5, 2)), jsp.zeros("row_sparse", (5, 2))),
            (tsp.empty("row_sparse", (5, 2)), jsp.empty("row_sparse", (5, 2))),
        ]
        arr = tsp.array(tsp.csr_matrix(A))
        assert arr.stype == "csr"
        for own, ref in pairs:
            assert own.stype == ref.stype and own.shape == ref.shape
            _same(own, ref)
        x = tmx.test_utils.rand_ndarray((5, 6), stype="csr")
        assert x.stype == "csr" and x.shape == (5, 6)
        # attach_grad(stype=...) keeps a dense gradient, as the reference
        d = tmx.nd.array(A)
        d.attach_grad(stype="row_sparse")
        with tag.record():
            (d * d).sum().backward()
        assert d.grad.stype == "default"
        _same(d.grad, 2 * A)


@pytest.mark.parametrize("case", ["csr_dense", "csr_vector", "csrT_dense",
                                  "csrT_vector"])
def test_dot_repeats_and_is_close_to_float64_and_the_reference(case):
    rhs = {"csr_dense": B, "csr_vector": B[:, 0], "csrT_dense": G,
           "csrT_vector": G[:, 1]}[case]
    ta = case.startswith("csrT")
    ref = jsp.dot(jsp.csr_matrix(A), jmx.nd.array(rhs), transpose_a=ta)
    with tmx.cpu():
        own = tsp.dot(tsp.csr_matrix(A), tmx.nd.array(rhs), transpose_a=ta)
        again = tsp.dot(tsp.csr_matrix(A), tmx.nd.array(rhs),
                        transpose_a=ta)
    _same(again, own)
    truth = (A.T if ta else A).astype(np.float64) @ rhs.astype(np.float64)
    tol = 1e-6 * np.abs(truth).max()
    np.testing.assert_allclose(own.asnumpy(), truth, rtol=0, atol=tol)
    # XLA's segment sum adds in another order: an ulp apart at most here
    assert own.shape == ref.shape and own.dtype == ref.dtype
    np.testing.assert_allclose(own.asnumpy(), ref.asnumpy(), rtol=0,
                               atol=tol)


def test_dot_transposed_row_sparse_output():
    with tmx.cpu():
        dense = tsp.dot(tsp.csr_matrix(A), tmx.nd.array(G),
                        transpose_a=True)
        rsp = tsp.dot(tsp.csr_matrix(A), tmx.nd.array(G), transpose_a=True,
                      forward_stype="row_sparse")
    touched = np.nonzero((A != 0).any(0))[0]
    assert rsp.stype == "row_sparse"
    _same(rsp.indices, touched.astype(np.int64))
    _same(rsp, dense)


def test_retain_add_and_the_registry_ops():
    other = _sparse_dense(7, 9, zero_rows=(0, 1, 3))
    keep = np.array([0, 3, 4, 6], np.int64)
    jr, jo = jmx.nd.array(A).tostype("row_sparse"), \
        jmx.nd.array(other).tostype("row_sparse")
    with tmx.cpu():
        tr, to = tmx.nd.array(A).tostype("row_sparse"), \
            tmx.nd.array(other).tostype("row_sparse")
        kept = tsp.retain(tr, tmx.nd.array(keep, dtype="int64"))
        _same(kept.indices, jsp.retain(jr, jmx.nd.array(keep)).indices)
        _same(kept, jsp.retain(jr, jmx.nd.array(keep)))
        total = tsp.add(tr, to)
        assert total.stype == "row_sparse"
        _same(total, jsp.add(jr, jo))
        _same(total.indices, jsp.add(jr, jo).indices)
        cast = tmx.nd.cast_storage(tmx.nd.array(A), stype="csr")
        assert cast.stype == "csr"
        _same(cast, jmx.nd.cast_storage(jmx.nd.array(A), stype="csr"))
        _same(tmx.nd.cast_storage(cast, stype="default"), A)
        dense_kept = tmx.nd._sparse_retain(tmx.nd.array(A),
                                           tmx.nd.array(keep))
        _same(dense_kept, jmx.nd._sparse_retain(jmx.nd.array(A),
                                                jmx.nd.array(keep)))
        sparse_kept = tmx.nd._sparse_retain(tr, tmx.nd.array(keep))
        assert sparse_kept.stype == "row_sparse"
        _same(sparse_kept, dense_kept)


@pytest.mark.parametrize("wd,clip", [(0.0, None), (0.01, 0.5)])
def test_lazy_sgd_bitwise_and_untouched_rows_unchanged(wd, clip):
    w0 = RNG.standard_normal((12, 3)).astype(np.float32)
    rows = np.array([1, 4, 5, 10], np.int64)
    vals = RNG.standard_normal((4, 3)).astype(np.float32)
    kw = dict(learning_rate=0.1, wd=wd, rescale_grad=0.5,
              clip_gradient=clip)
    jw = jmx.nd.array(w0)
    jopt = jmx.optimizer.SGD(**kw)
    with tmx.cpu():
        tw = tmx.nd.array(w0)
        topt = tmx.optimizer.SGD(**kw)
        for _ in range(3):
            jopt.update(0, jw, jsp.row_sparse_array((vals, rows),
                                                    shape=w0.shape), None)
            topt.update(0, tw, tsp.row_sparse_array((vals, rows),
                                                    shape=w0.shape), None)
    _same(tw, jw)
    untouched = np.setdiff1d(np.arange(12), rows)
    _same(tw.asnumpy()[untouched], w0[untouched])
    assert not np.array_equal(tw.asnumpy()[rows], w0[rows])


def test_lazy_sgd_on_a_row_sparse_weight_keeps_its_payload():
    """A ``RowSparseNDArray`` weight (as in linear classification): after
    each update its payload, copy, ``retain`` and cast to dense agree
    with the updated dense value and with the reference's."""
    w0 = RNG.standard_normal((12, 3)).astype(np.float32)
    w0[[0, 7]] = 0
    rows = np.array([2, 4, 7, 11], np.int64)
    vals = RNG.standard_normal((4, 3)).astype(np.float32)
    kw = dict(learning_rate=0.1, wd=0.01, rescale_grad=0.5)
    jw = jmx.nd.array(w0).tostype("row_sparse")
    jopt = jmx.optimizer.SGD(**kw)
    with tmx.cpu():
        tw = tmx.nd.array(w0).tostype("row_sparse")
        topt = tmx.optimizer.SGD(**kw)
        for _ in range(3):
            jopt.update(0, jw, jsp.row_sparse_array((vals, rows),
                                                    shape=w0.shape), None)
            topt.update(0, tw, tsp.row_sparse_array((vals, rows),
                                                    shape=w0.shape), None)
            dense = tw.asnumpy()
            truth = np.zeros_like(dense)
            truth[_np(tw.indices)] = _np(tw.data)
            _same(truth, dense)
            _same(tw.copy(), dense)
            _same(tw.tostype("default"), dense)
            _same(tsp.retain(tw, tmx.nd.array(rows)).data, dense[rows])
        _same(tw.indices, jw.indices)
        _same(tw.data, jw.data)
    assert tw.stype == "row_sparse"
    untouched = np.setdiff1d(np.arange(12), rows)
    _same(dense[untouched], w0[untouched])
    assert not np.array_equal(dense[rows], w0[rows])


def test_params_files_store_dense_and_refuse_sparse_entries(tmp_path):
    tf, jf = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    with tmx.cpu():
        tmx.nd.save(tf, {"w": tmx.nd.array(A).tostype("row_sparse")})
    jmx.nd.save(jf, {"w": jmx.nd.array(A).tostype("row_sparse")})
    with open(tf, "rb") as f, open(jf, "rb") as g:
        assert f.read() == g.read()
    with tmx.cpu():
        _same(tmx.nd.load(tf, ctx=tmx.cpu())["w"], A)
    raw = bytearray(open(tf, "rb").read())
    # the first record's storage type (after the 24-byte list header and
    # the 4-byte record magic): 1 = row_sparse
    raw[28:32] = struct.pack("<i", 1)
    bad = str(tmp_path / "bad.params")
    open(bad, "wb").write(bytes(raw))
    msgs = []
    for load in (lambda: jmx.nd.load(bad),
                 lambda: tmx.nd.load(bad, ctx=tmx.cpu())):
        with pytest.raises(NotImplementedError) as e:
            load()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "sparse storage type 1" in msgs[0]


GRAPH = (RNG.random((12, 12)) < 0.3).astype(np.float32) * \
    RNG.integers(1, 9, (12, 12)).astype(np.float32)
np.fill_diagonal(GRAPH, 0)


def _graph_calls(mx, sparse):
    g = sparse.csr_matrix(GRAPH)
    nd = mx.nd
    u = nd.array(np.array([0, 1, 2, 3, 11], np.int64), dtype="int64")
    v = nd.array(np.array([1, 0, 5, 3, 2], np.int64), dtype="int64")
    prob = nd.array(np.linspace(0.1, 1.0, 12).astype(np.float32))
    seeds = nd.array(np.array([0, 4], np.int64), dtype="int64")
    out = {"edge_id": nd._contrib_edge_id(g, u, v),
           "getnnz": nd._contrib_getnnz(g),
           "getnnz0": nd._contrib_getnnz(g, axis=0),
           "getnnz1": nd._contrib_getnnz(g, axis=1),
           "adjacency": nd._contrib_dgl_adjacency(g),
           "subgraph": nd._contrib_dgl_subgraph(
               g, nd.array(np.array([1, 3, 4, 7], np.int64), dtype="int64"),
               return_mapping=True)}
    np.random.seed(5)
    out["uniform"] = nd._contrib_dgl_csr_neighbor_uniform_sample(
        g, seeds, num_hops=2, num_neighbor=2, max_num_vertices=6)
    np.random.seed(6)
    out["non_uniform"] = nd._contrib_dgl_csr_neighbor_non_uniform_sample(
        g, prob, seeds, num_hops=2, num_neighbor=2, max_num_vertices=6)
    verts, sub = out["uniform"][0], out["uniform"][1]
    out["compact"] = nd._contrib_dgl_graph_compact(
        sub, verts, graph_sizes=(int(verts.asnumpy()[-1]),))
    return out


def _flat_graph(v):
    items = v if isinstance(v, tuple) else (v,)
    res = []
    for a in items:
        res.append((a.stype, _np(a)))
        if a.stype == "csr":
            res.extend(("part", _np(getattr(a, p)))
                       for p in ("data", "indices", "indptr"))
    return res


def test_graph_ops_as_reference():
    ref = _graph_calls(jmx, jsp)
    with tmx.cpu():
        own = _graph_calls(tmx, tsp)
    assert sorted(own) == sorted(ref)
    for k in ref:
        fo, fr = _flat_graph(own[k]), _flat_graph(ref[k])
        assert len(fo) == len(fr), k
        for (so, o), (sr, r) in zip(fo, fr):
            assert so == sr, k
            _same(o, r)
    for name in ("_contrib_edge_id", "_contrib_getnnz",
                 "_contrib_dgl_adjacency", "_contrib_dgl_subgraph",
                 "_contrib_dgl_csr_neighbor_uniform_sample",
                 "_contrib_dgl_csr_neighbor_non_uniform_sample",
                 "_contrib_dgl_graph_compact"):
        assert treg.get_op(name).host_op and jreg.get_op(name).host_op


def test_graph_sampler_seed_argument_repeats():
    with tmx.cpu():
        g = tsp.csr_matrix(GRAPH)
        seeds = tmx.nd.array(np.array([2], np.int64), dtype="int64")
        a, b = (tmx.contrib.graph.dgl_csr_neighbor_uniform_sample(
            g, seeds, num_hops=2, num_neighbor=3, max_num_vertices=8,
            seed=11) for _ in range(2))
    for x, y in zip(a, b):
        _same(x, y)


def test_rrelu_training_draws():
    lo, hi = 0.125, 0.334
    x = -np.abs(RNG.standard_normal((64, 256)).astype(np.float32)) - 0.5
    x[:, :8] = np.abs(x[:, :8])
    fn = treg.get_op("LeakyReLU").fn
    xt = torch.from_numpy(x)
    y = fn(xt, act_type="rrelu", key=(3, 4), train=True)
    y2 = fn(xt, act_type="rrelu", key=(3, 4), train=True)
    y3 = fn(xt, act_type="rrelu", key=(3, 5), train=True)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    assert not torch.equal(y, y3)
    slopes = (y[:, 8:] / xt[:, 8:]).numpy()
    assert slopes.min() >= lo and slopes.max() < hi
    assert abs(slopes.mean() - (lo + hi) / 2) < 3e-3
    np.testing.assert_array_equal(y[:, :8].numpy(), x[:, :8])
    # outside training: the reference's mean slope, bitwise
    want = np.asarray(jreg.get_op("LeakyReLU").fn(
        jmx.nd.array(x)._data, act_type="rrelu"))
    np.testing.assert_array_equal(fn(xt, act_type="rrelu").numpy(), want)
    # through nd under train_mode, with its gradient: the drawn slope
    with tmx.cpu():
        a = tmx.nd.array(x)
        a.attach_grad()
        with tag.record(train_mode=True):
            out = tmx.nd.LeakyReLU(a, act_type="rrelu")
        out.backward()
    grad = a.grad.asnumpy()
    np.testing.assert_array_equal(grad[:, :8], np.ones((64, 8), np.float32))
    np.testing.assert_array_equal(grad[:, 8:] * x[:, 8:],
                                  out.asnumpy()[:, 8:])
    assert grad[:, 8:].min() >= lo and grad[:, 8:].max() < hi


def test_row_sparse_data_and_sparse_grad_embeddings_are_dense():
    ids = np.array([[1, 3], [3, 0]], np.float32)
    jemb = jmx.gluon.contrib.nn.SparseEmbedding(5, 2)
    jemb.initialize()
    with tmx.cpu():
        for emb in (tmx.gluon.nn.Embedding(5, 2, sparse_grad=True),
                    tmx.gluon.contrib.nn.SparseEmbedding(5, 2)):
            emb.initialize()
            emb.weight.set_data(jemb.weight.data().asnumpy())
            _same(emb.weight.row_sparse_data(tmx.nd.array([1, 3])),
                  jemb.weight.row_sparse_data(jmx.nd.array([1, 3])))
            assert len(emb.weight.list_row_sparse_data(
                tmx.nd.array([1]))) == 1
            with tag.record():
                loss = (emb(tmx.nd.array(ids)) ** 2).sum()
            loss.backward()
            grad = emb.weight.grad()
            assert grad.stype == "default"
            with jmx.autograd.record():
                jl = (jemb(jmx.nd.array(ids)) ** 2).sum()
            jl.backward()
            _same(grad, jemb.weight.grad())
