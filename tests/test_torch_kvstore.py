"""The port's ``kvstore`` against the JAX package's, on the CPU: the
counterparts of ``tests/test_parallel.py``'s kvstore and gradient
compression tests, plus the optimizer-state files, ``row_sparse_pull``
and the retry policy. Sums and compressed payloads are held bit for bit
(the same inputs from numpy, the same operations in the same order)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _nd(pkg, a, ctx=None):
    if pkg is tmx:
        return tmx.nd.array(np.asarray(a, "float32"), ctx=ctx or CPU)
    return jmx.nd.array(np.asarray(a, "float32"))


def _both(fn):
    """``fn(pkg)`` for each package; their results as numpy."""
    with tmx.cpu():
        own = fn(tmx)
    return own, fn(jmx)


def test_kvstore_local_pushpull():
    def run(pkg):
        kv = pkg.kvstore.create("local")
        kv.init("3", pkg.nd.ones((2, 3)))
        out = pkg.nd.zeros((2, 3))
        kv.pull("3", out=out)
        first = out.asnumpy().copy()
        kv.push("3", pkg.nd.ones((2, 3)) * 4)
        kv.pull("3", out=out)
        return first, out.asnumpy()
    (f, o), (rf, ro) = _both(run)
    np.testing.assert_array_equal(f, np.ones((2, 3)))
    # a push without an updater replaces the stored value
    np.testing.assert_array_equal(o, np.full((2, 3), 4.0))
    np.testing.assert_array_equal(o, ro)


def test_kvstore_aggregates_device_copies():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((4, 5)).astype("float32")

    def run(pkg):
        kv = pkg.kvstore.create("local")
        kv.init("k", pkg.nd.zeros((5,)))
        copies = [_nd(pkg, v, tmx.cpu(i) if pkg is tmx else None)
                  for i, v in enumerate(vals)]
        kv.push("k", copies)
        out = pkg.nd.zeros((5,))
        kv.pull("k", out=out)
        outs = [pkg.nd.zeros((5,)) for _ in range(2)]
        kv.pushpull("k", copies, out=outs)
        return out.asnumpy(), [o.asnumpy() for o in outs]
    (own, outs), (ref, routs) = _both(run)
    np.testing.assert_array_equal(own, ref)
    np.testing.assert_array_equal(own, ((vals[0] + vals[1]) + vals[2])
                                  + vals[3])
    for o, r in zip(outs, routs):
        np.testing.assert_array_equal(o, r)


def test_kvstore_updater():
    def run(pkg):
        kv = pkg.kvstore.create("device")
        kv.init("w", pkg.nd.ones((3,)))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.5))
        kv.push("w", pkg.nd.ones((3,)))
        out = pkg.nd.zeros((3,))
        kv.pull("w", out=out)
        # a plain callable updater gets NDArrays
        kv2 = pkg.kvstore.create("local")
        kv2.init(0, pkg.nd.ones((2,)))

        def upd(key, grad, stored):
            stored[:] = stored + grad * 2
        kv2.set_updater(upd)
        kv2.push(0, pkg.nd.ones((2,)))
        out2 = pkg.nd.zeros((2,))
        kv2.pull(0, out=out2)
        return out.asnumpy(), out2.asnumpy()
    (o, o2), (r, r2) = _both(run)
    np.testing.assert_allclose(o, np.full(3, 0.5), rtol=1e-6)
    np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(o2, np.full(2, 3.0))
    np.testing.assert_array_equal(o2, r2)


def test_kvstore_dist_mode_single_process(monkeypatch):
    for name in ("dist_tpu_sync", "dist_sync", "dist_device_sync", "nccl"):
        kv = tmx.kvstore.create(name)
        assert kv.rank == 0 and kv.num_workers == 1
        with tmx.cpu():
            kv.init("0", tmx.nd.ones((2,)))
        kv.barrier()
    with pytest.raises(MXNetError):
        tmx.kvstore.create("dist_async")
    with pytest.raises(MXNetError):
        tmx.kvstore.create("nope")
    assert tmx.kv is tmx.kvstore
    # several workers declared and no job joined: a store that could not
    # sum across them raises (tests/test_torch_dist.py runs the job)
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    with pytest.raises(MXNetError, match="parallel.initialize"):
        tmx.kvstore.create("dist_sync")


def test_gradient_compression_2bit_error_feedback():
    g = np.array([[0.3, -0.45], [0.4, 0.05]], dtype="float32")

    def run(pkg):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros((2, 2)))
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        pulls = []
        out = pkg.nd.zeros((2, 2))
        for _ in range(40):
            kv.push("w", _nd(pkg, g))
            kv.pull("w", out=out)
            pulls.append(out.asnumpy().copy())
        return np.stack(pulls)
    own, ref = _both(run)
    np.testing.assert_array_equal(own, ref)
    assert set(np.unique(own[0])).issubset({-0.5, 0.0, 0.5})
    np.testing.assert_allclose(own.mean(0), g, atol=0.5 / 40 + 1e-3)


def test_gradient_compression_int8():
    g = (np.random.default_rng(0).random((8, 8)) * 4 - 2).astype("float32")

    def run(pkg):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros((8, 8)))
        kv.set_gradient_compression({"type": "int8"})
        out = pkg.nd.zeros((8, 8))
        kv.push("w", _nd(pkg, g))
        kv.pull("w", out=out)
        first = out.asnumpy().copy()
        kv.push("w", _nd(pkg, g))
        kv.pull("w", out=out)
        return first, out.asnumpy()
    (f, s), (rf, rs) = _both(run)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(s, rs)
    scale = np.abs(g).max() / 127.0
    np.testing.assert_allclose(f, g, atol=scale * 0.51 + 1e-6)


def test_gradient_compression_rejects_unknown_type():
    kv = tmx.kv.create("local")
    with pytest.raises(MXNetError):
        kv.set_gradient_compression({"type": "8byte"})


def test_gradient_compression_validation_and_reinit():
    kv = tmx.kv.create("local")
    for t in (0, -0.5):
        with pytest.raises(MXNetError):
            kv.set_gradient_compression({"type": "2bit", "threshold": t})
    kv.set_gradient_compression({"type": "int8"})
    with tmx.cpu():
        kv.init("w", tmx.nd.zeros((2, 2)))
        kv.push("w", tmx.nd.array(np.ones((2, 2), "float32")))
        kv.init("w", tmx.nd.zeros((3, 3)))       # a new residual history
        kv.push("w", tmx.nd.array(np.ones((3, 3), "float32")))
        out = tmx.nd.zeros((3, 3))
    kv.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), np.ones((3, 3)), atol=0.02)
    with pytest.raises(MXNetError, match="not been initialized"):
        with tmx.cpu():
            kv.push("nokey", tmx.nd.ones((1,)))


def test_optimizer_states_files_cross_packages(tmp_path):
    """``save_optimizer_states`` writes the reference's ``.states``
    format: each package's file loads into the other's store and the next
    push gives the same value."""
    g = np.random.default_rng(1).standard_normal((4,)).astype("float32")

    def make(pkg):
        kv = pkg.kvstore.create("local")
        kv.init(0, pkg.nd.ones((4,)))
        kv.set_optimizer(pkg.optimizer.create("adam", learning_rate=0.1))
        return kv

    def run(pkg, load_from=None):
        kv = make(pkg)
        if load_from is not None:
            kv.load_optimizer_states(load_from)
        kv.push(0, _nd(pkg, g))
        out = pkg.nd.zeros((4,))
        kv.pull(0, out=out)
        return kv, out.asnumpy()
    with tmx.cpu():
        tkv, first = run(tmx)
    jkv, rfirst = run(jmx)
    np.testing.assert_allclose(first, rfirst, rtol=1e-6, atol=1e-7)
    tkv.save_optimizer_states(str(tmp_path / "own.states"))
    jkv.save_optimizer_states(str(tmp_path / "ref.states"))
    with tmx.cpu():
        _, a = run(tmx, str(tmp_path / "ref.states"))
        _, b = run(tmx, str(tmp_path / "own.states"))
    _, c = run(jmx, str(tmp_path / "own.states"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)


def test_row_sparse_pull_broadcast_and_retry():
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    from mxnet_tpu_torch.resilience import chaos
    w = np.arange(12, dtype="float32").reshape(6, 2)
    kv = tmx.kv.create("local")
    with tmx.cpu():
        kv.broadcast("w", tmx.nd.array(w), out=tmx.nd.zeros((6, 2)))
        out = tmx.nd.array(np.zeros((6, 2), "float32")).tostype(
            "row_sparse")
        assert isinstance(out, RowSparseNDArray)
        kv.row_sparse_pull("w", out=out, row_ids=tmx.nd.array([4, 1, 4]))
        np.testing.assert_array_equal(out.indices.asnumpy(), [1, 4])
        np.testing.assert_array_equal(out.data.asnumpy(), w[[1, 4]])
        dense = np.zeros((6, 2), "float32")
        np.testing.assert_array_equal(out.asnumpy()[[1, 4]], w[[1, 4]])
        np.testing.assert_array_equal(out.asnumpy()[[0, 2, 3, 5]],
                                      dense[[0, 2, 3, 5]])
        with pytest.raises(MXNetError, match="out of range"):
            kv.row_sparse_pull("w", out=out, row_ids=[7])
        # a transient fault at the push is retried, applied once
        chaos.arm("kvstore.push", "transient", first=1)
        try:
            kv.push("w", tmx.nd.ones((6, 2)))
        finally:
            chaos.clear()
        full = tmx.nd.zeros((6, 2))
    kv.pull("w", out=full)
    np.testing.assert_array_equal(full.asnumpy(), np.ones((6, 2)))
