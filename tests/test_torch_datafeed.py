"""The port's ``DeviceFeed``, ``ShardedTrainer.step_stream`` and
``DataLoader(pin_memory=True)`` on the CPU (the cases of
``tests/test_datafeed.py`` that apply to one device), and ``step_stream``
against the JAX package's.

- The feed stages a list, a ``DataLoader``, an ``NDArrayIter`` and
  multi-input batches with their values intact (bitwise); a prefilled feed
  holds ``depth`` batches before anything is consumed and a slower
  consumer never waits on it; a source's error reaches the consumer; the
  feed restarts, resets, refuses use after ``close()``, leaves the stats
  registry when collected, keeps namedtuple batches, shows in the
  profiler rows and in ``/metrics``, and stages over a mesh or a plan's
  data axes (a ``ShardedTensor`` each array, ROADMAP item 10a).
- ``step_stream`` gives the losses and parameters of ``step()`` calls over
  the same batches, bitwise, in chunks of 4 + 2; on a small conv-BatchNorm
  net it also follows the reference's ``step_stream`` (losses within 1e-5
  relative, float32: the same arithmetic in another order). A chaos fault
  at a chunk boundary hands the peeked batch back, and the resumed stream
  ends bitwise where an unbroken one does; a dry feed fires no chaos
  point; ``steps`` bounds the run.
- ``PrefetchingIter`` relays a source's error without wedging and resets
  mid-epoch.
"""
import gc
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.io import NDArrayIter, PrefetchingIter
from mxnet_tpu_torch.parallel import DeviceFeed, ShardedTrainer, datafeed
from mxnet_tpu_torch.resilience import _stats, chaos
from mxnet_tpu_torch.resilience.chaos import FatalFault
from mxnet_tpu_torch.serving import ModelServer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _block_names_as_found():
    """Leave both packages' block-name counters as this file found them:
    later tests in the same process compare parameter names that the
    counters number."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock
    saved = [(m, dict(m._global_counter)) for m in (jblock, tblock)]
    yield
    for m, counts in saved:
        m._global_counter.clear()
        m._global_counter.update(counts)


def _batches(n, batch=16, din=8, ncls=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((batch, din)).astype("float32"),
             rng.randint(0, ncls, batch).astype("float32"))
            for _ in range(n)]


def _feed(src, **kw):
    return DeviceFeed(src, device="cpu", **kw)


def _mlp_trainer(seed=0):
    trandom.seed(seed)
    with tmx.cpu():
        net = tnn.HybridSequential()
        net.add(tnn.Dense(16, activation="relu", in_units=8),
                tnn.Dense(4, in_units=16))
        net.initialize(tinit.Xavier())
    return ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                          {"learning_rate": 0.05}, device="cpu"), net


def test_feed_stages_sources_intact():
    batches = _batches(5)
    with _feed(batches, depth=2, name="t.basic") as feed:
        out = list(feed)
    assert len(out) == 5
    for (xs, y), (hx, hy) in zip(out, batches):
        assert isinstance(xs, tuple) and len(xs) == 1
        np.testing.assert_array_equal(xs[0].numpy(), hx)
        np.testing.assert_array_equal(y.numpy(), hy)
        assert xs[0].data_ptr() != torch.from_numpy(hx).data_ptr()
    X = np.random.randn(32, 8).astype("float32")
    Y = np.arange(32).astype("float32")
    with tmx.cpu():
        dl = DataLoader(ArrayDataset(tmx.nd.array(X), tmx.nd.array(Y)),
                        batch_size=8)
    with _feed(dl, name="t.dl") as feed:
        got = list(feed)
    assert len(got) == 4
    np.testing.assert_array_equal(got[0][0][0].numpy(), X[:8])
    with _feed(NDArrayIter(X, Y, batch_size=8), name="t.iter") as feed:
        got = list(feed)
    np.testing.assert_array_equal(got[2][1].numpy(), Y[16:24])
    rng = np.random.RandomState(0)
    src = [((rng.standard_normal((8, 4)).astype("float32"),
             rng.standard_normal((8, 2)).astype("float32")),
            rng.randint(0, 2, 8).astype("float32")) for _ in range(3)]
    with _feed(src, name="t.multi") as feed:
        out = list(feed)
    assert len(out[0][0]) == 2
    np.testing.assert_array_equal(out[1][0][1].numpy(), src[1][0][1])


def test_feed_stages_ahead_and_never_waits_after_warmup():
    depth = 3
    feed = _feed(_batches(10, batch=8), depth=depth, name="t.ahead")
    try:
        assert feed.prefill(timeout=30.0) == depth
        assert feed.stats()["bytes_staged"] >= depth * 8 * 9 * 4
        it = iter(feed)
        next(it)
        deadline = time.monotonic() + 10.0
        while feed.stats()["depth_occupancy"] < depth - 1 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        assert feed.stats()["depth_occupancy"] >= depth - 1
        for _ in it:
            time.sleep(0.005)      # a consumer slower than the staging
        st = feed.stats()
        assert st["batches"] == 10 and st["stage_waits"] == 0, st
    finally:
        feed.close()


def test_feed_relays_errors_restarts_and_resets():
    def bad_source():
        yield (np.zeros((8, 8), "float32"), np.zeros(8, "float32"))
        raise ValueError("decode failed")

    feed = _feed(bad_source(), name="t.err")
    it = iter(feed)
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    feed.close()
    feed = _feed(_batches(4), name="t.reiter")
    assert sum(1 for _ in feed) == 4
    assert sum(1 for _ in feed) == 4
    feed.close()
    X = np.random.randn(32, 8).astype("float32")
    feed = _feed(NDArrayIter(X, np.arange(32).astype("float32"),
                             batch_size=8), depth=2, name="t.reset")
    next(iter(feed))
    feed.reset()
    assert sum(1 for _ in feed) == 4
    feed.close()
    with pytest.raises(RuntimeError, match="closed"):
        iter(feed)
    feed.reset()
    assert sum(1 for _ in feed) == 4
    feed.close()


def test_feed_stats_rows_gauge_and_collection():
    feed = _feed(_batches(3), name="t.rows")
    list(feed)
    rows = _stats.aggregate_rows()
    assert rows["datafeed.t.rows.batches"][0] == 3
    assert rows["datafeed.t.rows.bytes_staged"][0] > 0
    assert "datafeed.t.rows.stage_wait_ms" in rows
    assert "datafeed.t.rows.depth_occupancy" in rows
    with tmx.cpu():
        srv = ModelServer(lambda x: x, port=0, jit=False).start()
    try:
        assert srv.metrics_snapshot()["datafeed"]["t.rows"]["batches"] == 3
    finally:
        srv.stop()
    feed.close()
    assert "datafeed.t.rows.batches" not in _stats.aggregate_rows()
    feed = _feed(_batches(2), depth=2, name="t.gcreg")
    list(feed)
    assert "t.gcreg" in datafeed.feed_stats()
    del feed
    gc.collect()
    assert "t.gcreg" not in datafeed.feed_stats()


def test_feed_batch_output_keeps_structure_and_refuses_meshes():
    Batch = namedtuple("Batch", ["data", "label"])
    src = [Batch(np.random.randn(8, 4).astype("float32"),
                 np.arange(8).astype("float32")) for _ in range(2)]
    with _feed(src, output="batch", depth=2, name="t.ntuple") as feed:
        out = list(feed)
    assert len(out) == 2 and isinstance(out[0], Batch)
    assert isinstance(out[0].data, tmx.nd.NDArray)
    np.testing.assert_array_equal(out[1].label.asnumpy(), src[1].label)
    with pytest.raises(ValueError):
        _feed([], depth=0)
    with pytest.raises(ValueError):
        _feed([], output="tensors")
    # a mesh or a plan stages each array sharded over the data axes
    from mxnet_tpu_torch.parallel.planner import ShardingPlan
    mesh = tmx.parallel.make_mesh(dp=4, devices=[tmx.cpu(i)
                                                 for i in range(4)])
    xs = np.random.randn(8, 4).astype("float32")
    for kw in ({"mesh": mesh}, {"plan": ShardingPlan(dp=2, ep=2)}):
        with _feed([(xs, np.arange(8.0))], **kw) as feed:
            (x,), y = next(iter(feed))
        assert len(x.shards) == 4 and x.shards[1].shape == (2, 4)
        assert tuple(x.spec)[0] == (("dp",) if "mesh" in kw
                                    else ("dp", "ep"))
        np.testing.assert_array_equal(x.numpy(), xs)
        np.testing.assert_array_equal(y.numpy(), np.arange(8.0))
    with pytest.raises(ValueError, match="arrays only"):
        _feed([], mesh=mesh, output="batch")


def test_pinned_dataloader_stages_and_abandoned_feed_retires():
    X = np.random.randn(24, 8).astype("float32")
    Y = np.arange(24).astype("float32")
    with tmx.cpu():
        dl = DataLoader(ArrayDataset(X, Y), batch_size=8, pin_memory=True)
        seen = 0
        for x, y in dl:
            assert isinstance(x, tmx.nd.NDArray)
            np.testing.assert_array_equal(x.asnumpy(),
                                          X[seen * 8:(seen + 1) * 8])
            seen += 1
        assert seen == 3 and sum(1 for _ in dl) == 3
    feed = _feed(_batches(8), depth=2, name="t.abandon")
    it = iter(feed)
    next(it)
    thread = feed._thread
    del feed, it
    gc.collect()
    deadline = time.monotonic() + 10.0
    while thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not thread.is_alive()


def test_step_stream_bitwise_matches_step_calls():
    batches = _batches(6, seed=11)
    st1, _ = _mlp_trainer(seed=2)
    st2, _ = _mlp_trainer(seed=2)
    losses1 = torch.stack([st1.step(x, y) for x, y in batches])
    feed = _feed(list(batches), name="t.bitwise")
    losses2 = st2.step_stream(feed, chunk=4)         # chunks of 4 + 2
    feed.close()
    assert torch.equal(losses1, losses2)
    for n, v in st1.values.items():
        assert torch.equal(v, st2.values[n]), n
    assert st2._t == 6
    losses = st2.step_stream(_batches(8), steps=5, chunk=2)
    assert losses.shape == (5,) and st2._t == 11
    assert st2.step_stream(_batches(2), steps=0).shape == (0,)


def _conv_bn(mod, nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(4, in_units=8))
    return net


def test_step_stream_conv_bn_matches_step_and_reference():
    rng = np.random.RandomState(3)
    X = rng.randn(6, 16, 3, 8, 8).astype("float32")
    Y = rng.randint(0, 4, (6, 16)).astype("float32")
    trandom.seed(3)
    with tmx.cpu():
        nets = [_conv_bn(tmx, tnn) for _ in range(2)]
        for net in nets:
            net.initialize(tinit.Xavier())
            net(tmx.nd.zeros((1, 3, 8, 8)))
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        q.set_data(p.data())
    ref = _conv_bn(jmx, jgluon.nn)
    ref.initialize()
    for p, q in zip(ref.collect_params().values(),
                    nets[0].collect_params().values()):
        p.set_data(jmx.nd.array(q.data().asnumpy()))
        p._finish_deferred_init()
    hyper = {"learning_rate": 0.05}
    st1 = ShardedTrainer(nets[0], SoftmaxCrossEntropyLoss(), "sgd",
                         dict(hyper), device="cpu")
    losses1 = torch.stack([st1.step(X[i], Y[i]) for i in range(6)])
    st2 = ShardedTrainer(nets[1], SoftmaxCrossEntropyLoss(), "sgd",
                         dict(hyper), device="cpu")
    losses2 = st2.step_stream([(X[i], Y[i]) for i in range(6)], chunk=4)
    assert torch.equal(losses1, losses2)
    for n, v in st1.values.items():
        assert torch.equal(v, st2.values[n]), n
    jst = jparallel.ShardedTrainer(
        ref, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(hyper),
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    jfeed = jparallel.DeviceFeed([(X[i], Y[i]) for i in range(6)],
                                 mesh=jst.mesh, name="t.ref")
    jl = jst.step_stream(jfeed, chunk=4).asnumpy()
    jfeed.close()
    np.testing.assert_allclose(losses2.numpy(), jl, rtol=1e-5)


@pytest.mark.chaos
def test_step_stream_chaos_restore_and_replay():
    batches = _batches(6, seed=7)
    ref, _ = _mlp_trainer(seed=1)
    ref_losses = ref.step_stream(list(batches), chunk=2)
    st, _ = _mlp_trainer(seed=1)
    feed = _feed(list(batches), depth=6, name="t.chaos")
    chaos.arm("trainer.step", "fatal", at=2)
    try:
        with pytest.raises(FatalFault):
            st.step_stream(feed, chunk=2)
    finally:
        chaos.clear()
    assert st._t == 2
    resumed = st.step_stream(feed, chunk=2)
    feed.close()
    assert torch.equal(ref_losses[2:], resumed)
    for n, v in ref.values.items():
        assert torch.equal(v, st.values[n]), n
    rule = chaos.arm("trainer.step", "fatal", at=4)
    try:
        assert st.step_stream(_batches(6), chunk=2).shape == (6,)
    finally:
        chaos.clear()
    assert rule.calls == 3          # three chunks; the dry tail fires none
    # an eviction notice stops the stream at a chunk boundary, before
    # the chunk takes a batch (tests/test_torch_elastic.py has the rest)
    from mxnet_tpu_torch.resilience.elastic import (Preempted,
                                                    PreemptionHandler)
    handler = PreemptionHandler(grace_ms=1000)
    handler.trigger()
    t_before = st._t
    with pytest.raises(Preempted) as caught:
        st.step_stream(_batches(2), preemption=handler)
    assert st._t == t_before and caught.value.step == t_before


def test_prefetching_iter_relays_errors_and_resets():
    class Boom(NDArrayIter):
        def next(self):
            if self.cursor >= 16:
                raise ValueError("decode failed")
            return super().next()

    X = np.random.randn(32, 8).astype("float32")
    it = PrefetchingIter(Boom(X, np.arange(32).astype("float32"),
                              batch_size=8))
    got = 0
    with pytest.raises(ValueError, match="decode failed"):
        while True:
            it.next()
            got += 1
    assert got == 3
    it.reset()
    assert it.next() is not None
    it.close()
    it = PrefetchingIter(NDArrayIter(X, np.arange(32).astype("float32"),
                                     batch_size=8))
    it.next()
    it.next()
    it.reset()
    assert sum(1 for _ in it) == 4
    it.close()
