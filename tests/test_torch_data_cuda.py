"""The data path's staging and the generation programs' graphs, on a
card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The module imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_data_cuda.py

Checks (tolerance 0 throughout: the same bytes, the same kernels):

- ``DeviceFeed``'s pinned ring: under a consumer slower than the stager,
  and with a source that refills one host buffer in place for every
  batch, every staged batch equals its host batch (a pinned slot reused
  before its copy ended, or a device buffer handed out again while the
  consumer's kernels read it, would show here as a stale batch).
- ``DataLoader(pin_memory=True)`` gives CUDA NDArrays equal to the
  unpinned loader's batches; ``ImageRecordIter`` on the native pump feeds
  a ``DeviceFeed`` whose batches equal the pump's.
- ``ShardedTrainer.step_stream`` on a small conv-BatchNorm net equals
  ``step()`` calls over the same batches (cuDNN's deterministic
  algorithms).
- The generation programs as CUDA graphs: a prefill graph captured on
  slot 0 and replayed on slot 3, a chunk graph likewise, and decode steps,
  leave the arena bit for bit as an eager engine leaves it; greedy streams
  through a scheduler are token for token the eager engine's; after the
  burst ``compile_stats()`` shows one decode graph and at most one prefill
  graph a rung.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import initializer, recordio
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.io import ImageRecordIter
from mxnet_tpu_torch.models import TransformerLM
from mxnet_tpu_torch.parallel import DeviceFeed, ShardedTrainer
from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                GenerationScheduler)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned ring and the graphs "
                    "exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_pinned_ring_is_never_stale(cuda, depth):
    rng = np.random.default_rng(depth)
    host = [rng.standard_normal((64, 3, 32, 32)).astype("float32")
            for _ in range(16)]
    labels = [np.full(64, i, "float32") for i in range(16)]
    shared = np.empty_like(host[0])

    def refilled():
        for x, y in zip(host, labels):
            shared[...] = x          # the source reuses one buffer
            yield shared, y

    for source in (list(zip(host, labels)), refilled()):
        feed = DeviceFeed(source, depth=depth, name="t.ring%d" % depth)
        seen = 0
        for (xs, y), x_host in zip(feed, host):
            assert xs[0].is_cuda
            # the consumer's own work on its stream, slower than staging
            junk = torch.empty(4 << 20, device=cuda).normal_()
            assert torch.equal(xs[0].cpu(), torch.from_numpy(x_host))
            assert float(y[0]) == seen
            del junk
            time.sleep(0.01)
            seen += 1
        assert seen == 16
        st = feed.stats()
        feed.close()
        assert st["batches"] == 16
        assert st["bytes_staged"] == 16 * (host[0].nbytes + 256)


@pytest.mark.cuda
def test_pinned_dataloader_and_native_pump_feed(cuda, tmp_path):
    X = np.random.default_rng(0).standard_normal((40, 8)).astype("float32")
    Y = np.arange(40).astype("float32")
    plain = [(x.asnumpy(), y.asnumpy())
             for x, y in DataLoader(ArrayDataset(X, Y), batch_size=8)]
    pinned = list(DataLoader(ArrayDataset(X, Y), batch_size=8,
                             pin_memory=True, num_workers=2))
    assert len(pinned) == len(plain) == 5
    for (x, y), (hx, hy) in zip(pinned, plain):
        assert x.ctx.device_type == "gpu"
        np.testing.assert_array_equal(x.asnumpy(), hx)
        np.testing.assert_array_equal(y.asnumpy(), hy)
    path = str(tmp_path / "imgs.rec")
    rec = recordio.MXRecordIO(path, "w")
    rng = np.random.default_rng(1)
    for i in range(24):
        rec.write(recordio.pack_img(
            recordio.IRHeader(0, float(i % 7), i, 0),
            rng.integers(0, 256, (40, 44, 3), dtype=np.uint8),
            img_fmt=".raw"))
    rec.close()
    kw = dict(data_shape=(3, 32, 36), batch_size=8, rand_crop=True,
              rand_mirror=True, mean_r=120.0, std_r=50.0)
    first = ImageRecordIter(path, **kw)
    ref = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in first]
    first.close()
    it = ImageRecordIter(path, **kw)
    assert it.native
    with DeviceFeed(it, depth=2, name="t.pump") as feed:
        got = [(xs[0].cpu().numpy(), y.cpu().numpy()) for xs, y in feed]
    it.close()
    assert len(got) == len(ref) == 3
    for (a, b), (c, d) in zip(got, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.cuda
def test_step_stream_equals_step_calls(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((6, 16, 3, 16, 16)).astype("float32")
    Y = rng.integers(0, 4, (6, 16)).astype("float32")
    trandom.seed(3)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(4, in_units=8))
    net.initialize(initializer.Xavier(), ctx=mx.gpu())
    net(mx.nd.zeros((1, 3, 16, 16), ctx=mx.gpu()))
    hyper = {"learning_rate": 0.05, "momentum": 0.9}
    a = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(hyper))
    b = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(hyper))
    la = torch.stack([a.step(X[i], Y[i]) for i in range(6)])
    with DeviceFeed([(X[i], Y[i]) for i in range(6)], depth=2,
                    name="t.stream") as feed:
        lb = b.step_stream(feed, chunk=4)
    assert torch.equal(la, lb)
    for n, v in a.values.items():
        assert torch.equal(v, b.values[n]), n


def _lm(cuda):
    net = TransformerLM(1024, units=64, num_layers=2, num_heads=4,
                        max_len=128, device=cuda)
    for p in net.parameters():
        with torch.no_grad():
            p.normal_(0, 0.02, generator=torch.Generator(cuda).manual_seed(
                p.numel()))
    return net.eval()


def _pair(net, cuda, **kw):
    args = dict(num_slots=4, max_seq=128, ladder=(16, 32), chunk=16,
                prefix_cache=False, device=cuda)
    args.update(kw)
    return (DecodeEngine(net, name="t.graphs", **args),
            DecodeEngine(net, cached=False, name="t.eager", **args))


@pytest.mark.cuda
def test_graph_captured_on_one_slot_writes_the_slot_it_is_replayed_on(cuda):
    net = _lm(cuda)
    graphs, eager = _pair(net, cuda)
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, 1024, 12).tolist()
    p2 = rng.integers(0, 1024, 9).tolist()
    p3 = rng.integers(0, 1024, 40).tolist()
    try:
        for eng in (graphs, eager):
            for _ in range(4):
                eng.cache.acquire()
            toks = [eng.prefill(0, p1), eng.prefill(3, p2)]
            eng.prefill_chunks(1, p3, 0)
            eng.prefill_chunks(2, p3[:20], 0)
            cur = np.array(toks + [1, 2])
            for _ in range(3):
                cur = eng.decode_step(cur, np.zeros(4, "float32"))
                eng.cache.advance([0, 1, 2, 3])
            eng.out = cur
        st = graphs.compile_stats()
        assert st["prefill"]["misses"] == 1 and st["prefill"]["hits"] == 1
        assert st["prefill"]["graphs"] == 1 and st["decode"]["graphs"] == 1
        assert st["chunk"]["misses"] >= 1 and st["chunk"]["hits"] >= 2
        for k in ("k_arena", "v_arena"):
            assert torch.equal(getattr(graphs.cache, k),
                               getattr(eager.cache, k)), k
        assert np.array_equal(graphs.out, eager.out)
    finally:
        graphs.close()
        eager.close()


@pytest.mark.cuda
def test_greedy_streams_replay_equal_eager_and_churn_captures_nothing(cuda):
    net = _lm(cuda)
    graphs, eager = _pair(net, cuda, chunk=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 1024, int(n)).tolist()
               for n in rng.integers(3, 30, 10)]
    budgets = [int(n) for n in rng.integers(2, 12, 10)]
    out = []
    try:
        for eng in (graphs, eager):
            with GenerationScheduler(eng) as sched:
                reqs = [sched.submit(p, max_new_tokens=n)
                        for p, n in zip(prompts, budgets)]
                out.append([r.result(timeout=300) for r in reqs])
        assert out[0] == out[1]
        st = graphs.compile_stats()
        assert st["decode"]["misses"] == 1 and st["decode"]["graphs"] == 1
        assert st["prefill"]["misses"] <= len(graphs.ladder)
        assert eager.compile_stats()["decode"]["misses"] == 0
    finally:
        graphs.close()
        eager.close()
