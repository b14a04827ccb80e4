"""``CachedOp``'s CUDA-graph path, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a graph is captured only on the card; the CPU tests hold the
cache's counters and the eager path). The module imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cached_op_cuda.py

Checks: a hybridized model's replay equals its eager forward bit for bit
(the same kernels on the same shapes); outputs are cloned out of the
graph, so a later replay does not change an earlier result; a capture
that fails (a host sync inside the function) raises; under
``autograd.record()`` nothing is captured and gradients flow; the op's
shared pool survives evictions and ``clear()``; a parameter given new
storage (``Parameter.cast``, ``reset_ctx``, a module's ``.to``) makes
every op capture again.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.cached_op import CachedOp
from mxnet_tpu_torch.models import bert_tiny

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, rng, n, T=32, V=100):
    return (torch.from_numpy(rng.integers(0, V, (n, T)).astype("float32"))
            .to(cuda), torch.zeros((n, T), device=cuda),
            torch.from_numpy(rng.integers(1, T + 1, n).astype("float32"))
            .to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybridized_replay_equals_eager(cuda, dtype):
    net = bert_tiny(vocab_size=100, max_length=32, device=cuda)
    net.eval()
    if dtype == "bfloat16":
        net.cast(dtype)
    net.hybridize()
    rng = np.random.default_rng(0)
    with autograd.predict_mode():
        for n in (1, 3, 3):
            t, s, v = _inputs(cuda, rng, n)
            got = net(nd.NDArray(t), nd.NDArray(s), nd.NDArray(v))
            with torch.no_grad():
                ref = net(t, s, v)
            for g, r in zip(got, ref):
                assert torch.equal(g._data, r)
    op = next(iter(net._cached_ops.values()))
    st = op.cache_stats()
    assert (st["misses"], st["hits"], st["graphs"]) == (2, 1, 2)
    assert st["pool_bytes"] > 0 and len(op.capture_ms) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("rebind", ["parameter_cast", "reset_ctx",
                                    "module_to"])
def test_a_storage_rebind_drops_the_graphs(cuda, rebind):
    """Graphs captured before the parameters get new storage are not
    replayed after it: the hybridized model's own op and a served
    function's op over its encoder capture again and equal the eager
    forward on the new values. The captured storage is kept alive, so a
    stale replay would read the old values."""
    from mxnet_tpu_torch import cpu, gpu
    net = bert_tiny(vocab_size=100, max_length=32, device=cuda)
    net.eval()
    net.hybridize()
    served = CachedOp(lambda t, s, v: net.encoder(t, s, v))
    xs = _inputs(cuda, np.random.default_rng(1), 2)
    nds = [nd.NDArray(x) for x in xs]
    params = net.collect_params()
    with autograd.predict_mode():
        net(*nds), served(*nds)
        old = [p.tensor().data for p in params.values()]
        if rebind == "parameter_cast":
            for p in params.values():
                p.cast("bfloat16")
        elif rebind == "reset_ctx":
            params.reset_ctx(cpu())
            params.reset_ctx(gpu(0))
        else:
            net.to(torch.bfloat16)
        for p in params.values():                # new values as well
            p.set_data(p.data() * 0.5)
        got = list(net(*nds)) + [served(*nds)]
        with torch.no_grad():
            ref = list(net(*xs)) + [net.encoder(*xs)]
    assert all(a.data_ptr() != p.tensor().data_ptr()
               for a, p in zip(old, params.values()))
    for g, r in zip(got, ref):
        assert torch.equal(g._data, r)
    # .to() replaces the block's own op (a new one, one miss); the other
    # rebinds leave it in place to capture again
    own = next(iter(net._cached_ops.values())).cache_stats()
    assert own["misses"] == (1 if rebind == "module_to" else 2)
    assert own["graphs"] == 1
    assert served.cache_stats()["misses"] == 2
    assert served.cache_stats()["graphs"] == 1


@pytest.mark.cuda
def test_outputs_are_cloned_out_of_the_graph(cuda):
    op = CachedOp(lambda x: x * 2.0)
    a = op(nd.NDArray(torch.ones(4, device=cuda)))
    b = op(nd.NDArray(torch.full((4,), 3.0, device=cuda)))
    torch.cuda.synchronize()
    assert a.asnumpy().tolist() == [2.0] * 4
    assert b.asnumpy().tolist() == [6.0] * 4
    assert op.cache_stats()["graphs"] == 1


@pytest.mark.cuda
def test_recording_captures_nothing(cuda):
    w = nd.NDArray(torch.ones(4, device=cuda))
    w.attach_grad()
    op = CachedOp(lambda x: (x * w).sum())
    x = nd.NDArray(torch.arange(4.0, device=cuda))
    with autograd.record():
        y = op(x)
    y.backward()
    assert w.grad.asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert op.cache_stats()["graphs"] == 0
    op(x)                                     # not recording: a graph now
    assert op.cache_stats()["graphs"] == 1


@pytest.mark.cuda
def test_pool_survives_eviction_and_clear(cuda):
    op = CachedOp(lambda x: x + 1.0, capacity=1)
    for n in (1, 2, 3):
        out = op(nd.NDArray(torch.zeros(n, device=cuda)))
        assert out.asnumpy().tolist() == [1.0] * n
    assert op.cache_stats()["evictions"] == 2
    op.clear()
    assert op.cache_stats()["pool_bytes"] == 0
    out = op(nd.NDArray(torch.zeros(5, device=cuda)))
    assert out.asnumpy().tolist() == [1.0] * 5


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda):
    def host_sync(x):
        return x * float(x.sum().asscalar())     # .item() inside a capture

    op = CachedOp(host_sync)
    with pytest.raises(RuntimeError):
        op(nd.NDArray(torch.ones(4, device=cuda)))
    assert op.cache_stats()["graphs"] == 0
