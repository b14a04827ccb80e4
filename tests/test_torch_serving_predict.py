"""The port's ``/predict`` stack: ``InferenceEngine``, ``DynamicBatcher``,
``ServingMetrics``, ``CachedOp`` and ``ModelServer``.

The cases of the JAX package's ``tests/test_serving.py`` (engine bucket
padding, compile bound, chunking and warmup; batcher coalescing, row
mapping, signatures, deadlines, backpressure, drain and model errors;
metrics; the CachedOp LRU and its counters; the HTTP endpoints), run on
the CPU against numpy references at 1e-5 (float32,
sums in another order), and the end-to-end BERT case over HTTP held
value for value against the reference's ``InferenceEngine`` over the same
weights at 1e-5. Its
``test_engine_load_from_export_artifacts`` waits for the symbol frontend,
and its two profiler cases for the profiler (ROADMAP Queue A items 9 and
11). Its batched-throughput case is not carried over: it times thread
handoffs on the CPU, where a torch call costs 0.1-0.4 ms and the ratio
fell to 0.1-0.4x under six processes of load; the batching gain is
measured on the card (``chip_smoke.py``'s predict phase). Every future,
join and HTTP call has a timeout.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.serving import InferenceEngine as JaxEngine
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.cached_op import CachedOp, cache_stats, \
    reset_cache_stats
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.serving import (DeadlineExceeded, DynamicBatcher,
                                     InferenceEngine, ModelServer,
                                     ServerBusy, ServerClosed,
                                     ServingMetrics)

torch.set_num_threads(1)
D_IN, D_OUT = 8, 3
_W = np.linspace(-1, 1, D_IN * D_OUT).reshape(D_IN, D_OUT).astype("float32")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _linear(x):
    """Tiny deterministic model: (n, D_IN) -> (n, D_OUT)."""
    return nd.dot(x, nd.array(_W))


def _ref(x):
    return np.asarray(x, "float32") @ _W


# ---------------------------------------------------------------------------
# InferenceEngine
# ---------------------------------------------------------------------------

def test_engine_bucket_padding_and_unpad():
    seen = []

    def spy(x):
        seen.append(x.shape[0])
        return _linear(x)

    eng = InferenceEngine(spy, buckets=(2, 4, 8), jit=False)
    for n in (1, 3, 4, 7, 2):
        x = np.random.randn(n, D_IN).astype("float32")
        out = eng.predict(x)
        assert out.shape == (n, D_OUT)
        np.testing.assert_allclose(out.asnumpy(), _ref(x), rtol=TOL,
                                   atol=1e-6)
    assert seen == [2, 4, 4, 8, 2]
    assert eng.stats()["buckets_seen"] == [2, 4, 8]


def test_engine_compile_bound_100_mixed_requests():
    buckets = (1, 2, 4, 8, 16, 32)
    eng = InferenceEngine(_linear, buckets=buckets)
    rng = np.random.default_rng(0)
    for _ in range(100):
        n = int(rng.integers(1, 33))
        x = rng.standard_normal((n, D_IN)).astype("float32")
        out = eng.predict(x)
        assert out.shape == (n, D_OUT)
        np.testing.assert_allclose(out.asnumpy(), _ref(x), rtol=TOL,
                                   atol=TOL)
    st = eng.stats()
    assert st["compiles"] <= len(buckets), st
    assert st["hits"] + st["misses"] >= 100


def test_engine_oversize_batch_chunks():
    eng = InferenceEngine(_linear, buckets=(2, 4))
    x = np.random.randn(11, D_IN).astype("float32")
    out = eng.predict(x)
    assert out.shape == (11, D_OUT)
    np.testing.assert_allclose(out.asnumpy(), _ref(x), rtol=TOL, atol=1e-6)
    assert eng.stats()["compiles"] <= 2


@pytest.mark.parametrize("threads", [1, 4])
def test_engine_warmup_precompiles_all_buckets(threads):
    eng = InferenceEngine(_linear, buckets=(1, 2, 4))
    eng.warmup(np.zeros(D_IN, "float32")[None], threads=threads)
    st = eng.stats()
    assert st["buckets_seen"] == [1, 2, 4]
    compiles_after_warmup = st["compiles"]
    assert compiles_after_warmup == 3
    for n in (1, 2, 3, 4):
        eng.predict(np.random.randn(n, D_IN).astype("float32"))
    assert eng.stats()["compiles"] == compiles_after_warmup
    eng.close()
    assert eng.stats()["size"] == 0


def test_engine_needs_a_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = tmx.context._thread_local.stack
    tmx.context._thread_local.stack = []
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(_linear)
    finally:
        tmx.context._thread_local.stack = saved
    assert InferenceEngine(_linear, ctx=tmx.cpu()).ctx == tmx.cpu()


# ---------------------------------------------------------------------------
# DynamicBatcher
# ---------------------------------------------------------------------------

def test_batcher_coalesces_concurrent_requests():
    calls = []

    def spy(x):
        calls.append(x.shape[0])
        return x * 2.0

    with DynamicBatcher(spy, max_batch_size=8, max_latency_ms=50) as b:
        futs = [b.submit(np.full((3,), i, "float32")) for i in range(8)]
        rows = [f.result(timeout=5) for f in futs]
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row, np.full((3,), 2.0 * i))
    assert len(calls) < 8
    assert sum(calls) == 8


def test_batcher_with_engine_correct_row_mapping():
    m = ServingMetrics()
    eng = InferenceEngine(_linear, buckets=(1, 2, 4, 8, 16), metrics=m)
    with DynamicBatcher(eng, max_batch_size=16, max_latency_ms=20,
                        metrics=m) as b:
        xs = [np.random.randn(D_IN).astype("float32") for _ in range(12)]
        futs = [b.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(timeout=10),
                                       _ref(x[None])[0], rtol=TOL,
                                       atol=TOL)
    snap = m.snapshot()
    assert snap["requests"] == 12 and snap["ok"] == 12
    assert snap["batches"] >= 1
    assert 0.0 < snap["batch_occupancy"] <= 1.0
    assert snap["executor_cache"]["misses"] >= 1


def test_batcher_mixed_signatures_split_into_batches():
    def echo_sum(x):
        return nd.sum(nd.array(x, ctx=tmx.cpu()),
                      axis=tuple(range(1, x.ndim)))

    with DynamicBatcher(echo_sum, max_batch_size=8,
                        max_latency_ms=30) as b:
        fa = [b.submit(np.ones((2,), "float32") * i) for i in range(3)]
        fb = [b.submit(np.ones((5,), "float32") * i) for i in range(3)]
        for i, f in enumerate(fa):
            np.testing.assert_allclose(f.result(timeout=5), 2.0 * i)
        for i, f in enumerate(fb):
            np.testing.assert_allclose(f.result(timeout=5), 5.0 * i)


def test_batcher_deadline_expiry():
    gate = threading.Event()
    entered = threading.Event()

    def slow(x):
        entered.set()
        assert gate.wait(10)
        return x

    m = ServingMetrics()
    b = DynamicBatcher(slow, max_batch_size=1, max_latency_ms=0, metrics=m)
    try:
        f1 = b.submit(np.zeros(2, "float32"))
        assert entered.wait(5)
        f2 = b.submit(np.zeros(2, "float32"), timeout_ms=30)
        time.sleep(0.15)
        gate.set()
        assert f1.result(timeout=5) is not None
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=5)
        assert m.snapshot()["expired"] == 1
    finally:
        gate.set()
        assert b.close(timeout=10)


def test_batcher_server_busy_backpressure_and_recovery():
    gate = threading.Event()
    entered = threading.Event()

    def slow(x):
        entered.set()
        assert gate.wait(10)
        return x + 1.0

    m = ServingMetrics()
    b = DynamicBatcher(slow, max_batch_size=1, max_latency_ms=0,
                       max_queue_size=2, metrics=m)
    try:
        f0 = b.submit(np.zeros(1, "float32"))
        assert entered.wait(5)
        deadline = time.monotonic() + 5
        queued = []
        while len(queued) < 2 and time.monotonic() < deadline:
            try:
                queued.append(b.submit(np.zeros(1, "float32")))
            except ServerBusy:
                time.sleep(0.01)
        assert len(queued) == 2
        with pytest.raises(ServerBusy):
            for _ in range(50):
                b.submit(np.zeros(1, "float32"))
        assert m.snapshot()["rejected"] >= 1
        gate.set()
        assert f0.result(timeout=5) is not None
        for f in queued:
            np.testing.assert_allclose(f.result(timeout=5), [1.0])
        np.testing.assert_allclose(
            b.submit(np.zeros(1, "float32")).result(timeout=5), [1.0])
    finally:
        gate.set()
        assert b.close(timeout=10)


def test_batcher_close_drains_in_flight():
    def slowish(x):
        time.sleep(0.02)
        return x * 3.0

    b = DynamicBatcher(slowish, max_batch_size=2, max_latency_ms=1)
    futs = [b.submit(np.full((1,), i, "float32")) for i in range(6)]
    assert b.close(drain=True, timeout=10)
    for i, f in enumerate(futs):
        assert f.done()
        np.testing.assert_allclose(f.result(timeout=1), [3.0 * i])
    with pytest.raises(ServerClosed):
        b.submit(np.zeros(1, "float32"))


def test_batcher_close_no_drain_fails_pending():
    gate = threading.Event()
    entered = threading.Event()

    def slow(x):
        entered.set()
        assert gate.wait(10)
        return x

    b = DynamicBatcher(slow, max_batch_size=1, max_latency_ms=0)
    b.submit(np.zeros(1, "float32"))
    assert entered.wait(5)
    pending = b.submit(np.zeros(1, "float32"))
    gate.set()
    assert b.close(drain=False, timeout=10)
    with pytest.raises(ServerClosed):
        pending.result(timeout=5)


def test_batcher_model_error_propagates():
    def boom(x):
        raise ValueError("bad weights")

    with DynamicBatcher(boom, max_batch_size=4, max_latency_ms=1) as b:
        f = b.submit(np.zeros(2, "float32"))
        with pytest.raises(ValueError, match="bad weights"):
            f.result(timeout=5)


# ---------------------------------------------------------------------------
# Metrics and the CachedOp
# ---------------------------------------------------------------------------

def test_metrics_percentiles_and_qps():
    m = ServingMetrics(window=64)
    for lat in (0.010, 0.020, 0.030, 0.040):
        m.record_request(lat)
    p = m.percentiles()
    assert p["p50"] == pytest.approx(20.0)
    assert p["p99"] == pytest.approx(40.0)
    snap = m.snapshot()
    assert snap["requests"] == 4 and snap["qps"] > 0
    assert snap["latency_ms"]["mean"] == pytest.approx(25.0)
    m.set_gauge_fn("extra", lambda: {"x": 1})
    assert m.snapshot()["extra"] == {"x": 1}


def test_cached_op_lru_bound_and_counters():
    op = CachedOp(lambda x: x * 2.0, capacity=2)
    for n in (1, 2, 3):
        op(nd.array(np.ones((n, 2), "float32")))
    st = op.cache_stats()
    assert st["size"] == 2 and st["capacity"] == 2
    assert st["misses"] == 3 and st["evictions"] == 1 and st["hits"] == 0
    op(nd.array(np.ones((3, 2), "float32")))
    assert op.cache_stats()["hits"] == 1
    op(nd.array(np.ones((1, 2), "float32")))
    assert op.cache_stats()["misses"] == 4


def test_cached_op_global_cache_stats():
    reset_cache_stats()
    assert cache_stats() == {"hits": 0, "misses": 0, "evictions": 0}
    op = CachedOp(lambda x: x + 1.0)
    op(nd.array(np.ones((2, 2), "float32")))
    op(nd.array(np.ones((2, 2), "float32")))
    st = cache_stats()
    assert st["misses"] >= 1 and st["hits"] >= 1


def test_cached_op_capacity_env_knob(monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_OP_CAPACITY", "3")
    assert CachedOp(lambda x: x)._capacity == 3
    monkeypatch.delenv("MXNET_CACHED_OP_CAPACITY")
    assert CachedOp(lambda x: x)._capacity == 64


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

def _post_json(url, payload, timeout=10):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_model_server_endpoints():
    with ModelServer(_linear, port=0, buckets=(1, 2, 4),
                     max_latency_ms=2) as srv:
        url = srv.url
        code, body = _get_json(url + "/healthz")
        assert code == 200 and body["status"] == "ok"
        x = np.random.randn(D_IN).astype("float32")
        code, body = _post_json(url + "/predict", {"data": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(body["output"], _ref(x[None])[0],
                                   rtol=TOL, atol=TOL)
        code, body = _get_json(url + "/metrics")
        assert code == 200
        assert body["requests"] >= 1 and body["ok"] >= 1
        assert body["executor_cache"]["compiles"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_json(url + "/predict", {"nope": 1})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(url + "/bogus")
        assert ei.value.code == 404


def test_model_server_reports_model_error_500():
    def boom(x):
        raise RuntimeError("exploded")

    with ModelServer(boom, port=0, jit=False, max_latency_ms=1) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_json(srv.url + "/predict", {"data": [1.0, 2.0]})
        assert ei.value.code == 500


def test_e2e_bert_concurrent_http():
    """BERT over HTTP from 4 client threads, each reply held against the
    reference's engine on the same weights and inputs."""
    V, T = 50, 16
    mx.random.seed(0)
    jnet = jbert.bert_tiny(vocab_size=V, max_length=T)
    jnet.initialize(mx.init.Xavier())
    tnet = tbert.bert_tiny(vocab_size=V, max_length=T, device="cpu")
    convert.load_mxnet_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    tnet.hybridize()
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, V, (T,)).astype("float32"),
                 np.zeros((T,), "float32")) for _ in range(8)]
    ref_eng = JaxEngine(jnet, buckets=(1, 2, 4, 8))
    refs = [ref_eng.predict(t[None], s[None]) for t, s in requests]
    eng = InferenceEngine(tnet, buckets=(1, 2, 4, 8))
    with ModelServer(eng, port=0, max_batch_size=8,
                     max_latency_ms=15) as srv:
        def client(i):
            t, s = requests[i]
            code, body = _post_json(
                srv.url + "/predict",
                {"inputs": [t.tolist(), s.tolist()]}, timeout=60)
            assert code == 200
            return body["outputs"]

        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = [pool.submit(client, i) for i in range(len(requests))]
            outs = [f.result(timeout=120) for f in futures]
        for got, ref in zip(outs, refs):
            assert len(got) == len(ref) == 4
            for g, r in zip(got, ref):
                np.testing.assert_allclose(np.asarray(g, "float32"),
                                           r.asnumpy()[0], atol=1e-5,
                                           rtol=1e-5)
        code, m = _get_json(srv.url + "/metrics")
        assert m["requests"] == 8 and m["errors"] == 0
        assert m["executor_cache"]["compiles"] <= 4
