"""The port's generation-serving slice against the JAX package.

The same small TransformerLM (units 128, 2 layers, 2 heads, vocab 64)
serves three prompts through the JAX ``DecodeEngine``/
``GenerationScheduler`` (prefix cache and chunked prefill off) and through
the port on ``device="cpu"``; the greedy streams must be token-identical.
The rest drives the port's scheduler and HTTP server on their own: the
NDJSON stream, typed errors, retirement reasons, drain, and the rule that
entry points refuse to run without CUDA unless the CPU is asked for.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.serving.generation import DecodeEngine as JaxEngine
from mxnet_tpu.serving.generation import GenerationScheduler as JaxScheduler
from mxnet_tpu_torch import context, convert
from mxnet_tpu_torch.models import TransformerLM, transformer_lm_base
from mxnet_tpu_torch.serving import (DeadlineExceeded, GenerationMetrics,
                                     ModelServer, ServerBusy, ServerClosed,
                                     ServingError)
from mxnet_tpu_torch.serving.generation import (CacheFull, DecodeEngine,
                                                GenerationScheduler,
                                                PromptTooLong, SlotKVCache)

torch.set_num_threads(1)

VOCAB = 64
PROMPTS = ([3, 14, 15, 9, 26], [5] * 12, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    jnet = JaxLM(VOCAB, units=128, num_layers=2, num_heads=2, max_len=64)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 8), "int32")))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = TransformerLM(VOCAB, units=128, num_layers=2, num_heads=2,
                         max_len=64, device="cpu")
    convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)
    tnet.eval()
    return jnet, tnet


@pytest.fixture(scope="module")
def engine(pair):
    eng = DecodeEngine(pair[1], num_slots=4, max_seq=64, ladder=(8, 16),
                       device="cpu")
    yield eng
    eng.close()


@pytest.fixture
def sched(engine):
    s = GenerationScheduler(engine)
    yield s
    s.close()
    assert engine.cache.in_use == 0      # no slot leaked


def _run_all(scheduler, prompts, n):
    reqs = [scheduler.submit(p, max_new_tokens=n) for p in prompts]
    return [r.result(timeout=120) for r in reqs]


def test_greedy_streams_match_jax(pair, engine):
    jnet, _ = pair
    jeng = JaxEngine(jnet, num_slots=4, max_seq=64, ladder=(8, 16),
                     prefix_cache=False, chunk=0)
    with JaxScheduler(jeng) as js:
        ref = _run_all(js, PROMPTS, 8)
    jeng.close()
    with GenerationScheduler(engine) as ts:
        out = _run_all(ts, PROMPTS, 8)
    assert out == ref
    assert all(len(t) == 8 for t in out)


def _post(url, payload):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=60)


def test_http_generate_stream(engine):
    sched = GenerationScheduler(engine)
    srv = ModelServer(None, port=0, generator=sched).start()
    try:
        with _post(srv.url, {"prompt": PROMPTS[0],
                             "max_new_tokens": 6}) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
        toks = [x["token"] for x in lines[:-1]]
        assert [x["index"] for x in lines[:-1]] == list(range(6))
        assert lines[-1]["done"] is True
        assert lines[-1]["reason"] == "length"
        assert lines[-1]["n_tokens"] == 6
        direct = sched.generate(PROMPTS[0], max_new_tokens=6)
        assert toks == direct
        with _post(srv.url, {"prompt": PROMPTS[1], "max_new_tokens": 3,
                             "stream": False}) as r:
            body = json.loads(r.read())
        assert len(body["tokens"]) == 3 and body["reason"] == "length"
        for bad, code in (({"prompt": []}, 400), ({"prompt": [1] * 40}, 400),
                          ({"nope": 1}, 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.url, bad)
            assert ei.value.code == code
        health = json.loads(urllib.request.urlopen(srv.url + "/healthz")
                            .read())
        assert health == {"status": "ok"}
        m = json.loads(urllib.request.urlopen(srv.url + "/metrics").read())
        gen = m["generation"]
        assert gen["prefills"] >= 2 and gen["tokens_out"] >= 7
        assert gen["ttft_ms"]["p50"] > 0
        assert m["scheduler"]["engine"]["decode_steps"] > 0
    finally:
        srv.stop()
    with pytest.raises(ServerClosed):
        sched.submit(PROMPTS[0])


def test_engine_counts_prefills_per_rung(engine):
    before = engine.stats()
    slot = engine.cache.acquire()
    try:
        engine.prefill(slot, PROMPTS[1])              # 12 tokens -> rung 16
        engine.prefill(slot, PROMPTS[0][:3])          # 3 tokens -> rung 8
        assert engine.cache.lengths[slot] == 3
        engine.decode_step(np.zeros(4, "int64"), np.zeros(4, "float32"))
    finally:
        engine.cache.release(slot)
    after = engine.stats()
    assert after["prefills"][16] == before["prefills"][16] + 1
    assert after["prefills"][8] == before["prefills"][8] + 1
    assert after["decode_steps"] == before["decode_steps"] + 1
    assert engine.rung_for(9) == 16
    with pytest.raises(PromptTooLong):
        engine.rung_for(17)
    with pytest.raises(ServingError):
        engine.validate_prompt(0)


def test_eos_and_max_seq_retirement(pair):
    _, tnet = pair
    eng = DecodeEngine(tnet, num_slots=2, max_seq=12, ladder=(8,),
                       device="cpu")
    with GenerationScheduler(eng) as s:
        free_run = s.generate(PROMPTS[0], max_new_tokens=3)
        eos = free_run[1]
        r = s.submit(PROMPTS[0], max_new_tokens=5, eos_id=eos)
        assert r.result(timeout=60) == free_run[:free_run.index(eos) + 1]
        assert r.finish_reason == "eos"
        r = s.submit([7] * 8, max_new_tokens=100)
        toks = r.result(timeout=60)
        assert r.finish_reason == "max_seq" and len(toks) == 5
    assert eng.cache.in_use == 0
    eng.close()


class _Gate:
    """Hold one engine method until ``open()``; ``entered`` is set when the
    scheduler's worker reaches it."""

    def __init__(self, engine, method):
        self.engine, self.method = engine, method
        self.entered, self._open = threading.Event(), threading.Event()
        orig = getattr(engine, method)

        def held(*a, **kw):
            self.entered.set()
            self._open.wait(30)
            return orig(*a, **kw)

        setattr(engine, method, held)

    def open(self):
        self._open.set()

    def remove(self):
        self._open.set()
        delattr(self.engine, self.method)


def test_queue_bound_deadline_and_drain(engine):
    s = GenerationScheduler(engine, max_queue_size=1)
    gate = _Gate(engine, "prefill")
    try:
        first = s.submit(PROMPTS[0], max_new_tokens=2)
        assert gate.entered.wait(30)         # worker holds `first` in prefill
        expiring = s.submit(PROMPTS[1], max_new_tokens=2, timeout_ms=1)
        with pytest.raises(ServerBusy):
            s.submit(PROMPTS[2], max_new_tokens=2)
        time.sleep(0.01)
        gate.open()
        assert len(first.result(timeout=60)) == 2
        with pytest.raises(DeadlineExceeded):
            expiring.result(timeout=60)
    finally:
        gate.remove()
        s.close()
    snap = s.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["expired"] == 1
    with pytest.raises(ServerClosed):
        s.submit(PROMPTS[0])


def test_close_without_drain_fails_work(engine):
    s = GenerationScheduler(engine)
    gate = _Gate(engine, "decode_step")
    try:
        reqs = [s.submit(p, max_new_tokens=50) for p in PROMPTS]
        assert gate.entered.wait(30)         # live sequences mid-step
        threading.Timer(0.2, gate.open).start()
        s.close(drain=False)
    finally:
        gate.remove()
    for r in reqs:
        with pytest.raises(ServerClosed):
            r.result(timeout=60)
    assert engine.cache.in_use == 0


def test_cancel_frees_the_slot(sched, engine):
    gate = _Gate(engine, "decode_step")
    try:
        r = sched.submit(PROMPTS[2], max_new_tokens=40)
        next(r.tokens(timeout=60))           # the prefill's token
        r.cancel()
        gate.open()
        with pytest.raises(ServerClosed):
            r.result(timeout=60)
        assert len(r.tokens_out) < 40
    finally:
        gate.remove()


def test_slot_cache_lifecycle():
    c = SlotKVCache(2, 1, 8, 2, 4, device="cpu")
    a, b = c.acquire(), c.acquire()
    assert (a, b) == (0, 1)
    with pytest.raises(CacheFull):
        c.acquire()
    c.set_length(a, 7)
    c.advance([a])
    with pytest.raises(ValueError):
        c.advance([a])                       # already at max_seq
    c.release(a)
    with pytest.raises(ValueError):
        c.release(a)
    st = c.stats()
    assert st["in_use"] == 1 and st["acquire_failures"] == 1
    assert st["arena_bytes"] == 2 * 2 * 8 * 2 * 4 * 4
    assert GenerationMetrics().snapshot()["ttft_ms"]["p50"] == 0.0


def test_deferred_features_raise(pair, engine):
    """The fleet routes (``/predict/<model>``, ROADMAP Queue A item 12) are
    not ported: a server over a model answers them 404; a lane policy
    outside mixed/prefill/decode is refused."""
    with context.cpu():
        srv = ModelServer(lambda x: x, port=0, jit=False).start()
    try:
        req = urllib.request.Request(
            srv.url + "/predict/lm", data=json.dumps({"data": [1.0]}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 404
    finally:
        srv.stop(timeout=10)
    with pytest.raises(ServingError, match="lane_policy"):
        GenerationScheduler(engine, lane_policy="bogus")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, pair):
    _, tnet = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        context.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer_lm_base()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tnet)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotKVCache(1, 1, 4, 1, 4)
    assert context.default_device("cpu") == torch.device("cpu")
