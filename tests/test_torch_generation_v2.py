"""The port's generation serving v2 against the JAX package.

Mirrors ``tests/test_generation_v2.py`` at its size (vocab 64,
``transformer_lm_tiny``): the reference's weights are carried into the
port through ``convert``, and the port runs on ``device="cpu"``.

- ``step_chunk``/``prefill_chunk`` agree with the JAX package (logits and
  caches, fp32, within 1e-5) for chunks of 1, 5 and 8 at mixed starts.
- Greedy streams through chunked prefill, prefix-cache hits, speculative
  decoding and the lanes are token-equal to the JAX package's plain
  scheduler (prefix cache and chunking off, a ladder that fits every
  prompt).
- A prefix-cache hit equals a cold chunked prefill bit for bit; an async
  publish stores the rows as they were when it was queued, though the slot
  is reused before the publisher runs.
- The prefix cache's host logic runs the same scenarios against both
  packages' modules.
- Chaos on ``generation.step``: retry absorbs a transient fault, a fatal
  one fails the live requests while the scheduler survives, and the
  breaker trips and degrades ``/healthz``.
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
from mxnet_tpu.models import transformer_lm_tiny as jax_lm_tiny
from mxnet_tpu.serving.generation import DecodeEngine as JaxEngine
from mxnet_tpu.serving.generation import GenerationScheduler as JaxScheduler
from mxnet_tpu.serving.generation import prefix_cache as jax_pc_mod
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import TransformerLM, transformer_lm_tiny
from mxnet_tpu_torch.resilience import (CircuitBreaker, FatalFault,
                                        RetryPolicy, aggregate_rows, chaos)
from mxnet_tpu_torch.serving import ModelServer, ServingError
from mxnet_tpu_torch.serving import generation as gen
from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                GenerationScheduler,
                                                PrefixCache, SlotKVCache,
                                                SpeculativeDecoder)
from mxnet_tpu_torch.serving.generation import prefix_cache as pc_mod

torch.set_num_threads(1)

VOCAB = 64
_RNG = np.random.default_rng(6)
# every prompt whose greedy stream a test holds against the reference
PROMPTS = {
    "chunked": [_RNG.integers(1, VOCAB, size=n).tolist()
                for n in (5, 11, 19, 30)],
    "long": _RNG.integers(1, VOCAB, size=40).tolist(),
    "hit": _RNG.integers(1, VOCAB, size=21).tolist(),
    "spec": [_RNG.integers(1, VOCAB, size=n).tolist()
             for n in (4, 7, 12, 15)],
    "seq": list(range(1, 9)),
    "lane": list(range(1, 14)),
    "short": [1, 2, 3],
}
REF_TOKENS = 12


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port(jnet, **kw):
    tnet = TransformerLM(VOCAB, device="cpu", **kw)
    convert.load_mxnet_params(tnet, _params(jnet), prefix=jnet.prefix)
    return tnet.eval()


@pytest.fixture(scope="module")
def nets():
    """The reference's ``tiny_lm`` and its port."""
    np.random.seed(0)
    jnet = jax_lm_tiny(vocab_size=VOCAB)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 8), "int32")))
    tnet = transformer_lm_tiny(vocab_size=VOCAB, device="cpu")
    convert.load_mxnet_params(tnet, _params(jnet), prefix=jnet.prefix)
    return jnet, tnet.eval()


@pytest.fixture(scope="module")
def draft_lm():
    """The reference's adversarial draft (another shape, other weights),
    ported."""
    np.random.seed(123)
    jd = JaxLM(VOCAB, units=32, num_layers=1, num_heads=2, max_len=256)
    jd.initialize(mx.init.Xavier())
    jd(nd.array(np.zeros((1, 8), "int32")))
    return _port(jd, units=32, num_layers=1, num_heads=2, max_len=256)


@pytest.fixture(scope="module")
def ref(nets):
    """``ref(prompt, n)``: the JAX package's greedy stream, from its plain
    scheduler (prefix cache and chunking off), all prompts in one burst."""
    jeng = JaxEngine(nets[0], num_slots=4, max_seq=128,
                     ladder=(8, 16, 32, 64), prefix_cache=False, chunk=0,
                     name="ref.v2")
    flat = []
    for v in PROMPTS.values():
        flat.extend(v if isinstance(v[0], list) else [v])
    with JaxScheduler(jeng, retry_policy=False) as js:
        reqs = [js.submit(p, max_new_tokens=REF_TOKENS) for p in flat]
        streams = {tuple(p): r.result(timeout=300)
                   for p, r in zip(flat, reqs)}
    jeng.close()

    def lookup(prompt, n):
        assert n <= REF_TOKENS
        return streams[tuple(int(t) for t in prompt)][:n]
    return lookup


@pytest.fixture(autouse=True)
def _disarm_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _engine(net, slots=4, max_seq=64, ladder=(8, 16, 32), **kw):
    return DecodeEngine(net, num_slots=slots, max_seq=max_seq,
                        ladder=ladder, device="cpu", **kw)


def _sched(eng, **kw):
    kw.setdefault("retry_policy", False)
    return GenerationScheduler(eng, **kw)


# ---------------------------------------------------------------------------
# the chunk program against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,start", [(1, (0, 13)), (5, (3, 20)),
                                     (8, (0, 17))])
def test_prefill_chunk_matches_jax(nets, C, start):
    jnet, tnet = nets
    rng = np.random.default_rng(C)
    B, S = 2, 32
    shape = (B, S, tnet.num_heads, tnet.head_dim)
    init = [(rng.standard_normal(shape, dtype=np.float32),
             rng.standard_normal(shape, dtype=np.float32))
            for _ in range(tnet.num_layers)]
    tokens = rng.integers(0, VOCAB, (B, C))
    start = np.asarray(start, np.int32)
    jl, jc = jnet.prefill_chunk(
        nd.array(tokens.astype("int32")),
        [(nd.array(k), nd.array(v)) for k, v in init], nd.array(start))
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in init]
    with torch.no_grad():
        tl, tc = tnet.prefill_chunk(torch.from_numpy(tokens), tc,
                                    torch.from_numpy(start))
    np.testing.assert_allclose(tl.numpy(), jl.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), jk.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), jv.asnumpy(), rtol=1e-5,
                                   atol=1e-5)


def test_attention_step_chunk_matches_jax(nets):
    jnet, tnet = nets
    rng = np.random.default_rng(11)
    B, C, S, units = 2, 4, 16, 64
    x = rng.standard_normal((B, C, units), dtype=np.float32)
    k = rng.standard_normal((B, S, 4, 16), dtype=np.float32)
    v = rng.standard_normal((B, S, 4, 16), dtype=np.float32)
    start = np.array([2, 9], np.int32)
    jattn = next(iter(jnet.blocks)).attn
    jo, jk, jv = jattn.step_chunk(nd.array(x), nd.array(k), nd.array(v),
                                  nd.array(start))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.no_grad():
        to, tk, tv = tnet.blocks[0].attn.step_chunk(
            torch.from_numpy(x), tk, tv, torch.from_numpy(start))
    for t, j in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def test_prefix_hit_bitwise_equals_cold(nets, ref):
    tnet = nets[1]
    pc = PrefixCache(block=8, name="px.bw")
    eng = _engine(tnet, chunk=8, prefix_cache=pc, name="px.bw")
    try:
        prompt = PROMPTS["hit"]
        s_cold = eng.cache.acquire()
        _, tok_cold = eng.prefill_chunks(s_cold, prompt, 0)
        eng.prefix_store(s_cold, prompt)
        s_hit = eng.cache.acquire()
        skipped = eng.prefix_admit(s_hit, prompt)
        assert skipped == 16        # the largest block multiple <= n - 1
        _, tok_hit = eng.prefill_chunks(s_hit, prompt, skipped)
        assert tok_hit == tok_cold
        n = len(prompt)
        for arena in (eng.cache.k_arena, eng.cache.v_arena):
            assert torch.equal(arena[:, s_cold, :n], arena[:, s_hit, :n])
        toks = np.zeros(eng.num_slots, np.int64)
        temps = np.zeros(eng.num_slots, np.float32)
        toks[s_cold], toks[s_hit] = tok_cold, tok_hit
        a, b = [tok_cold], [tok_hit]
        for _ in range(6):
            out = eng.decode_step(toks, temps)
            eng.cache.advance([s_cold, s_hit])
            toks[s_cold], toks[s_hit] = out[s_cold], out[s_hit]
            a.append(int(out[s_cold]))
            b.append(int(out[s_hit]))
        assert a == b == ref(prompt, 7)
    finally:
        eng.close()


def test_async_publish_snapshots_before_slot_reuse(nets):
    """The publisher runs after the slot was given to another prompt; the
    stored slab is still the first prompt's K/V."""
    tnet = nets[1]
    pc = PrefixCache(block=8, name="px.async")
    eng = _engine(tnet, slots=1, chunk=8, prefix_cache=pc, name="px.async")
    held = threading.Event()
    store = eng._store

    def gated(snap):
        held.wait(30)
        return store(snap)

    eng._store = gated
    try:
        first = PROMPTS["hit"]
        slot = eng.cache.acquire()
        eng.prefill_chunks(slot, first, 0)
        want_k = eng.cache.k_arena[:, slot, :16].clone()
        want_v = eng.cache.v_arena[:, slot, :16].clone()
        eng.prefix_store_async(slot, first)
        eng.cache.release(slot)
        assert eng.cache.acquire() == slot     # reused at once
        eng.prefill_chunks(slot, PROMPTS["long"][:24], 0)
        assert not torch.equal(eng.cache.k_arena[:, slot, :16], want_k)
        held.set()
        eng.prefix_flush()
        hit = pc.lookup(first)
        assert hit is not None and hit[1] == 16
        entry = hit[0]
        assert np.array_equal(entry.k_slab[:, 0], want_k.numpy())
        assert np.array_equal(entry.v_slab[:, 0], want_v.numpy())
        pc.release(entry)
        assert eng.stats()["publish_errors"] == 0
    finally:
        held.set()
        eng.close()
    assert eng._publisher is None


def test_unclosed_engine_is_released(nets, monkeypatch):
    """An engine its caller drops without ``close()`` (after closing its
    scheduler, as code written before the prefix cache does) frees its
    arena and prefix cache, and its publisher thread stops."""
    import gc
    import weakref
    monkeypatch.setenv("MXNET_GEN_PREFIX_BLOCK", "8")
    eng = _engine(nets[1], slots=2, chunk=8, name="px.dropped")
    sched = _sched(eng, name="px.dropped")
    sched.generate(PROMPTS["hit"], max_new_tokens=2)
    sched.close()
    eng.prefix_flush()
    assert eng.prefix is not None and eng.prefix.stats()["entries"] == 2
    publisher = eng._publisher
    refs = [weakref.ref(o) for o in (eng, eng.cache, eng.prefix)]
    del eng, sched
    gc.collect()
    assert [r() for r in refs] == [None, None, None]
    publisher.join(10)
    assert not publisher.is_alive()
    assert "px.dropped" not in gen.cache_stats()
    assert "px.dropped" not in gen.prefix_stats()


def test_prefix_hits_through_the_scheduler(nets, ref):
    tnet = nets[1]
    pc = PrefixCache(block=4, name="px.rows")
    eng = _engine(tnet, chunk=4, prefix_cache=pc, name="px.rows")
    sched = _sched(eng, name="px.rows")
    try:
        prompt = PROMPTS["lane"]
        assert sched.generate(prompt, max_new_tokens=3) == ref(prompt, 3)
        eng.prefix_flush()
        req = sched.submit(prompt, max_new_tokens=3)
        assert req.result(timeout=120) == ref(prompt, 3)
        assert req.prefix_skipped == 12
        st = pc.stats()
        assert st["hits"] == 1 and st["insertions"] >= 3
        assert st["tokens_saved"] == 12 and st["hit_rate"] == 0.5
        rows = aggregate_rows()
        for key in ("hits", "misses", "tokens_saved", "evictions"):
            assert "generation.prefix.px.rows.%s" % key in rows
        sst = sched.stats()
        assert sst["prefix_hits"] == 1 and sst["prefix_tokens_saved"] == 12
        assert sched.metrics.snapshot()["prefix"]["hits"] == 1
        g = gen.gauge()
        assert g["prefix"]["px.rows"]["insertions"] >= 1
        assert "px.rows" in g["schedulers"]
    finally:
        sched.close()
        eng.close()


def test_short_prompts_never_touch_the_prefix_cache(nets):
    pc = PrefixCache(block=32, name="px.short")
    eng = _engine(nets[1], prefix_cache=pc, name="px.short")
    sched = _sched(eng)
    try:
        for _ in range(2):
            sched.generate(PROMPTS["short"], max_new_tokens=2)
        st = pc.stats()
        assert st["hits"] == 0 and st["entries"] == 0
        assert eng._publisher is None      # nothing was ever queued
    finally:
        sched.close()
        eng.close()


@pytest.fixture(params=["jax", "torch"])
def pcm(request):
    """The prefix-cache module of either package."""
    return jax_pc_mod if request.param == "jax" else pc_mod


def test_prefix_refcount_blocks_eviction(pcm):
    pc = pcm.PrefixCache(block=2, capacity_mb=1, name="px.ref")
    slab = np.zeros((2, 1, 2, 2, 64), "float32")
    pc.insert([1, 2], slab, slab)
    entry, plen = pc.lookup([1, 2, 3])
    assert plen == 2 and entry.refs == 1
    big = np.zeros((2, 1, 2, 64, 512), "float32")   # 512 KiB per pair
    for i in range(6):
        pc.insert([10 + i, 20 + i], big, big)
    assert pc.stats()["evictions"] > 0
    hit2 = pc.lookup([1, 2, 99])
    assert hit2 is not None                          # still resident
    pc.release(hit2[0])
    pc.release(entry)
    for i in range(6):
        pc.insert([50 + i, 60 + i], big, big)
    assert pc.lookup([1, 2, 3]) is None
    assert pc.stats()["bytes"] <= pc.capacity_bytes
    pc.close()


def test_prefix_lru_eviction_under_pressure(pcm):
    pc = pcm.PrefixCache(block=2, capacity_mb=1, name="px.lru")
    big = np.zeros((2, 1, 2, 64, 256), "float32")   # 256 KiB per pair
    for i in range(8):
        pc.insert([i, i + 100], big, big)
    st = pc.stats()
    assert st["evictions"] >= 4 and st["bytes"] <= pc.capacity_bytes
    assert pc.lookup([0, 100, 1]) is None
    assert pc.lookup([7, 107, 1]) is not None
    pc.close()


def test_prefix_hash_chain_collision_safety(pcm, monkeypatch):
    monkeypatch.setattr(pcm, "_hash_chain", lambda tokens: [7] * len(tokens))
    pc = pcm.PrefixCache(block=2, name="px.col")
    slab = np.ones((1, 1, 2, 1, 4), "float32")
    pc.insert([1, 2], slab, slab)
    assert pc.lookup([3, 4, 5]) is None          # same key, other tokens
    assert pc.stats()["collisions"] == 1
    hit = pc.lookup([1, 2, 9])                   # the real owner still hits
    assert hit is not None and hit[1] == 2
    pc.release(hit[0])
    pc.close()


def test_prefix_short_prompts_and_store_points(pcm):
    pc = pcm.PrefixCache(block=4, name="px.pts")
    assert pc.store_lengths(3) == [] and pc.lookup([1, 2, 3]) is None
    assert pc.missing_store_points([1, 2, 3])[0] == []
    assert pc.store_lengths(12) == [4, 8, 12]
    thinned = pc.store_lengths(4 * 40)
    assert len(thinned) <= 16 and thinned[-1] == 160
    slab = np.zeros((1, 1, 8, 1, 2), "float32")
    toks = list(range(1, 13))
    pts, chain = pc.missing_store_points(toks)
    assert pts == [4, 8, 12]
    pc.insert(toks[:8], slab, slab, chain=chain)
    assert pc.missing_store_points(toks)[0] == [4, 12]
    assert pc.stats()["misses"] == 1
    pc.close()


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def test_chunked_prefill_token_exact(nets, ref):
    eng = _engine(nets[1], chunk=4, prefix_cache=False, name="ck.exact")
    sched = _sched(eng)
    try:
        for prompt in PROMPTS["chunked"]:
            got = sched.generate(prompt, max_new_tokens=6)
            assert got == ref(prompt, 6)
        assert sched.metrics.snapshot()["prefill_chunks"] > 0
        assert eng.stats()["chunks"][4] > 0
    finally:
        sched.close()
        eng.close()


def test_chunked_prefill_interleaves_with_decode(nets, ref):
    eng = _engine(nets[1], slots=2, chunk=4, prefix_cache=False,
                  name="ck.live")
    sched = _sched(eng)
    gate = threading.Event()
    decode = eng.decode_step
    steps = []

    def slow_step(*a):
        steps.append(time.monotonic())
        if len(steps) == 3:
            gate.set()
        return decode(*a)

    eng.decode_step = slow_step
    try:
        arrivals = []
        live = sched.submit(PROMPTS["seq"], max_new_tokens=40)
        t = threading.Thread(target=lambda: arrivals.extend(
            time.monotonic() for _ in live.tokens(timeout=120)))
        t.start()
        assert gate.wait(60)              # the stream is decoding
        long_req = sched.submit(PROMPTS["long"], max_new_tokens=2)
        assert long_req.result(timeout=120) == ref(PROMPTS["long"], 2)
        t.join(timeout=120)
        assert not t.is_alive()
        during = [a for a in arrivals
                  if long_req.admitted_t < a < long_req.first_token_t]
        assert len(during) >= 3, (len(during), len(arrivals))
        assert sched.metrics.snapshot()["prefill_chunks"] >= 9
    finally:
        sched.close()
        eng.close()


def test_chunked_admits_prompts_beyond_ladder(nets, ref):
    eng = _engine(nets[1], chunk=8, ladder=(8, 16), prefix_cache=False,
                  name="ck.long")
    sched = _sched(eng)
    try:
        prompt = PROMPTS["long"]          # > the ladder's 16
        assert sched.generate(prompt, max_new_tokens=4) == ref(prompt, 4)
        with pytest.raises(ServingError):
            sched.submit([1] * 64, max_new_tokens=2)   # >= max_seq
    finally:
        sched.close()
        eng.close()
    with pytest.raises(ValueError):
        _engine(nets[1], chunk=-1, prefix_cache=False)


def test_chunk_rung_stays_inside_the_arena(nets):
    eng = _engine(nets[1], max_seq=64, ladder=(8, 16, 32), chunk=16,
                  prefix_cache=False)
    try:
        assert eng._chunk_rung(5, 0) == 8
        assert eng._chunk_rung(16, 32) == 16
        assert eng._chunk_rung(3, 58) == 4          # power-of-two tail
        assert eng._chunk_rung(3, 61) == 3          # exact width
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

def test_speculative_token_exact_adversarial_draft(nets, draft_lm, ref):
    eng = _engine(nets[1], prefix_cache=False, name="sp.adv")
    sched = _sched(eng, draft_model=draft_lm)
    try:
        reqs = [sched.submit(p, max_new_tokens=8) for p in PROMPTS["spec"]]
        for p, r in zip(PROMPTS["spec"], reqs):
            assert r.result(timeout=120) == ref(p, 8)
        st = sched.stats()["speculative"]
        assert st["rounds"] > 0 and st["verifies"] == st["rounds"]
        assert st["acceptance_rate"] < 0.5       # genuinely adversarial
    finally:
        sched.close()
        eng.close()


def test_speculative_self_draft_accepts_everything(nets, ref):
    jnet, tnet = nets
    clone = _port(jnet, units=64, num_layers=2, num_heads=4, max_len=256)
    eng = _engine(tnet, prefix_cache=False, name="sp.self")
    spec = SpeculativeDecoder(eng, clone, k=3)
    sched = _sched(eng, speculative=spec)
    try:
        prompt = PROMPTS["seq"]
        assert sched.generate(prompt, max_new_tokens=9) == ref(prompt, 9)
        st = spec.stats()
        assert st["acceptance_rate"] == 1.0
        # 1 prefill token + 8 decode tokens at k=3 (4 a round): 2 rounds
        assert st["rounds"] == 2
        snap = sched.metrics.snapshot()
        assert snap["spec_acceptance_rate"] == 1.0
        assert snap["tokens_out"] == 8
    finally:
        sched.close()
        spec.close()
        eng.close()


def test_speculative_mixed_temperature_falls_back(nets, draft_lm):
    eng = _engine(nets[1], prefix_cache=False, name="sp.mix")
    sched = _sched(eng, draft_model=draft_lm)
    try:
        sampled = sched.submit([1, 2, 3, 4], max_new_tokens=12,
                               temperature=0.9)
        greedy = sched.submit([9, 8, 7], max_new_tokens=12)
        assert len(sampled.result(timeout=120)) == 12
        assert greedy.result(timeout=120)
        assert sched.stats()["completed"] == 2
    finally:
        sched.close()
        eng.close()


def test_speculative_eos_and_budget_trim(nets, ref):
    jnet, tnet = nets
    clone = _port(jnet, units=64, num_layers=2, num_heads=4, max_len=256)
    prompt = PROMPTS["seq"]
    want = ref(prompt, 12)
    eng = _engine(tnet, prefix_cache=False, name="sp.eos")
    sched = _sched(eng, draft_model=clone)
    try:
        assert sched.generate(prompt, max_new_tokens=6) == want[:6]
        got = sched.generate(prompt, max_new_tokens=12, eos_id=want[3])
        assert got == want[:want.index(want[3]) + 1]
    finally:
        sched.close()
        eng.close()


def test_draft_engine_spans_apart_from_the_target(nets, draft_lm):
    """The draft engine's decode steps are traced under their own span
    name, so ``generation.step`` counts only the target's steps."""
    from mxnet_tpu_torch.observability import tracer
    eng = _engine(nets[1], prefix_cache=False, name="sp.spans")
    spec = SpeculativeDecoder(eng, draft_lm, k=3)
    sched = _sched(eng, speculative=spec)
    was = tracer.enabled()
    tracer.enable()
    tracer.reset_phase_stats()
    try:
        sched.generate(PROMPTS["spec"][1], max_new_tokens=9)
        st = tracer.phase_stats()
        sst = spec.stats()
    finally:
        if not was:
            tracer.disable()
        sched.close()
        spec.close()
        eng.close()
    assert sst["rounds"] > 0
    assert st["generation.draft.step"]["count"] == \
        sst["draft"]["decode_steps"] == 4 * sst["rounds"]
    assert st["generation.spec_verify"]["count"] == sst["verifies"]
    assert st.get("generation.step", {"count": 0})["count"] == \
        eng.stats()["decode_steps"]
    assert st["generation.prefill"]["count"] == 1


def test_speculative_rejects_short_draft(nets):
    short = TransformerLM(VOCAB, units=32, num_layers=1, num_heads=2,
                          max_len=32, device="cpu")
    eng = _engine(nets[1], max_seq=64, prefix_cache=False, name="sp.short")
    try:
        with pytest.raises(ValueError, match="max_len"):
            SpeculativeDecoder(eng, short, k=2)
    finally:
        eng.close()


def test_speculative_churn(nets, draft_lm, ref):
    """More requests than slots join and leave across speculative rounds;
    every stream stays the reference's."""
    eng = _engine(nets[1], slots=3, prefix_cache=False, name="sp.churn")
    spec = SpeculativeDecoder(eng, draft_lm, k=2)
    sched = _sched(eng, speculative=spec)
    try:
        prompts = PROMPTS["chunked"] + PROMPTS["spec"]
        budgets = [3, 8, 5, 4, 7, 6, 3, 8]
        reqs = [sched.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        for p, n, r in zip(prompts, budgets, reqs):
            assert r.result(timeout=120) == ref(p, n)
        assert spec.stats()["rounds"] > 0
        assert eng.cache.in_use == 0
    finally:
        sched.close()
        spec.close()
        eng.close()


# ---------------------------------------------------------------------------
# lanes, kvcache stats
# ---------------------------------------------------------------------------

def test_lane_handoff_prefill_to_decode(nets, ref):
    pc = PrefixCache(block=4, name="lane.px")
    pre_eng = _engine(nets[1], chunk=4, prefix_cache=pc, name="lane.pre")
    dec_eng = _engine(nets[1], chunk=4, prefix_cache=pc, name="lane.dec")
    pre = _sched(pre_eng, lane_policy="prefill", name="lane.pre")
    dec = _sched(dec_eng, lane_policy="decode", name="lane.dec")
    try:
        prompt = PROMPTS["lane"]
        req = pre.submit(prompt, max_new_tokens=16)
        toks = req.result(timeout=120)
        assert req.finish_reason == "prefill" and len(toks) == 1
        assert pre_eng.cache.in_use == 0
        pre_eng.prefix_flush()
        assert pc.stats()["insertions"] >= 1
        assert pre.metrics.snapshot()["retired_prefill"] == 1
        got = dec.generate(prompt, max_new_tokens=4)
        assert got == ref(prompt, 4) and toks[0] == got[0]
        assert dec.stats()["prefix_hits"] == 1
        assert dec.stats()["decode_lane_misses"] == 0
    finally:
        pre.close()
        dec.close()
        pre_eng.close()
        dec_eng.close()
        pc.close()


def test_scheduler_lane_validation(nets, monkeypatch):
    eng = _engine(nets[1], prefix_cache=False, name="lane.bad")
    try:
        with pytest.raises(ServingError):
            _sched(eng, lane_policy="bogus")
        s = _sched(eng)
        assert s.lane_policy == "mixed"
        assert s.set_lane_policy("Decode") is s
        assert s.stats()["lane"] == "decode"
        with pytest.raises(ServingError):
            s.set_lane_policy("both")
        s.close()
        monkeypatch.setenv("MXNET_GEN_LANE", "prefill")
        s = _sched(eng)
        assert s.lane_policy == "prefill"
        s.close()
    finally:
        eng.close()


def test_kvcache_hwm_fragmentation_and_rows():
    c = SlotKVCache(num_slots=4, num_layers=1, max_seq=32, num_heads=2,
                    head_dim=4, device="cpu", name="hwmcache")
    try:
        a, b = c.acquire(), c.acquire()
        c.set_length(a, 10)
        c.set_length(b, 6)
        st = c.stats()
        assert st["hwm"] == 16 and st["slots_peak"] == 2
        assert st["fragmentation"] == pytest.approx(1 - 16 / 64.0)
        c.release(a)
        st = c.stats()
        assert st["hwm"] == 16 and st["tokens_cached"] == 6
        rows = aggregate_rows()
        assert "generation.kvcache.hwmcache.hwm" in rows
        assert "hwmcache" in gen.cache_stats()
        c.reset()
        assert c.free_slots == 4 and c.stats()["resets"] == 1
    finally:
        c.close()
    assert "hwmcache" not in gen.cache_stats()


# ---------------------------------------------------------------------------
# chaos -> retry / breaker / healthz
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_chaos_transient_step_fault_absorbed_by_retry(nets, ref):
    eng = _engine(nets[1], prefix_cache=False, name="chaos.retry")
    pol = RetryPolicy(max_attempts=3, base_delay_ms=0.5, jitter=0.0,
                      name="retry.gen_test", register=False)
    sched = GenerationScheduler(eng, retry_policy=pol)
    try:
        chaos.arm("generation.step", "transient", first=2)
        got = sched.generate(PROMPTS["seq"], max_new_tokens=4)
        assert got == ref(PROMPTS["seq"], 4)
        assert pol.stats()["retries"] == 2
    finally:
        sched.close()
        eng.close()


@pytest.mark.chaos
def test_chaos_fatal_step_fails_live_requests_but_scheduler_survives(
        nets, ref):
    eng = _engine(nets[1], prefix_cache=False, name="chaos.fatal")
    sched = _sched(eng)
    try:
        chaos.arm("generation.step", "fatal", first=1)
        with pytest.raises(FatalFault):
            sched.submit(PROMPTS["seq"], max_new_tokens=4).result(
                timeout=120)
        assert eng.cache.in_use == 0
        got = sched.generate(PROMPTS["seq"], max_new_tokens=4)
        assert got == ref(PROMPTS["seq"], 4)
        assert sched.stats()["failed"] == 1
    finally:
        sched.close()
        eng.close()


@pytest.mark.chaos
def test_step_fault_trips_breaker_and_degrades_healthz(nets):
    eng = _engine(nets[1], prefix_cache=False, name="chaos.breaker")
    sched = _sched(eng)
    breaker = CircuitBreaker(failure_threshold=1, recovery_ms=60000,
                             name="gen_test_breaker")
    srv = ModelServer(None, port=0, generator=sched, breaker=breaker).start()
    try:
        health = json.loads(urllib.request.urlopen(
            srv.url + "/healthz").read())
        assert health == {"status": "ok"}
        chaos.arm("generation.step", "fatal", first=1)
        body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 3,
                           "stream": False}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/generate", data=body))
        assert ei.value.code == 500
        health = json.loads(urllib.request.urlopen(
            srv.url + "/healthz").read())
        assert health["status"] == "degraded"
        assert health["breaker"]["state"] == "open"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/generate", data=body))
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        m = json.loads(urllib.request.urlopen(srv.url + "/metrics").read())
        assert m["breaker"]["state"] == "open"
        assert m["breaker"]["fast_fails"] == 1
        assert isinstance(m["retry"], dict)
    finally:
        srv.stop()
        eng.close()
