"""The port's generation programs through ``CachedOp``, against the JAX
package's compile counts.

- On ``transformer_lm_tiny`` (units 64, 2 layers, 4 heads, vocab 1024),
  a request warms the engine, then six staggered requests of mixed
  lengths churn through two slots: ``compile_stats()["decode"]["misses"]``
  stays 1 and the prefill misses stay within the ladder
  (``tests/test_generation.py``'s contract). ``GenerationScheduler.stats()
  ["compile"]`` and the ``generation.compile`` block of ``/metrics`` carry
  the same counts.
- The same calls through the reference's engine and the port's (prefill,
  chunked prefill, decode steps, a prefix publish and a prefix hit) give
  the same misses and hits in each of the five program families, the same
  ``program_bound()``, and the same greedy tokens (exact).
- The programs take the slot as a device tensor: one chunk program written
  on slot 0 and then called for slot 3 writes slot 3, and the tensor-index
  arena writes equal the int-index ones bitwise.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import transformer_lm_tiny as jax_tiny
from mxnet_tpu.serving.generation import DecodeEngine as JaxEngine
from mxnet_tpu.serving.generation import PrefixCache as JaxPrefix
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import transformer_lm_tiny
from mxnet_tpu_torch.ops import generation_ops as gen
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                GenerationScheduler,
                                                PrefixCache)

torch.set_num_threads(1)

FAMILIES = ("decode", "prefill", "chunk", "prefix_insert", "prefix_extract")


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


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    jnet = jax_tiny()
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 8), "int32")))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = transformer_lm_tiny(device="cpu")
    convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)
    tnet.eval()
    return jnet, tnet


def test_membership_churn_compiles_nothing(pair):
    eng = DecodeEngine(pair[1], num_slots=2, max_seq=64, ladder=(8, 16),
                       prefix_cache=False, chunk=0, device="cpu")
    sched = GenerationScheduler(eng)
    try:
        rng = np.random.default_rng(7)
        sched.submit(rng.integers(0, 1024, 5).tolist(),
                     max_new_tokens=3).result(timeout=120)
        assert eng.compile_stats()["decode"]["misses"] == 1
        # six requests at once through two slots: each finish frees a slot
        # that a queued request joins while the other keeps decoding
        reqs = [sched.submit(rng.integers(0, 1024, int(n)).tolist(),
                             max_new_tokens=int(m))
                for n, m in zip(rng.integers(2, 15, 6),
                                rng.integers(2, 7, 6))]
        for r in reqs:
            r.result(timeout=120)
        st = eng.compile_stats()
        assert st["decode"]["misses"] == 1, st
        assert st["decode"]["hits"] >= 6, st
        assert st["prefill"]["misses"] <= len(eng.ladder), st
        assert eng.cache.in_use == 0
        assert eng.cache.stats()["peak_in_use"] == 2
        assert sched.stats()["compile"] == eng.compile_stats()
        assert sched.program_bound() == eng.program_bound()
    finally:
        sched.close()
        eng.close()


def _drive(eng, prompt_a, prompt_b):
    """The same host calls on either package's engine; returns tokens."""
    assert (eng.cache.acquire(), eng.cache.acquire()) == (0, 1)
    toks = [eng.prefill(0, prompt_a)]
    pos, tok = eng.prefill_chunks(1, prompt_b, 0)
    toks.append(tok)
    cur = np.array(toks)
    for _ in range(3):
        cur = eng.decode_step(cur, np.zeros(2, "float32"))
        eng.cache.advance([0, 1])
        toks += [int(t) for t in cur]
    eng.prefix_store(1, prompt_b)
    toks.append(eng.prefix_admit(0, prompt_b))
    eng.cache.release(0), eng.cache.release(1)
    return toks


def test_compile_counts_and_tokens_follow_reference(pair):
    jnet, tnet = pair
    prompt_a = [3, 14, 15, 9, 26]
    prompt_b = list(range(40, 60))
    kw = dict(num_slots=2, max_seq=64, ladder=(8, 16, 32), chunk=8)
    jeng = JaxEngine(jnet, prefix_cache=JaxPrefix(block=8), **kw)
    teng = DecodeEngine(tnet, prefix_cache=PrefixCache(block=8),
                        device="cpu", **kw)
    try:
        ref = _drive(jeng, prompt_a, prompt_b)
        out = _drive(teng, prompt_a, prompt_b)
        assert [int(t) for t in out] == [int(t) for t in ref]
        js, ts = jeng.compile_stats(), teng.compile_stats()
        for fam in FAMILIES:
            for key in ("hits", "misses", "size"):
                assert ts[fam][key] == js[fam][key], (fam, key, ts, js)
        assert teng.program_bound() == jeng.program_bound()
    finally:
        jeng.close()
        teng.close()
    for prefix in (None, False):
        jeng = JaxEngine(jnet, prefix_cache=prefix, **kw)
        teng = DecodeEngine(tnet, prefix_cache=prefix, device="cpu", **kw)
        assert teng.program_bound() == jeng.program_bound()
        jeng.close()
        teng.close()


def test_metrics_carry_compile_block(pair):
    eng = DecodeEngine(pair[1], num_slots=2, max_seq=64, ladder=(8, 16),
                       prefix_cache=False, chunk=0, device="cpu")
    sched = GenerationScheduler(eng)
    srv = ModelServer(None, port=0, generator=sched).start()
    try:
        sched.generate([1, 2, 3, 4, 5], max_new_tokens=4)
        m = json.loads(urllib.request.urlopen(srv.url + "/metrics").read())
        g = m["generation"]["compile"]
        assert g["decode"]["misses"] == 1 and g["decode"]["hits"] >= 2
        assert g["prefill"]["misses"] == 1
        assert set(g) == set(FAMILIES)
        assert m["scheduler"]["compile"]["decode"]["misses"] == 1
    finally:
        srv.stop()
        sched.close()
        eng.close()


def test_slot_is_a_tensor_argument(pair):
    """One chunk program serves every slot: the slot index is data."""
    tnet = pair[1]
    eng = DecodeEngine(tnet, num_slots=4, max_seq=64, ladder=(8,),
                       prefix_cache=False, chunk=8, device="cpu")
    ref = DecodeEngine(tnet, num_slots=4, max_seq=64, ladder=(8,),
                       prefix_cache=False, chunk=8, device="cpu")
    try:
        prompt = list(range(7, 23))
        for _ in range(4):
            eng.cache.acquire()
        for slot in (0, 3):
            eng.prefill_chunks(slot, prompt, 0)
        assert eng.compile_stats()["chunk"]["misses"] == 1
        assert eng.compile_stats()["chunk"]["hits"] == 3
        # the eager reference: the model's chunk path over the slot's view
        for slot in (0, 3):
            rows = [(ref.cache.k_arena[i].narrow(0, slot, 1),
                     ref.cache.v_arena[i].narrow(0, slot, 1))
                    for i in range(ref.cache.num_layers)]
            for start in (0, 8):
                with torch.no_grad():
                    tnet.prefill_chunk(
                        torch.tensor([prompt[start:start + 8]]), rows,
                        torch.tensor([start]))
        assert torch.equal(eng.cache.k_arena, ref.cache.k_arena)
        assert torch.equal(eng.cache.v_arena, ref.cache.v_arena)
        assert not eng.cache.k_arena[:, 1:3].any()
    finally:
        eng.close()
        ref.close()


def test_tensor_index_arena_ops_match_int_index():
    rng = np.random.default_rng(3)
    arena = torch.from_numpy(rng.standard_normal((2, 4, 10, 2, 4)).astype(
        "float32"))
    blk = torch.from_numpy(rng.standard_normal((2, 1, 6, 2, 4)).astype(
        "float32"))
    for idx in (0, 2, 3, 9):
        a = gen.arena_update(arena.clone(), blk, idx, axis=1)
        b = gen.arena_update(arena.clone(), blk, torch.tensor([idx]), axis=1)
        assert torch.equal(a, b)
        assert torch.equal(gen.arena_slice(arena, idx, axis=1),
                           gen.arena_slice(arena, torch.tensor(idx), axis=1))


def test_sampler_draws_the_same_amount_for_any_temperatures():
    logits = torch.randn(3, 20, generator=torch.Generator().manual_seed(1))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    greedy = gen.generation_sample(logits, g1, torch.zeros(3))
    assert torch.equal(greedy, logits.argmax(-1))
    gen.generation_sample(logits, g2, torch.ones(3))
    assert torch.equal(g1.get_state(), g2.get_state())


def test_eager_programs_give_the_same_streams_and_count_nothing(pair):
    """``cached=False`` (the replay's baseline on the card) runs the same
    programs: the same greedy streams, no counts."""
    prompts = ([3, 14, 15, 9, 26], list(range(30, 52)), [7] * 9)
    out = []
    for cached in (True, False):
        eng = DecodeEngine(pair[1], num_slots=2, max_seq=64, ladder=(8, 32),
                           prefix_cache=False, chunk=16, cached=cached,
                           device="cpu")
        with GenerationScheduler(eng) as sched:
            out.append([sched.generate(p, max_new_tokens=5)
                        for p in prompts])
        st = eng.compile_stats()
        eng.close()
        assert (st["decode"]["misses"] == 1) == cached
    assert out[0] == out[1]
