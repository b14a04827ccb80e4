"""The port's TransformerLM, layers and weight conversion against the JAX
package.

A small TransformerLM (units 128, 2 layers, 2 heads, vocab 64) is built in
the JAX package; its parameters are carried across with
``mxnet_tpu_torch.convert``. ``forward``, ``prefill`` (logits, and the
cache at valid positions: the padded tail is garbage by contract) and
``step`` logits must agree at atol 1e-4 (fp32, summation order only).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.nn import Dense, Embedding, LayerNorm
from mxnet_tpu_torch.models import TransformerLM, transformer_lm_tiny
from mxnet_tpu_torch.ops import generation_ops as gen
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

VOCAB, UNITS, LAYERS, HEADS, MAX_LEN = 64, 128, 2, 2, 64
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax net, port net, reference params) with the same weights."""
    mx.random.seed(0)
    jnet = JaxLM(VOCAB, units=UNITS, num_layers=LAYERS, num_heads=HEADS,
                 max_len=MAX_LEN)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 8), "int32")))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAX_LEN, device="cpu")
    convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)
    tnet.eval()
    return jnet, tnet, params


PRE_TOKS = np.random.default_rng(1).integers(0, VOCAB, (3, 16)).astype(
    "int32")
PRE_LENS = np.array([16, 9, 1], "int32")


@pytest.fixture(scope="module")
def jax_prefill(pair):
    """The reference's prefill of ``PRE_TOKS``, shared by the prefill and
    step tests (each JAX eager run costs seconds on the CPU)."""
    logits, cache = pair[0].prefill(nd.array(PRE_TOKS), nd.array(PRE_LENS))
    return logits.asnumpy(), [(k.asnumpy(), v.asnumpy()) for k, v in cache]


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, T)).astype(
        "int32")


def test_forward_matches(pair):
    jnet, tnet, _ = pair
    toks = _tokens(2, 20)
    ref = jnet(nd.array(toks)).asnumpy()
    with torch.no_grad():
        out = tnet(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_prefill_logits_and_cache_match(pair, jax_prefill):
    _, tnet, _ = pair
    ref_logits, ref_cache = jax_prefill
    with torch.no_grad():
        logits, cache = tnet.prefill(torch.from_numpy(PRE_TOKS),
                                     torch.from_numpy(PRE_LENS))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL,
                               rtol=ATOL)
    assert len(cache) == LAYERS
    for (k, v), (rk, rv) in zip(cache, ref_cache):
        for b, n in enumerate(PRE_LENS):
            np.testing.assert_allclose(k[b, :n].numpy(), rk[b, :n],
                                       atol=ATOL, rtol=ATOL)
            np.testing.assert_allclose(v[b, :n].numpy(), rv[b, :n],
                                       atol=ATOL, rtol=ATOL)


def test_step_logits_match(pair, jax_prefill):
    jnet, tnet, _ = pair
    B, S = 3, 32
    # the prefilled rows sit in an (B, S) cache; two decode steps follow
    ref_cache, cache = [], []
    for rk, rv in jax_prefill[1]:
        k = np.zeros((B, S, HEADS, UNITS // HEADS), "float32")
        v = np.zeros_like(k)
        k[:, :16], v[:, :16] = rk, rv
        ref_cache.append((nd.array(k), nd.array(v)))
        cache.append((torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))
    pos = PRE_LENS.copy()
    for step_tok in ([[5], [9], [1]], [[60], [0], [33]]):
        tok = np.array(step_tok, "int32")
        ref_logits, ref_cache = jnet.step(nd.array(tok), ref_cache,
                                          nd.array(pos))
        with torch.no_grad():
            logits, cache = tnet.step(torch.from_numpy(tok), cache,
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), ref_logits.asnumpy(),
                                   atol=ATOL, rtol=ATOL)
        for (k, _), (rk, _) in zip(cache, ref_cache):
            for b, n in enumerate(pos + 1):
                np.testing.assert_allclose(k[b, :n].numpy(),
                                           rk.asnumpy()[b, :n],
                                           atol=ATOL, rtol=ATOL)
        pos = pos + 1


def test_convert_round_trip(pair):
    jnet, tnet, params = pair
    back = convert.mxnet_params_from_state_dict(tnet.state_dict(),
                                                prefix=jnet.prefix)
    assert set(back) == set(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr)
    sd = convert.state_dict_from_mxnet(params)       # prefix inferred
    assert set(sd) == set(tnet.state_dict())


def test_convert_maps_by_structure_not_counter(pair):
    jnet, tnet, params = pair
    # the same net built later in a process carries other counters
    renamed = {k.replace(jnet.prefix, "transformerlm7_")
               .replace("transformerencoderlayer1_",
                        "transformerencoderlayer13_")
               .replace("transformerencoderlayer0_",
                        "transformerencoderlayer12_")
               .replace("layernorm1_", "layernorm5_")
               .replace("layernorm0_", "layernorm4_"): v
               for k, v in params.items()}
    sd = convert.state_dict_from_mxnet(renamed, prefix="transformerlm7_")
    ref = convert.state_dict_from_mxnet(params, prefix=jnet.prefix)
    assert set(sd) == set(ref)
    for name in ref:
        assert torch.equal(sd[name], ref[name]), name


@pytest.mark.parametrize("fault", ["extra", "missing", "shape", "prefix"])
def test_convert_refuses_bad_params(pair, fault):
    jnet, _, params = pair
    params = dict(params)
    target = jnet.prefix + "blocks_transformerencoderlayer0_ffn_up_bias"
    if fault == "extra":
        target = jnet.prefix + "blocks_transformerencoderlayer0_gate_weight"
        params[target] = np.zeros((3,), "float32")
    elif fault == "missing":
        del params[target]
    elif fault == "shape":
        params[target] = np.zeros((7,), "float32")
    else:
        target = "othernet0_embed_weight"
        params[target] = np.zeros((VOCAB, UNITS), "float32")
    net = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                        num_heads=HEADS, max_len=MAX_LEN, device="cpu")
    expect = "ffn_up" if fault in ("missing", "shape") else target
    with pytest.raises(ValueError, match=expect):
        convert.load_mxnet_params(net, params, prefix=jnet.prefix)


def test_layers_match_reference_ops():
    from mxnet_tpu.ops.nn import FullyConnected, LayerNorm as JLayerNorm, gelu
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 16)).astype("float32")
    w = rng.standard_normal((8, 16)).astype("float32")
    b = rng.standard_normal((8,)).astype("float32")
    g = rng.standard_normal((16,)).astype("float32")
    xt, wt, bt, gt = map(torch.from_numpy, (x, w, b, g))
    np.testing.assert_allclose(
        tnn.FullyConnected(xt, wt, bt, flatten=False).numpy(),
        np.asarray(FullyConnected.fn(x, w, b, flatten=False)), atol=1e-5)
    np.testing.assert_allclose(
        tnn.FullyConnected(xt, wt[:, :4].contiguous().repeat(1, 16), bt,
                           flatten=True).numpy(),
        np.asarray(FullyConnected.fn(x, np.tile(w[:, :4], 16), b)),
        atol=1e-4)
    np.testing.assert_allclose(tnn.gelu(xt).numpy(), np.asarray(gelu.fn(x)),
                               atol=1e-6)
    np.testing.assert_allclose(tnn.LayerNorm(xt, gt, bt[:1].expand(16))
                               .numpy(),
                               np.asarray(JLayerNorm.fn(x, g,
                                                        np.repeat(b[:1], 16))),
                               atol=1e-5)
    np.testing.assert_allclose(
        tnn.LayerNorm(xt, gt[:4], gt[:4], axis=1).numpy(),
        np.asarray(JLayerNorm.fn(x, g[:4], g[:4], axis=1)), atol=1e-5)


def test_layer_parameters_keep_gluon_names():
    d = Dense(8, 4, device="cpu")
    assert d.weight.shape == (8, 4) and d.bias.shape == (8,)
    assert Dense(8, 4, use_bias=False, device="cpu").bias is None
    assert Embedding(10, 4, device="cpu").weight.shape == (10, 4)
    ln = LayerNorm(4, device="cpu")
    assert set(dict(ln.named_parameters())) == {"gamma", "beta"}
    net = transformer_lm_tiny(vocab_size=32, device="cpu")
    names = set(net.state_dict())
    assert "blocks.1.attn.qkv.weight" in names
    assert "blocks.0.ffn_up.bias" in names and "ln_f.gamma" in names
    assert (net.num_layers, net.num_heads, net.head_dim) == (2, 4, 16)


def test_generation_ops_match_reference():
    from mxnet_tpu.ops import generation_ops as jgen
    rng = np.random.default_rng(9)
    cache = rng.standard_normal((3, 10, 2, 4)).astype("float32")
    new = rng.standard_normal((3, 2, 2, 4)).astype("float32")
    pos = np.array([0, 5, 9], "int32")                  # 9 clamps to 8
    ref = np.asarray(jgen.kv_cache_update.fn(cache, new, pos))
    out = gen.kv_cache_update(torch.from_numpy(cache.copy()),
                              torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(out.numpy(), ref)
    arena = rng.standard_normal((2, 4, 10, 2, 4)).astype("float32")
    blk = rng.standard_normal((2, 1, 6, 2, 4)).astype("float32")
    ref = np.asarray(jgen.arena_update.fn(arena, blk, np.int32(2), axis=1))
    out = gen.arena_update(torch.from_numpy(arena.copy()),
                           torch.from_numpy(blk), 2, axis=1)
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = np.asarray(jgen.arena_slice.fn(arena, np.int32(3), axis=1))
    np.testing.assert_array_equal(
        gen.arena_slice(torch.from_numpy(arena), 3, axis=1).numpy(), ref)
    logits = rng.standard_normal((4, 50)).astype("float32")
    greedy = np.asarray(jgen.generation_sample.fn(
        logits, np.array([0, 1], "uint32"), np.zeros(4, "float32"), k=5))
    out = gen.generation_sample(torch.from_numpy(logits), None,
                                torch.zeros(4), k=5)
    np.testing.assert_array_equal(out.numpy(), greedy)


def test_sampling_is_seeded_and_respects_top_k():
    logits = torch.randn(6, 40, generator=torch.Generator().manual_seed(1))
    temps = torch.tensor([0.0, 1.0, 1.0, 0.5, 2.0, 0.0])

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return gen.generation_sample(logits, g, temps, k=3)

    a, b = draw(3), draw(3)
    assert torch.equal(a, b)
    assert a[0] == logits[0].argmax() and a[5] == logits[5].argmax()
    top3 = logits.topk(3, dim=-1).indices
    assert all(int(a[i]) in top3[i].tolist() for i in range(6))
