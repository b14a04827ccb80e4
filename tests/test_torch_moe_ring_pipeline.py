"""The port's ring attention, expert-parallel MoE and pipeline
(``mxnet_tpu_torch.parallel``) against the JAX package's, on the CPU:
the counterparts of ``tests/test_moe.py`` and of ``tests/test_parallel.py``'s
ring-attention and pipeline tests. Meshes are logical CPU devices; every
output is held to the reference's on the same numpy inputs within 1e-5,
and to plain float64 math where the reference test does so."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mxnet_tpu import parallel as jparallel
from mxnet_tpu.parallel import moe as jmoe
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.parallel import moe as tmoe

CPUS = [tmx.cpu(i) for i in range(8)]


def _data(T=64, D=16, seed=0):
    return np.random.RandomState(seed).randn(T, D).astype("float32")


def _dense_attn(q, k, v, causal):
    S, D = q.shape[2], q.shape[3]
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.fixture(scope="module")
def ring_inputs():
    np.random.seed(0)
    q, k, v = (np.random.randn(2, 4, 32, 16).astype("float32")
               for _ in range(3))
    mesh = jparallel.make_mesh(dp=1, sp=8)
    ref = {c: np.asarray(jparallel.ring_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, causal=c,
        batch_axis="dp")) for c in (False, True)}
    return q, k, v, ref


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(ring_inputs, causal):
    q, k, v, ref = ring_inputs
    mesh = tparallel.make_mesh(dp=1, sp=8, devices=CPUS)
    out = tparallel.ring_attention_sharded(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mesh,
        causal=causal, batch_axis="dp").numpy()
    np.testing.assert_allclose(out, ref[causal], rtol=1e-5, atol=1e-5)
    want = _dense_attn(q.astype("float64"), k.astype("float64"),
                       v.astype("float64"), causal)
    np.testing.assert_allclose(out, want, rtol=2e-3, atol=2e-3)


def test_ring_attention_fully_masked_rows_and_dp():
    """A dp=2 x sp=4 ring with a causal mask: the rows' first blocks are
    fully masked for most positions (corr = 0, never NaN)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 2, 16, 8)).astype("float32")
               for _ in range(3))
    mesh = tparallel.make_mesh(dp=2, sp=4, devices=CPUS)
    out = tparallel.ring_attention_sharded(
        *(torch.from_numpy(a) for a in (q, k, v)), mesh, causal=True).numpy()
    assert np.isfinite(out).all()
    want = _dense_attn(*(a.astype("float64") for a in (q, k, v)), True)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_pipeline_matches_sequential():
    np.random.seed(0)
    n_stages, d = 4, 16
    Ws = np.random.randn(n_stages, d, d).astype("float32") * 0.3
    x = np.random.randn(8, d).astype("float32")
    ref = x
    for i in range(n_stages):
        ref = np.tanh(ref @ Ws[i])
    jmesh = jparallel.make_mesh(dp=1, pp=4, devices=jax.devices()[:4])
    jout = np.asarray(jparallel.pipeline_spmd(
        lambda w, h: jnp.tanh(h @ w), jnp.asarray(Ws), jnp.asarray(x),
        jmesh, n_micro=4))
    mesh = tparallel.make_mesh(dp=1, pp=4, devices=CPUS[:4])
    out = tparallel.pipeline_spmd(lambda w, h: torch.tanh(h @ w),
                                  torch.from_numpy(Ws), torch.from_numpy(x),
                                  mesh, n_micro=4).numpy()
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # a dict of stage parameters, every position holding the output
    eye = torch.eye(4)
    params = {"w": torch.stack([eye, 2.0 * eye])}
    pmesh = tparallel.make_mesh(pp=2, devices=CPUS[:2])
    outs = tparallel.pipeline_apply(
        lambda p, a: a @ p["w"], [{"w": params["w"][0]},
                                  {"w": params["w"][1]}],
        [torch.ones(4, 4)] * 2, 2, pmesh)
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), 2.0 * np.ones((4, 4)))


def _params(rng, d, h, e):
    gate, w1, w2 = tmoe.init_moe_params(rng, d, h, e, device="cpu")
    jg, jw1, jw2 = jmoe.init_moe_params(rng, d, h, e)
    for a, b in ((gate, jg), (w1, jw1), (w2, jw2)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    return (gate, w1, w2), (jg, jw1, jw2)


def test_moe_routes_to_experts_and_balances():
    x = _data()
    (g, w1, w2), (jg, jw1, jw2) = _params(1, 16, 32, 4)
    y, aux = tmoe.moe_ffn(torch.from_numpy(x), g, w1, w2,
                          capacity_factor=2.0)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jg, jw1, jw2,
                            capacity_factor=2.0)
    assert y.shape == x.shape and np.isfinite(y.numpy()).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert float(aux) >= 0.99


def test_moe_capacity_drops_tokens():
    x = torch.from_numpy(_data(T=32))
    g, w1, w2 = tmoe.init_moe_params(2, 16, 32, 2, device="cpu")
    y, _ = tmoe.moe_ffn(x, g, w1, w2, capacity_factor=1.0 / 16.0)
    assert (y.abs().sum(-1) < 1e-7).sum() >= 30
    yf, _ = tmoe.moe_ffn(x, g, w1, w2, capacity_factor=100.0)
    assert (yf.abs().sum(-1) > 1e-7).sum() == 32


def test_moe_gradients_flow():
    x = _data(T=32)
    (g, w1, w2), (jg, jw1, jw2) = _params(3, 16, 32, 4)
    leaves = [t.clone().requires_grad_(True) for t in (g, w1, w2)]
    y, aux = tmoe.moe_ffn(torch.from_numpy(x), *leaves, capacity_factor=2.0)
    (torch.sum(y * y) + 0.01 * aux).backward()

    def loss(gw, a, b):
        yy, aa = jmoe.moe_ffn(jnp.asarray(x), gw, a, b, capacity_factor=2.0)
        return jnp.sum(yy * yy) + 0.01 * aa
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jg, jw1, jw2)
    for leaf, jgr in zip(leaves, jgrads):
        assert np.isfinite(leaf.grad.numpy()).all()
        assert leaf.grad.abs().sum() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgr),
                                   rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def moe_sharded_reference():
    x = _data(T=64, D=16, seed=5)
    gate, w1, w2 = jmoe.init_moe_params(7, 16, 32, 4)
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    y, aux = jmoe.moe_ffn_sharded(jnp.asarray(x), gate, w1, w2, mesh,
                                  capacity_factor=100.0)
    y2, aux2 = jmoe.moe_ffn_sharded(jnp.asarray(x), gate, w1, w2, mesh,
                                    capacity_factor=1.0)
    return x, (np.asarray(y), float(aux)), (np.asarray(y2), float(aux2))


def test_moe_sharded_matches_dense_oracle(moe_sharded_reference):
    x, (jy, jaux), _ = moe_sharded_reference
    gate, w1, w2 = tmoe.init_moe_params(7, 16, 32, 4, device="cpu")
    mesh = tparallel.Mesh([CPUS[i] for i in range(4)], ("ep",))
    y_ref, aux_ref = tmoe.moe_ffn(torch.from_numpy(x), gate, w1, w2,
                                  capacity_factor=100.0)
    y, aux = tmoe.moe_ffn_sharded(torch.from_numpy(x), gate, w1, w2, mesh,
                                  capacity_factor=100.0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert abs(float(aux) - float(aux_ref)) < 0.15
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - jaux) <= 1e-5


def test_moe_sharded_under_jit_compiles_once(moe_sharded_reference):
    """The reference's jit test; here: repeated sharded calls at a tight
    capacity (tokens dropped per shard) give the reference's outputs,
    and different inputs give different values."""
    x, _, (jy, jaux) = moe_sharded_reference
    gate, w1, w2 = tmoe.init_moe_params(7, 16, 32, 4, device="cpu")
    mesh = tparallel.make_mesh(dp=1, ep=4, devices=CPUS[:4])
    outs = [tmoe.moe_ffn_sharded(torch.from_numpy(x + s), gate, w1, w2,
                                 mesh, capacity_factor=1.0, axis="ep")
            for s in (0.0, 0.0, 0.1)]
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[0][0].numpy(), jy, rtol=1e-5, atol=1e-5)
    assert abs(float(outs[0][1]) - jaux) <= 1e-5
    v1 = float(outs[0][0].sum() + outs[0][1])
    v2 = float(outs[2][0].sum() + outs[2][1])
    assert np.isfinite([v1, v2]).all() and v1 != v2


def test_moe_lm_loads_reference_weights_and_decodes_as_reference():
    """``MoETransformerLM``: the reference's weights load through
    ``convert.load_mxnet_params``; ``prefill`` (with lengths),
    ``prefill_chunk`` and ``step`` logits follow the reference's within
    1e-5 (its training forward is held by the planner tests' losses).
    The reference runs eagerly here, an XLA compile per op: its
    optimizations are off for the test (restored after)."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        _moe_lm_decode_case()
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


def _moe_lm_decode_case():
    import mxnet_tpu as jmx
    from mxnet_tpu.models.moe_transformer import moe_lm_tiny as jtiny
    from mxnet_tpu_torch import convert, nd
    from mxnet_tpu_torch.models import moe_lm_tiny
    jmx.random.seed(3)
    np.random.seed(3)
    jnet = jtiny()
    jnet.initialize(jmx.init.Xavier())      # every shape is known
    with tmx.cpu():
        net = moe_lm_tiny()
        net.initialize(tmx.init.Zero())
        net(nd.zeros((1, 4), dtype="int32"))
    convert.load_mxnet_params(
        net, {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}, ctx=tmx.cpu())
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (2, 8)).astype("int32")
    lens = np.array([8, 5], "int32")

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        logits, cache = net.prefill(torch.from_numpy(toks),
                                    torch.from_numpy(lens))
    jlogits, jcache = jnet.prefill(jmx.nd.array(toks, dtype="int32"),
                                   jmx.nd.array(lens, dtype="int32"))
    close(logits.numpy(), jlogits.asnumpy())
    nxt = np.array([[3], [7]], "int32")
    with torch.no_grad():
        full = net.init_cache(2, max_len=16)
        for (k, v), (pk, pv) in zip(full, cache):
            k[:, :8], v[:, :8] = pk, pv
        step, _ = net.step(torch.from_numpy(nxt), full,
                           torch.from_numpy(lens))
    jfull = jnet.init_cache(2, max_len=16)
    jfull = [(jmx.nd.array(np.concatenate([np.asarray(pk.asnumpy()),
                                           np.zeros((2, 8, 2, 16),
                                                    "float32")], 1)),
              jmx.nd.array(np.concatenate([np.asarray(pv.asnumpy()),
                                           np.zeros((2, 8, 2, 16),
                                                    "float32")], 1)))
             for pk, pv in jcache]
    jstep, _ = jnet.step(jmx.nd.array(nxt, dtype="int32"), jfull,
                         jmx.nd.array(lens, dtype="int32"))
    close(step.numpy(), jstep.asnumpy())
    with torch.no_grad():
        chunk, _ = net.prefill_chunk(torch.from_numpy(toks[:, :3]),
                                     net.init_cache(2, max_len=16),
                                     torch.zeros(2, dtype=torch.int64))
    jchunk, _ = jnet.prefill_chunk(jmx.nd.array(toks[:, :3], dtype="int32"),
                                   jnet.init_cache(2, max_len=16),
                                   jmx.nd.zeros((2,), dtype="int32"))
    close(chunk.numpy(), jchunk.asnumpy())
