"""The port's vision ops and normalization layers against the JAX package.

- ``Convolution`` (1-D, 2-D, 3-D; groups, dilation, stride, padding,
  with and without bias), ``Deconvolution`` and ``Pooling`` (max, avg,
  sum, lp; ``valid`` and ``full``; with and without
  ``count_include_pad``; global): the same numpy inputs through
  ``mxnet_tpu.ops.nn`` and ``mxnet_tpu_torch.ops.nn``, the forward and the
  gradient of every input (``jax.grad`` against torch's autograd) within
  1e-5 of each output's largest |value| (float32, sums in another order).
- Max pooling on tied windows (the zeros after a ReLU, windows of equal
  values): the forward and the gradient equal the reference's bit for
  bit (the first largest element of a window in row-major order takes
  its whole gradient, as XLA's select-and-scatter gives it).
- The ``BatchNorm`` layer in training and in inference, and its
  moving-statistics update: float32 within 1e-6 of each output's largest
  |value|; bfloat16 data (the layer cast, its parameters float32) within
  one bfloat16 ulp of each element, the moving statistics within 1e-6;
  with every parameter bfloat16 (a trainer's ``dtype``), within two ulps
  of the output's largest |value| (bf16 ``rsqrt`` rounds a few values the
  other way in XLA) and one of each moving statistic.
- ``InstanceNorm`` and ``GroupNorm`` layers; ``Sequential``,
  ``HybridSequential``, ``Lambda``, ``HybridLambda``, ``Flatten`` and a
  deferred ``Dense`` with an activation; the ops' registry names.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jlayers
from mxnet_tpu.ops import nn as jops
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import nn as tlayers
from mxnet_tpu_torch.ops import nn as tops

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _reference_compiles_unoptimized():
    """The reference compiles one XLA program per eager op and shape;
    compiling them without XLA's optimizations costs less and leaves their
    values within these tolerances. Module scope: the flag is restored and
    the programs compiled under it dropped, so no later test reuses one."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()

TOL = 1e-5
BN_TOL = 1e-6


def _rel(out, ref):
    """The largest difference over the largest finite |value| of ``ref``;
    infinities (windows of padding alone) must be equal."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    inf = ~np.isfinite(ref)
    if inf.any() and not np.array_equal(out[inf], ref[inf]):
        return np.inf
    out, ref = out[~inf], ref[~inf]
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _both(jfn, tfn, arrays, kw, tol=TOL, exact=False):
    """Forward and every input's gradient (cotangent ``g``) of the two
    packages' functions on the same arrays."""
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.tensor(a, requires_grad=True) for a in arrays]
    ref, vjp = jax.vjp(lambda *a: jfn(*a, **kw), *jx)
    out = tfn(*tx, **kw)
    g = np.random.default_rng(7).standard_normal(ref.shape).astype(
        np.float32)
    jg = vjp(jnp.asarray(g))
    out.backward(torch.from_numpy(g))
    pairs = [(out.detach().numpy(), np.asarray(ref))]
    pairs += [(t.grad.numpy() if t.grad is not None else np.zeros(t.shape),
               np.asarray(r)) for t, r in zip(tx, jg)]
    for got, want in pairs:
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) <= tol


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


CONV_CASES = [
    ("2d_groups_dilation", (2, 4, 9, 9), (6, 2, 3, 3),
     dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
          num_group=2), True),
    ("2d_stem", (2, 3, 16, 16), (8, 3, 7, 7),
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), no_bias=True), False),
    ("1d", (2, 4, 11), (5, 4, 3),
     dict(kernel=(3,), stride=2, pad=1, no_bias=True), False),
    ("3d", (1, 2, 5, 6, 7), (3, 2, 2, 3, 2),
     dict(kernel=(2, 3, 2), stride=1, pad=(1, 1, 0), no_bias=True), False),
]


@pytest.mark.parametrize("name,xs,ws,kw,bias", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_convolution_matches_reference(name, xs, ws, kw, bias):
    rng = np.random.default_rng(0)
    arrays = [_rand(rng, *xs), _rand(rng, *ws)]
    if bias:
        arrays.append(_rand(rng, ws[0]))
    _both(jops.Convolution.fn, tops.Convolution, arrays, kw)


DECONV_CASES = [
    ("2d", (2, 4, 5, 5), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0),
          no_bias=False)),
    ("3d_dilation", (1, 2, 3, 4, 3), (2, 2, 2, 2, 2),
     dict(kernel=(2, 2, 2), dilate=(2, 1, 1), no_bias=False)),
]


@pytest.mark.parametrize("name,xs,ws,kw", DECONV_CASES,
                         ids=[c[0] for c in DECONV_CASES])
def test_deconvolution_matches_reference(name, xs, ws, kw):
    rng = np.random.default_rng(1)
    arrays = [_rand(rng, *xs), _rand(rng, *ws)]
    if not kw.get("no_bias", True):
        arrays.append(_rand(rng, ws[1]))
    _both(jops.Deconvolution.fn, tops.Deconvolution, arrays, kw)


# count_include_pad changes avg pooling alone
POOL_MODES = [(t, True) for t in ("max", "sum", "lp")] + \
    [("avg", True), ("avg", False)]


@pytest.mark.parametrize("pool_type,count_include_pad", POOL_MODES,
                         ids=["max", "sum", "lp", "avg", "avg_no_pad"])
@pytest.mark.parametrize("convention", ["valid", "full"])
def test_pooling_matches_reference(pool_type, count_include_pad, convention):
    x = _rand(np.random.default_rng(2), 2, 3, 9, 10)
    _both(jops.Pooling.fn, tops.Pooling, [x],
          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool_type,
               pooling_convention=convention,
               count_include_pad=count_include_pad))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling_matches_reference(pool_type):
    x = _rand(np.random.default_rng(3), 2, 3, 5, 6)
    _both(jops.Pooling.fn, tops.Pooling, [x],
          dict(global_pool=True, pool_type=pool_type))


@pytest.mark.parametrize("shape,kw", [
    ((2, 3, 10), dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="avg",
                      count_include_pad=False)),
    ((2, 3, 10), dict(kernel=(2,), stride=(3,), pool_type="max",
                      pooling_convention="full")),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 3, 2), stride=(2, 2, 2), pad=(1, 1, 0),
                           pool_type="avg", pooling_convention="full")),
], ids=["1d_avg", "1d_max_full", "3d_avg_full"])
def test_pooling_1d_3d_matches_reference(shape, kw):
    _both(jops.Pooling.fn, tops.Pooling,
          [_rand(np.random.default_rng(4), *shape)], kw)


def _tied_inputs():
    rng = np.random.default_rng(5)
    relu = np.maximum(_rand(rng, 2, 4, 12, 12), 0.0)   # about half zeros
    relu[:, :, :4, :4] = 0.0                           # windows of zeros
    flat = np.full((1, 2, 8, 8), 0.5, np.float32)      # all windows equal
    steps = np.repeat(np.repeat(_rand(rng, 1, 2, 4, 4), 2, axis=2), 2,
                      axis=3)                          # 2x2 blocks of equals
    return {"relu": relu, "flat": flat, "blocks": steps}


@pytest.mark.parametrize("data,kw", [
    ("relu", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),  # the stem's
    ("flat", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("blocks", dict(kernel=(2, 2), stride=(2, 2))),
    ("flat", dict(kernel=(3, 3), stride=(2, 2), pooling_convention="full")),
], ids=["relu_stem", "flat_stem", "blocks_k2s2", "flat_k3s2_full"])
def test_max_pool_ties_match_reference_bitwise(data, kw):
    """Where a window holds its largest value more than once, the port
    gives the whole gradient to the same element as the reference."""
    _both(jops.Pooling.fn, tops.Pooling, [_tied_inputs()[data]],
          dict(pool_type="max", **kw), exact=True)


@pytest.mark.parametrize("train,fix_gamma", [(True, False), (True, True)],
                         ids=["train", "train_fix_gamma"])
def test_batch_norm_op_gradients_match_reference(train, fix_gamma):
    rng = np.random.default_rng(6)
    x, g, b = _rand(rng, 4, 3, 5, 5), _rand(rng, 3), _rand(rng, 3)
    rm, rv = _rand(rng, 3), rng.random(3).astype(np.float32) + 0.5
    kw = dict(train=train, fix_gamma=fix_gamma, eps=1e-5)

    def jfn(x, g, b):
        return jops.BatchNorm.fn(x, g, b, jnp.asarray(rm), jnp.asarray(rv),
                                 **kw)

    def tfn(x, g, b):
        return tops.BatchNorm(x, g, b, torch.from_numpy(rm),
                              torch.from_numpy(rv), **kw)
    _both(jfn, tfn, [x, g, b], {}, tol=BN_TOL)


def _bn_pair(rng, c, dtype, **kw):
    """A reference and a port ``BatchNorm`` with the same random gamma,
    beta and moving statistics."""
    ref = jlayers.BatchNorm(in_channels=c, **kw)
    ref.initialize()
    with tmx.cpu():
        port = tlayers.BatchNorm(in_channels=c, **kw)
        port.initialize()
    values = {"gamma": _rand(rng, c), "beta": _rand(rng, c),
              "running_mean": _rand(rng, c),
              "running_var": rng.random(c).astype(np.float32) + 0.5}
    for leaf, v in values.items():
        getattr(ref, leaf).set_data(mx.nd.array(v))
        getattr(port, leaf).set_data(v)
    if dtype == "bfloat16":
        ref.cast(dtype)
        port.cast(dtype)
    elif dtype == "bfloat16_stats":   # every parameter bf16 (a trainer's dtype)
        for leaf in values:
            getattr(ref, leaf).cast("bfloat16")
            getattr(port, leaf).cast("bfloat16")
    return ref, port


def _bf16_ulp(v):
    """One bfloat16 ulp at each |value| (8 significant bits)."""
    a = np.abs(np.asarray(v, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype,train,kw", [
    ("float32", True, {}), ("float32", False, {}),
    ("float32", True, dict(scale=False, momentum=0.8)),
    ("bfloat16", True, {}), ("bfloat16", False, {}),
    ("bfloat16_stats", True, {})],
    ids=["float32-train", "float32-inference", "float32-train_fix_gamma",
         "bfloat16-train", "bfloat16-inference", "bfloat16_stats-train"])
def test_batch_norm_layer_matches_reference(dtype, train, kw):
    """``bfloat16_stats``: every parameter bf16 (a ``ShardedTrainer``'s
    ``dtype``): ``rsqrt`` of the bf16 variance rounds the other way for
    ~0.5% of values (XLA's bf16 ``rsqrt`` against torch's), so an element
    of the output may differ by two ulps of the output's largest |value|;
    each moving statistic within one ulp of its own."""
    rng = np.random.default_rng(8)
    ref, port = _bn_pair(rng, 4, dtype, **kw)
    x = _rand(rng, 3, 4, 6, 5) * 2.0 + 0.5
    data = dtype[:8]
    jx = mx.nd.array(x).astype(data)
    with tmx.cpu():
        tx = tnd.array(x).astype(data)
    for _ in range(2):              # the second step reads updated stats
        with mx.autograd.record(train_mode=train):
            want = ref(jx)
        with tmx.cpu(), tag.record(train_mode=train):
            got = port(tx)
        assert str(got.dtype).endswith(data)
        w = want.astype("float32").asnumpy()
        o = got.astype("float32").asnumpy()
        if dtype == "float32":
            assert _rel(o, w) <= BN_TOL
        elif dtype == "bfloat16":
            assert np.all(np.abs(o - w) <= _bf16_ulp(w))
        else:   # XLA's bf16 rsqrt rounds ~0.5% of values the other way
            assert np.all(np.abs(o - w) <= 2 * _bf16_ulp(np.abs(w).max()))
        for leaf in ("running_mean", "running_var", "gamma", "beta"):
            p, q = getattr(ref, leaf), getattr(port, leaf)
            a = q.data().astype("float32").asnumpy()
            b = p.data().astype("float32").asnumpy()
            if dtype == "bfloat16_stats":
                assert str(q.data().dtype) == "bfloat16"
                assert np.all(np.abs(a - b) <= _bf16_ulp(b))
            else:
                assert str(q.data().dtype) == "float32"
                assert _rel(a, b) <= BN_TOL
    if train:       # the moving statistics moved
        assert not np.allclose(port.running_mean.data().asnumpy(), 0.0)


@pytest.mark.parametrize("layer,kw", [
    ("InstanceNorm", dict(scale=True)), ("GroupNorm", dict(num_groups=2)),
], ids=["instance", "group"])
def test_instance_and_group_norm_match_reference(layer, kw):
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 4, 5, 6)
    ref = getattr(jlayers, layer)(**kw)
    ref.initialize()
    with tmx.cpu():
        port = getattr(tlayers, layer)(**kw)
        port.initialize()
        got = port(tnd.array(x)).asnumpy()
    assert _rel(got, ref(mx.nd.array(x)).asnumpy()) <= TOL


def test_sequential_lambda_and_dense_layers_match_reference(monkeypatch):
    """``Sequential`` of a ``Lambda``, ``HybridSequential`` of a
    ``HybridLambda``, ``Flatten`` and a deferred ``Dense`` with its
    activation, from the same seed's ``Xavier()`` draws. The blocks are
    made outside a name scope, so each package numbers them from its
    process-wide counters: both start from empty ones here, whatever
    earlier tests in the process made."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock
    monkeypatch.setattr(jblock, "_global_counter", {})
    monkeypatch.setattr(tblock, "_global_counter", {})
    x = _rand(np.random.default_rng(11), 2, 3, 4, 4)

    def build(pkg):
        net = pkg.Sequential()
        body = pkg.HybridSequential()
        body.add(pkg.HybridLambda("relu"), pkg.Flatten(),
                 pkg.Dense(5, activation="tanh"))
        net.add(pkg.Lambda(lambda v: v * 2.0), body)
        return net
    mx.random.seed(0)
    ref = build(jlayers)
    ref.initialize(mx.init.Xavier())
    want = ref(mx.nd.array(x)).asnumpy()
    tmx.random.seed(0)
    with tmx.cpu():
        port = build(tlayers)
        port.initialize(tmx.init.Xavier())
        got = port(tnd.array(x)).asnumpy()
    assert [n[len(port.prefix):] for n in port.collect_params()] == \
        [n[len(ref.prefix):] for n in ref.collect_params()]
    assert _rel(got, want) <= TOL


def test_vision_ops_resolve_by_reference_names():
    for name in ("Convolution", "convolution", "Deconvolution",
                 "deconvolution", "Pooling", "pooling", "BatchNorm",
                 "batch_norm", "BatchNorm_v1", "InstanceNorm", "GroupNorm",
                 "pad", "Pad"):
        assert hasattr(tnd, name), name
    rng = np.random.default_rng(10)
    x, w = _rand(rng, 1, 2, 6, 6), _rand(rng, 3, 2, 3, 3)
    with tmx.cpu():
        out = tnd.Convolution(tnd.array(x), tnd.array(w), kernel=(3, 3),
                              num_filter=3, no_bias=True).asnumpy()
        padded = tnd.pad(tnd.array(x), mode="reflect",
                         pad_width=(0, 0, 0, 0, 1, 1, 2, 2)).asnumpy()
    ref = jops.Convolution.fn(jnp.asarray(x), jnp.asarray(w), kernel=(3, 3),
                              num_filter=3, no_bias=True)
    assert _rel(out, ref) <= TOL
    np.testing.assert_array_equal(
        padded, np.pad(x, [(0, 0), (0, 0), (1, 1), (2, 2)], mode="reflect"))
