"""The port's NDArray, ``nd`` namespace, context, engine and runtime
against the JAX package.

The same numpy inputs go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the CPU (every port call runs under
``with mx.cpu():``, since the port's default context is the card):
constructors, methods and registered ops (float32 at 1e-5: sums in
another order), indexing and assignment, the reference's rebind aliasing
(an array made from another does not see a later in-place change), dtype
rules, ``nd.save``/``nd.load`` bytes both ways, NaiveEngine mode,
``runtime.Features`` and ``Context``.
"""
import importlib.util

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import engine as jengine
from mxnet_tpu import nd as jnd
from mxnet_tpu import runtime as jruntime
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import runtime as truntime
from mxnet_tpu_torch.context import Context

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _x(seed=0, shape=(3, 4, 5)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _same(own, ref, tol=TOL):
    own, ref = np.asarray(own.asnumpy()), np.asarray(ref.asnumpy())
    assert own.shape == ref.shape
    assert str(own.dtype) == str(ref.dtype)
    np.testing.assert_allclose(own.astype("float64"), ref.astype("float64"),
                               atol=tol, rtol=tol)


# each case: a function of (nd namespace, NDArray) run in both packages
CASES = {
    "reshape": lambda F, a: a.reshape((3, 20)),
    "reshape_codes": lambda F, a: a.reshape((0, -1)),
    "reshape_merge": lambda F, a: F.reshape(a, shape=(-3, 0)),
    "reshape_split": lambda F, a: F.reshape(a, shape=(-4, 1, 3, -2)),
    "transpose": lambda F, a: a.transpose((2, 0, 1)),
    "T": lambda F, a: a.T,
    "swapaxes": lambda F, a: a.swapaxes(0, 2),
    "expand_squeeze": lambda F, a: a.expand_dims(1).squeeze(1),
    "flatten": lambda F, a: a.flatten(),
    "broadcast_to": lambda F, a: a[:, :1].broadcast_to((3, 4, 5)),
    "slice_axis": lambda F, a: a.slice_axis(2, 1, 4),
    "tile": lambda F, a: a.tile((1, 2, 1)),
    "repeat": lambda F, a: a.repeat(2, axis=1),
    "sum": lambda F, a: a.sum(),
    "sum_axis": lambda F, a: a.sum(axis=1, keepdims=True),
    "mean": lambda F, a: a.mean(axis=(0, 2)),
    "max": lambda F, a: a.max(axis=2),
    "min": lambda F, a: a.min(),
    "prod": lambda F, a: a.prod(axis=0),
    "norm": lambda F, a: a.norm(),
    "argmax": lambda F, a: a.argmax(axis=1),
    "argmin": lambda F, a: a.argmin(axis=2, keepdims=True),
    "clip": lambda F, a: a.clip(-0.5, 0.5),
    "abs": lambda F, a: a.abs(),
    "sqrt": lambda F, a: a.abs().sqrt(),
    "square": lambda F, a: a.square(),
    "exp": lambda F, a: a.exp(),
    "log": lambda F, a: (a.abs() + 1).log(),
    "relu": lambda F, a: a.relu(),
    "sigmoid": lambda F, a: a.sigmoid(),
    "tanh": lambda F, a: a.tanh(),
    "softmax": lambda F, a: a.softmax(axis=1),
    "arith": lambda F, a: (a + 1.5) * a - a / 3.0 + 2.0 ** a,
    "rarith": lambda F, a: 1.0 - a + 2.0 / (a.abs() + 1),
    "neg_pow_mod": lambda F, a: -(a ** 2) % 0.7,
    "matmul": lambda F, a: a[0] @ a[1].T,
    "compare": lambda F, a: (a > 0) + (a <= 0.5) * 2 + (a == a) + (a != 0),
    "astype": lambda F, a: a.astype("float16"),
    "take": lambda F, a: a.take(F.array([2, 0, 9]), axis=2),
    "pick": lambda F, a: a.pick(F.array([[0, 1, 2, 3, 1]] * 3), axis=1),
    "one_hot": lambda F, a: F.one_hot(F.array([0, 3, 1]), depth=4),
    "concat": lambda F, a: F.concat(a, a * 2, dim=1),
    "stack": lambda F, a: F.stack(a, a + 1, axis=0),
    "split": lambda F, a: F.split(a, num_outputs=2, axis=1)[1],
    "where": lambda F, a: F.where(a > 0, a, F.zeros_like(a)),
    "maximum": lambda F, a: F.maximum(a, 0.25) + F.minimum(a, a * 0.5),
    "broadcast_ops": lambda F, a: F.broadcast_add(
        F.broadcast_mul(a, a[:, :1]), F.broadcast_sub(a[:1], a)),
    "broadcast_div_lesser": lambda F, a: F.broadcast_lesser(
        a, a[:1]) + F.broadcast_div(a, a.abs() + 1),
    "gather_nd": lambda F, a: F.gather_nd(a, F.array([[0, 2], [1, 3]])),
    "dot": lambda F, a: F.dot(a[0], a[1].T),
    "batch_dot": lambda F, a: F.batch_dot(a, a, transpose_b=True),
    "FullyConnected": lambda F, a: F.FullyConnected(
        a, a[0], F.ones((4,)), num_hidden=4, flatten=False),
    "FullyConnected_flat": lambda F, a: F.FullyConnected(
        a, F.ones((2, 20)), None, no_bias=True, num_hidden=2),
    "LayerNorm": lambda F, a: F.LayerNorm(a, F.ones((5,)) * 1.5,
                                          F.ones((5,)) * 0.1),
    "Activation": lambda F, a: F.Activation(a, act_type="softrelu") +
    F.Activation(a, act_type="sigmoid"),
    "gelu": lambda F, a: F.LeakyReLU(a, act_type="gelu"),
    "leaky": lambda F, a: F.LeakyReLU(a, act_type="leaky", slope=0.1),
    "elu": lambda F, a: F.LeakyReLU(a, act_type="elu", slope=0.3),
    "log_softmax": lambda F, a: F.log_softmax(a, axis=-1),
    "softmax_length": lambda F, a: F.softmax(
        a[0], length=F.array([1, 3, 5, 2]), use_length=True, axis=-1),
    "Embedding": lambda F, a: F.Embedding(F.array([[0, 2], [1, 1]]), a[0]),
    "identity_Flatten": lambda F, a: F.Flatten(F.identity(a)),
    "arange": lambda F, a: F.arange(2, 11, 3) + F.arange(3),
    "Dropout_predict": lambda F, a: F.Dropout(a, p=0.5),
    "cast": lambda F, a: F.cast(a * 10, dtype="int32"),
    "T_sum_exclude": lambda F, a: F.sum(a, axis=1, exclude=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_methods_and_ops_match_reference(name):
    x = _x()
    ref = CASES[name](jnd, jnd.array(x))
    own = CASES[name](tnd, tnd.array(x))
    _same(own, ref)


@pytest.mark.parametrize("ctor", ["zeros", "ones", "full", "arange", "eye",
                                  "array_list", "array_int", "array_f64"])
def test_constructors_match_reference(ctor):
    make = {
        "zeros": lambda F: F.zeros((2, 3), dtype="int32"),
        "ones": lambda F: F.ones(4),
        "full": lambda F: F.full((2, 2), 7.5),
        "arange": lambda F: F.arange(0, 5, 0.5, repeat=2),
        "eye": lambda F: F.eye(3, 4, k=1),
        "array_list": lambda F: F.array([[1.0, 2.0], [3.0, 4.5]]),
        "array_int": lambda F: F.array([[1, 2], [3, 4]]),
        "array_f64": lambda F: F.array(np.arange(6.0).reshape(2, 3)),
    }[ctor]
    _same(make(tnd), make(jnd), tol=0)


@pytest.mark.parametrize("key", ["int", "slice", "tuple", "neg", "ndarray",
                                 "ellipsis"])
def test_indexing_matches_reference(key):
    x = _x(1)
    k = {"int": 1, "slice": slice(0, 2), "tuple": (1, slice(1, 3), 2),
         "neg": -1, "ellipsis": (Ellipsis, 0)}.get(key)
    if key == "ndarray":
        ref, own = jnd.array(x)[jnd.array([2, 0])], \
            tnd.array(x)[tnd.array([2, 0])]
    else:
        ref, own = jnd.array(x)[k], tnd.array(x)[k]
    _same(own, ref, tol=0)


def test_setitem_matches_reference():
    x = _x(2)
    out = []
    for F in (jnd, tnd):
        a = F.array(x)
        a[0] = 1.0
        a[1, 2:4] = F.array(np.full((2, 5), 3.0, "float32"))
        a[2, :, 1] = 9
        b = F.array(x)
        b[:] = 4.0
        c = F.array(x)
        c[:] = F.array(x[0])
        out.append((a, b, c))
    for own, ref in zip(out[1], out[0]):
        _same(own, ref, tol=0)


@pytest.mark.parametrize("kind", ["float32", "strided", "int64", "float64"])
def test_array_and_asnumpy_share_no_memory(kind):
    """``nd.array`` of a numpy array and ``asnumpy`` hold copies of their
    own on the CPU (MXNet's ``array`` copies): a later write to one side
    does not show on the other. Port only: the JAX package's CPU arrays
    may alias an aligned numpy buffer."""
    src = np.arange(24, dtype=np.float32).reshape(4, 6)
    dtype = None
    if kind == "strided":
        src = src[:, 1::2]
    elif kind != "float32":
        src = src.astype(kind)
        dtype = kind
    want = src.copy()
    a = tnd.array(src, ctx=tmx.cpu(), dtype=dtype)
    host = a.asnumpy()
    src[0, 0] = 99
    np.testing.assert_array_equal(a.asnumpy(), want)
    host[1, 1] = -7
    np.testing.assert_array_equal(a.asnumpy(), want)
    assert str(a.dtype) == str(want.dtype)


def test_mutation_rebinds_as_the_reference():
    x = _x(3)
    for F in (jnd, tnd):
        a = F.array(x)
        r = a.reshape((60,))
        c = a.copy()
        t = a[0]
        a += 1
        a[:] = 5.0
        np.testing.assert_array_equal(r.asnumpy(), x.reshape(60))
        np.testing.assert_array_equal(c.asnumpy(), x)
        np.testing.assert_array_equal(t.asnumpy(), x[0])
        np.testing.assert_array_equal(a.asnumpy(), np.full_like(x, 5.0))
        o = F.zeros((3, 4, 5))
        F.add(a, a, out=o)
        np.testing.assert_array_equal(o.asnumpy(), np.full_like(x, 10.0))


def test_dtype_rules_match_reference():
    for F in (jnd, tnd):
        assert F.array([1, 2]).dtype == np.int64
        assert F.array([1.0, 2.0]).dtype == np.float32
        assert F.array(np.zeros(2, "float64")).dtype == np.float32
        assert F.array([1.0], dtype="float64").dtype == np.float64
        assert (F.array([1, 2]) > 1).dtype == np.float32
        assert F.array([[1.0, 3.0]]).argmax(axis=1).dtype == np.float32
        assert F.one_hot(F.array([1]), depth=2).dtype == np.float32
        assert F.zeros((2,), dtype="int32").astype("float16").dtype == \
            np.float16
        a = F.array([1.5, 2.5])
        assert a.astype("float32", copy=False) is a
        assert a.shape == (2,) and a.ndim == 1 and a.size == 2
        assert float(F.array([2.5])) == 2.5 and len(a) == 2
        assert F.array([3.0]).asscalar() == 3.0


@pytest.mark.parametrize("kind", ["dict", "list"])
def test_save_load_bytes_both_ways(tmp_path, kind):
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, 3)).astype("float32"),
              rng.integers(0, 9, (4,)).astype("int32"),
              rng.standard_normal((1, 2, 2)).astype("float64")]

    def payload(F):
        nds = [F.array(a, dtype=a.dtype) for a in arrays]
        return dict(zip("abc", nds)) if kind == "dict" else nds

    jnd.save(str(tmp_path / "ref.nd"), payload(jnd))
    tnd.save(str(tmp_path / "own.nd"), payload(tnd))
    assert (tmp_path / "ref.nd").read_bytes() == \
        (tmp_path / "own.nd").read_bytes()
    for own, ref in ((tnd.load(str(tmp_path / "ref.nd")),
                      jnd.load(str(tmp_path / "ref.nd"))),
                     (tnd.load(str(tmp_path / "own.nd")),
                      jnd.load(str(tmp_path / "own.nd")))):
        if kind == "dict":
            assert list(own) == list(ref) == list("abc")
            own, ref = list(own.values()), list(ref.values())
        for o, r in zip(own, ref):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o.asnumpy(), r.asnumpy())


def test_naive_engine_and_bulk():
    assert tengine.is_naive() == jengine.is_naive() is False
    tengine.set_naive(True)
    try:
        assert tengine.is_naive()
        np.testing.assert_array_equal((tnd.ones((2,)) * 3).asnumpy(),
                                      [3.0, 3.0])
    finally:
        tengine.set_naive(False)
    with tengine.bulk(4):
        assert tengine._bulk_size[0] == 4
    assert tengine.set_bulk_size(15) == jengine.set_bulk_size(15) == 15


def test_runtime_features():
    feats = truntime.Features()
    assert feats.is_enabled("cpu") and feats.is_enabled("autograd")
    assert not feats.is_enabled("PALLAS") and not feats.is_enabled("TPU")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert feats.is_enabled("TRITON") == (
        importlib.util.find_spec("triton") is not None)
    jfeats = jruntime.Features()
    # the reference's feature names, and TRITON
    assert set(feats) == set(jfeats) | {"TRITON"}
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("NOT_A_FEATURE")
    assert {f.name for f in truntime.feature_list()} == set(feats)


def test_context(monkeypatch):
    assert tmx.cpu() == Context("cpu", 0) and tmx.cpu() != tmx.gpu(0)
    assert str(tmx.gpu(1)) == str(mx.gpu(1)) == "gpu(1)"
    assert hash(tmx.gpu(2)) == hash(Context("gpu", 2))
    assert tmx.cpu().torch_device == torch.device("cpu")
    assert tnd.zeros((1,), ctx=tmx.cpu()).ctx == tmx.cpu()
    with tmx.gpu(3):
        with tmx.cpu(1):
            assert tmx.current_context() == tmx.cpu(1)
        assert tmx.current_context() == tmx.gpu(3)
    assert Context.from_device("cpu") == tmx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.cpu()      # the fixture's scope
    tmx.context._thread_local.stack, saved = [], \
        tmx.context._thread_local.stack
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmx.current_context()
        with pytest.raises(RuntimeError, match="CUDA"):
            tnd.zeros((1,))
        with pytest.raises(RuntimeError, match="CUDA"):
            tmx.gpu(0).torch_device
    finally:
        tmx.context._thread_local.stack = saved
    assert tmx.num_gpus() == 0
