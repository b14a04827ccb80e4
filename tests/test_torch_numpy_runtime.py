"""The ``mx.np`` array at run time, on the CPU: its operators' dtypes on
the grid of ``test_torch_numpy.py`` (the reference's NDArray ops under
jnp's rules, read with ``jax.eval_shape``); the ``ndarray`` subclass
through in-place ops, slicing, ``attach_grad``, a ``HybridBlock`` and
``npx.save``/``npx.load``; gradients through ``mx.np`` (the card phase's
MLM loss at a small width: bitwise to the same expression in ``nd`` ops,
within 1e-6 relative of ``jax.grad`` of the reference's); ``np.random``
and ``npx.bernoulli`` in distribution (the moments' bounds of
``tests/test_random_stats.py``'s kind) and under a seed, in the
reference's dtypes (threefry is not ported, so not its values); and the
value-dependent-shape functions' refusal inside a CUDA-graph capture.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jjnp
import ml_dtypes
import mxnet_tpu.numpy as jnp_

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

tnp = tmx.np
tnpx = tmx.npx


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


DTYPES = ["bool", "uint8", "int8", "int32", "int64", "float16", "bfloat16",
          "float32", "float64"]
SCALARS = {"pyb": True, "pyi": 2, "pyf": 1.5}


def _host(d, n=6, seed=0):
    rng = onp.random.default_rng(seed)
    lo = 0 if d in ("bool", "uint8") else -3
    v = rng.integers(lo, 4, n).astype(onp.float64)
    return v.astype(ml_dtypes.bfloat16 if d == "bfloat16" else d)


def _spec(d):
    return jax.ShapeDtypeStruct((6,), jjnp.dtype(d))


OPERATORS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
    "lt": lambda a, b: a < b, "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b, "rsub": lambda a, b: b - a,
    "rdiv": lambda a, b: b / a,
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_dtype_grid_operators(op):
    """The ``mx.np`` array's operators: the reference's NDArray ops under
    jnp's rules (a comparison is 1/0 in the left operand's float dtype)."""
    f = OPERATORS[op]
    for d1 in DTYPES:
        for d2 in DTYPES + list(SCALARS):
            s = SCALARS.get(d2)
            if op.startswith("r") and s is None:
                continue

            def ref(x, y=None):
                return f(jnp_.ndarray(x), s if y is None
                         else jnp_.ndarray(y))._data
            try:
                want = jax.eval_shape(ref, _spec(d1),
                                      None if s is not None else _spec(d2))
            except (TypeError, ValueError):
                continue
            b = s if s is not None else tnp.array(_host(d2), dtype=d2)
            got = f(tnp.array(_host(d1, seed=4), dtype=d1), b)
            assert str(got.dtype) == str(want.dtype), (op, d1, d2)


def test_dtype_grid_neg_abs():
    for d in DTYPES:
        for f in (lambda a: -a, abs):
            try:
                want = jax.eval_shape(lambda x: f(jnp_.ndarray(x))._data,
                                      _spec(d))
            except (TypeError, ValueError):
                continue
            got = f(tnp.array(_host(d), dtype=d))
            assert str(got.dtype) == str(want.dtype), d


def test_the_subclass_survives_ndarray_operations(tmp_path):
    x = onp.random.default_rng(5).standard_normal((4, 3)).astype("float32")
    a = tnp.array(x)
    a += 1
    assert isinstance(a, tnp.ndarray)
    assert isinstance(a[1:3], tnp.ndarray) and a[1:3].shape == (2, 3)
    assert isinstance(a.T, tnp.ndarray) and a.T.shape == (3, 4)
    nd_view = a.as_nd_ndarray()
    assert type(nd_view) is tnd.NDArray and nd_view._data is a._data
    back = nd_view.as_np_ndarray()
    assert isinstance(back, tnp.ndarray) and back._data is a._data
    a.attach_grad()
    with tag.record():
        loss = tnp.sum(a * a)
    loss.backward()
    onp.testing.assert_allclose(a.grad.asnumpy(), 2 * (x + 1), rtol=1e-6)
    p = str(tmp_path / "np.params")
    tnpx.save(p, {"a": a})
    got = tnpx.load(p)
    assert isinstance(got["a"], tnp.ndarray)
    onp.testing.assert_array_equal(got["a"].asnumpy(), a.asnumpy())
    dense = tmx.gluon.nn.Dense(2, in_units=3)
    dense.initialize()
    out = dense(a)
    assert out.shape == (4, 2)


def test_mlm_loss_gradient_through_np():
    """The MLM loss of the card phase at a small width: ``np.dot`` with
    the embedding's transpose, ``npx.log_softmax``, ``npx.pick`` and
    ``np.mean``; its gradient equals the same expression in ``nd`` ops
    bitwise and ``jax.grad`` of the reference's within 1e-6 relative."""
    rng = onp.random.default_rng(9)
    h = rng.standard_normal((20, 16)).astype("float32")
    emb = (0.1 * rng.standard_normal((50, 16))).astype("float32")
    lab = rng.integers(0, 50, 20).astype("float32")

    def run_np(hh, ee, ll):
        logp = tnpx.log_softmax(tnp.dot(hh, ee.T))
        return -tnp.mean(tnpx.pick(logp, ll))

    def run_nd(hh, ee, ll):
        logp = tnd.log_softmax(tnd.dot(hh, ee, transpose_b=True))
        return -tnd.mean(tnd.pick(logp, ll))

    grads = []
    for mod, run in ((tnp, run_np), (tnd, run_nd)):
        hh, ee = mod.array(h), mod.array(emb)
        ll = mod.array(lab)
        hh.attach_grad()
        ee.attach_grad()
        with tag.record():
            loss = run(hh, ee, ll)
        loss.backward()
        grads.append((loss.asnumpy(), hh.grad.asnumpy(), ee.grad.asnumpy()))
    for a, b in zip(*grads):
        onp.testing.assert_array_equal(a, b)

    def ref(hv, ev):
        logp = jax.nn.log_softmax(hv @ ev.T)
        return -jjnp.mean(jjnp.take_along_axis(
            logp, jjnp.asarray(lab, "int32")[:, None], 1))
    want = jax.grad(ref, argnums=(0, 1))(h, emb)
    for g, w in zip(grads[0][1:], want):
        onp.testing.assert_allclose(g, onp.asarray(w), rtol=1e-6,
                                    atol=1e-6 * onp.abs(w).max())


# ---- np.random -------------------------------------------------------------

SAMPLERS = {  # draw, dtype, mean, variance, bounds (of the mean, the var)
    "uniform": (lambda r: r.uniform(-2.0, 4.0, size=(20000,)), "float32",
                1.0, 3.0, (0.05, 0.1)),
    "normal": (lambda r: r.normal(1.5, 2.0, size=(20000,)), "float32", 1.5,
               4.0, (0.05, 0.15)),
    "randn": (lambda r: r.randn(20000), "float32", 0.0, 1.0, (0.04, 0.06)),
    "rand": (lambda r: r.rand(20000), "float32", 0.5, 1 / 12,
             (0.01, 0.01)),
    "randint": (lambda r: r.randint(3, 9, size=(20000,)), "int64", 5.5,
                35 / 12, (0.05, 0.1)),
    "gamma": (lambda r: r.gamma(3.0, 2.0, size=(20000,)), "float32", 6.0,
              12.0, (0.15, 0.8)),
    "beta": (lambda r: r.beta(2.0, 3.0, size=(20000,)), "float32", 0.4,
             0.04, (0.01, 0.005)),
    "exponential": (lambda r: r.exponential(2.5, size=(20000,)), "float32",
                    2.5, 6.25, (0.08, 0.5)),
    "poisson": (lambda r: r.poisson(4.0, size=(20000,)), "int64", 4.0, 4.0,
                (0.08, 0.3)),
    "logistic": (lambda r: r.logistic(1.0, 2.0, size=(20000,)), "float64",
                 1.0, 4 * onp.pi ** 2 / 3, (0.1, 0.8)),
    "gumbel": (lambda r: r.gumbel(0.5, 1.0, size=(20000,)), "float64",
               0.5 + onp.euler_gamma, onp.pi ** 2 / 6, (0.05, 0.15)),
    "lognormal": (lambda r: r.lognormal(0.0, 0.5, size=(20000,)),
                  "float64", onp.exp(0.125),
                  (onp.exp(0.25) - 1) * onp.exp(0.25), (0.02, 0.05)),
    "choice": (lambda r: r.choice(10, size=(20000,)), "int64", 4.5, 8.25,
               (0.1, 0.3)),
    "choice_p": (lambda r: r.choice(3, size=(20000,), p=onp.array(
        [0.2, 0.3, 0.5])), "int64", 1.3, 0.61, (0.03, 0.05)),
    "permutation": (lambda r: r.permutation(20000), "int64", 9999.5,
                    (20000 ** 2 - 1) / 12, (1e-6, 1e-3)),
}


def test_sampler_dtypes_are_the_references():
    """The dtypes ``SAMPLERS`` holds the port to are the reference's (one
    small draw of each family; the threefry compiles are costly)."""
    for name in ("uniform", "logistic"):
        draw, dtype = SAMPLERS[name][:2]
        small = {"uniform": lambda r: r.uniform(size=(2,)),
                 "logistic": lambda r: r.logistic(size=(2,))}[name]
        assert str(small(jnp_.random).dtype) == dtype, name


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_in_distribution_and_seeded(name):
    """Moments within bounds (of ``tests/test_random_stats.py``'s kind)
    and a seed repeats the draw; threefry is not ported, so the values
    are not the reference's."""
    draw, dtype, mean, var, (bm, bv) = SAMPLERS[name]
    tnp.random.seed(11)
    got = draw(tnp.random)
    assert str(got.dtype) == dtype and got.shape == (20000,)
    v = got.asnumpy().astype(onp.float64)
    assert abs(v.mean() - mean) < bm and abs(v.var() - var) < bv * max(
        1.0, var), (v.mean(), v.var())
    tnp.random.seed(11)
    onp.testing.assert_array_equal(draw(tnp.random).asnumpy(),
                                   got.asnumpy())


def test_multinomial_shuffle_and_npx_bernoulli():
    tnp.random.seed(3)
    c = tnp.random.multinomial(1000, [0.2, 0.3, 0.5], size=(50,))
    assert str(c.dtype) == "int64" and c.shape == (50, 3)
    freq = c.asnumpy().sum(0) / 50000.0
    onp.testing.assert_allclose(freq, [0.2, 0.3, 0.5], atol=0.01)
    x = tnp.arange(100)
    before = x._data
    tnp.random.shuffle(x)
    assert x._data is not before
    assert sorted(x.asnumpy().tolist()) == list(range(100))
    b = tnpx.bernoulli(prob=0.3, size=(20000,))
    assert str(b.dtype) == "float32"
    assert abs(b.asnumpy().mean() - 0.3) < 0.02
    b2 = tnpx.bernoulli(logit=tnp.array([0.0, 100.0, -100.0]))
    onp.testing.assert_array_equal(b2.asnumpy()[1:], [1.0, 0.0])
    tnpx.seed(4)
    u = tnp.random.uniform(size=5)
    tnpx.seed(4)
    onp.testing.assert_array_equal(tnp.random.uniform(size=5).asnumpy(),
                                   u.asnumpy())


# ---- value-dependent shapes inside a capture --------------------------------

@pytest.mark.parametrize("call", [
    lambda: tnp.nonzero(tnp.array([1.0, 0.0, 2.0])),
    lambda: tnp.unique(tnp.array([1.0, 1.0, 2.0])),
    lambda: tnp.argwhere(tnp.array([1.0, 0.0])),
    lambda: tnp.array([1.0, 2.0])[tnp.array([True, False])],
    lambda: tnd.nonzero(tnd.array([1.0, 0.0])),
    lambda: tnd._npi_unique(tnd.array([1.0, 0.0]))],
    ids=["nonzero", "unique", "argwhere", "bool_index", "nd.nonzero",
         "nd._npi_unique"])
def test_value_dependent_shapes_refuse_a_capture(call, monkeypatch):
    """Inside a CUDA-graph capture (simulated: the capture check made to
    answer yes) the op raises naming itself; eagerly it runs."""
    call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(tmx.MXNetError, match="value-dependent"):
        call()
