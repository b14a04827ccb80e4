"""The port's samplers (``ops/random_ops.py``, ``nn.py``'s four, and
``mx.random``'s) and densities against the JAX package's, on the CPU.

Threefry is not ported (ROADMAP C3), so samplers match the reference in
distribution, not in values. Each sampler draws 200,000 values in both
packages; their mean and variance must be within the bounds that
``tests/test_random_stats.py`` holds the reference to (or bounds of the
same width in standard errors for the distributions that file lacks),
and the continuous ones must pass a Kolmogorov-Smirnov test against
their distribution (p > 1e-3, scipy.special's CDFs and Kolmogorov
distribution). Seeding: ``mx.random.seed`` repeats
a sequence of draws bit for bit, a sampler called twice with the same
bound key words draws the same numbers (what tape replay relies on),
and two calls of a hybridized sampling block draw different numbers.

The ``_random_pdf_*`` densities are deterministic: the port's
``nd.<name>`` within rtol 1e-6 / atol 1e-6 of the reference function's
values (under one ``jax.jit``; they sum ``gammaln`` terms, see
``test_torch_ops_core.py``), and its gradients through the tape within
1e-5 of each gradient's largest |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import special

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jregistry
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon, nd as tnd
from mxnet_tpu_torch.ops import registry as tregistry

N = 200_000
PDF_RTOL, PDF_ATOL = 1e-6, 1e-6
GRAD_TOL = 1e-5
KS_P = 1e-3


class _Dist:
    """A distribution's CDF (scipy.special) for the KS test."""

    def __init__(self, cdf):
        self.cdf = cdf


class stats:  # noqa: N801 - the few scipy.stats distributions used here
    uniform = staticmethod(lambda lo, width: _Dist(
        lambda x: np.clip((x - lo) / width, 0.0, 1.0)))
    norm = staticmethod(lambda loc=0.0, scale=1.0: _Dist(
        lambda x: special.ndtr((x - loc) / scale)))
    gamma = staticmethod(lambda a, scale=1.0: _Dist(
        lambda x: special.gammainc(a, np.maximum(x, 0.0) / scale)))
    expon = staticmethod(lambda scale=1.0: _Dist(
        lambda x: -np.expm1(-np.maximum(x, 0.0) / scale)))


def ks_pvalue(sample, cdf):
    """The one-sample Kolmogorov-Smirnov test's asymptotic p-value
    (scipy's ``kstest`` with ``method="asymp"``), from scipy.special's
    Kolmogorov distribution; ``scipy.stats`` costs 4 s to import."""
    x = np.sort(sample)
    n = x.size
    f = cdf(x)
    d = max((np.arange(1, n + 1) / n - f).max(), (f - np.arange(n) / n).max())
    return float(special.kolmogorov(np.sqrt(n) * d))


def _pkg(which):
    return (jmx, jnd) if which == "ref" else (tmx, tnd)


def _flat(out):
    return out.asnumpy().astype(np.float64).ravel()


def _rows(out):
    return out.asnumpy().astype(np.float64)


# (id, draw(mx, nd) -> NDArray, mean, var, (mean bound, var bound),
#  scipy distribution for KS or None)
SAMPLERS = [
    ("_random_uniform", lambda mx, nd: nd._random_uniform(
        low=-2.0, high=4.0, shape=(N,)), 1.0, 3.0, (0.02, 0.05),
     stats.uniform(-2.0, 6.0)),
    ("_random_normal", lambda mx, nd: nd._random_normal(
        loc=1.5, scale=2.0, shape=(N,)), 1.5, 4.0, (0.02, 0.08),
     stats.norm(1.5, 2.0)),
    ("_random_gamma", lambda mx, nd: nd._random_gamma(
        alpha=3.0, beta=2.0, shape=(N,)), 6.0, 12.0, (0.06, 0.4),
     stats.gamma(3.0, scale=2.0)),
    ("_random_exponential", lambda mx, nd: nd._random_exponential(
        lam=0.4, shape=(N,)), 2.5, 6.25, (0.03, 0.15),
     stats.expon(scale=2.5)),
    ("_random_poisson", lambda mx, nd: nd._random_poisson(
        lam=4.0, shape=(N,)), 4.0, 4.0, (0.04, 0.15), None),
    ("_random_negative_binomial", lambda mx, nd: nd._random_negative_binomial(
        k=5, p=0.4, shape=(N,)), 7.5, 18.75, (0.12, 0.8), None),
    ("_random_gnb", lambda mx, nd: nd._random_generalized_negative_binomial(
        mu=2.0, alpha=0.5, shape=(N,)), 2.0, 4.0, (0.04, 0.2), None),
    ("_random_randint", lambda mx, nd: nd._random_randint(
        low=3, high=9, shape=(N,)), 5.5, 35 / 12, (0.02, 0.05), None),
    ("_random_uniform_like", lambda mx, nd: nd._random_uniform_like(
        nd.zeros((N,)), low=-2.0, high=4.0), 1.0, 3.0, (0.02, 0.05),
     stats.uniform(-2.0, 6.0)),
    ("_random_normal_like", lambda mx, nd: nd._random_normal_like(
        nd.zeros((N,)), loc=1.5, scale=2.0), 1.5, 4.0, (0.02, 0.08),
     stats.norm(1.5, 2.0)),
    ("_random_gamma_like", lambda mx, nd: nd._random_gamma_like(
        nd.zeros((N,)), alpha=3.0, beta=2.0), 6.0, 12.0, (0.06, 0.4),
     stats.gamma(3.0, scale=2.0)),
    ("_random_exponential_like", lambda mx, nd: nd._random_exponential_like(
        nd.zeros((N,)), lam=0.4), 2.5, 6.25, (0.03, 0.15),
     stats.expon(scale=2.5)),
    ("_random_poisson_like", lambda mx, nd: nd._random_poisson_like(
        nd.zeros((N,)), lam=4.0), 4.0, 4.0, (0.04, 0.15), None),
    ("_random_nb_like", lambda mx, nd: nd._random_negative_binomial_like(
        nd.zeros((N,)), k=5, p=0.4), 7.5, 18.75, (0.12, 0.8), None),
    ("_random_gnb_like",
     lambda mx, nd: nd._random_generalized_negative_binomial_like(
         nd.zeros((N,)), mu=2.0, alpha=0.5), 2.0, 4.0, (0.04, 0.2), None),
    ("random.uniform", lambda mx, nd: mx.random.uniform(
        -2.0, 4.0, shape=(N,)), 1.0, 3.0, (0.02, 0.05),
     stats.uniform(-2.0, 6.0)),
    ("random.normal", lambda mx, nd: mx.random.normal(
        1.5, 2.0, shape=(N,)), 1.5, 4.0, (0.02, 0.08), stats.norm(1.5, 2.0)),
    ("random.randn", lambda mx, nd: mx.random.randn(N // 2, 2), 0.0, 1.0,
     (0.02, 0.02), stats.norm()),
    ("random.gamma", lambda mx, nd: mx.random.gamma(
        3.0, 2.0, shape=(N,)), 6.0, 12.0, (0.06, 0.4),
     stats.gamma(3.0, scale=2.0)),
    ("random.exponential", lambda mx, nd: mx.random.exponential(
        2.5, shape=(N,)), 2.5, 6.25, (0.03, 0.15), stats.expon(scale=2.5)),
    ("random.poisson", lambda mx, nd: mx.random.poisson(
        4.0, shape=(N,)), 4.0, 4.0, (0.04, 0.15), None),
    ("random.negative_binomial", lambda mx, nd: mx.random.negative_binomial(
        5, 0.4, shape=(N,)), 7.5, 18.75, (0.12, 0.8), None),
    ("random.gnb", lambda mx, nd: mx.random.generalized_negative_binomial(
        2.0, 0.5, shape=(N,)), 2.0, 4.0, (0.04, 0.2), None),
    ("random.randint", lambda mx, nd: mx.random.randint(
        3, 9, shape=(N,)), 5.5, 35 / 12, (0.02, 0.05), None),
    ("random.bernoulli", lambda mx, nd: mx.random.bernoulli(
        0.3, shape=(N,)), 0.3, 0.21, (0.005, 0.005), None),
]


# the reference runs each distinct sampler once (its ``*_like`` and
# ``mx.random`` forms call the same jax samplers); the port runs them all
SAMPLER_RUNS = [(c, w) for c in SAMPLERS for w in ("port", "ref")
                if w == "port" or not c[0].endswith("_like")
                and c[0] not in ("random.uniform", "random.normal",
                                 "random.randn", "random.gamma",
                                 "random.exponential", "random.poisson",
                                 "random.negative_binomial", "random.gnb",
                                 "random.randint")]


@pytest.mark.parametrize("case,which", SAMPLER_RUNS,
                         ids=["%s-%s" % (c[0], w) for c, w in SAMPLER_RUNS])
def test_sampler_moments(case, which):
    _, draw, mean, var, (bm, bv), dist = case
    mx, nd = _pkg(which)
    with mx.cpu():
        mx.random.seed(7)
        out = draw(mx, nd)
    a = _flat(out)
    assert a.size == N
    assert abs(a.mean() - mean) < bm and abs(a.var() - var) < bv, \
        (a.mean(), a.var())
    if dist is not None:
        assert ks_pvalue(a[:20000], dist.cdf) > KS_P


# per-row parameters: (id, draw, [(mean, var) per row], (bounds))
PER_ROW = [
    ("_sample_uniform", lambda mx, nd: nd._sample_uniform(
        nd.array([-2.0, 0.0]), nd.array([4.0, 1.0]), shape=(N // 2,)),
     [(1.0, 3.0), (0.5, 1 / 12)], (0.03, 0.07)),
    ("_sample_normal", lambda mx, nd: nd._sample_normal(
        nd.array([1.5, -1.0]), nd.array([2.0, 0.5]), shape=(N // 2,)),
     [(1.5, 4.0), (-1.0, 0.25)], (0.03, 0.1)),
    ("_sample_exponential", lambda mx, nd: nd._sample_exponential(
        nd.array([0.4, 2.0]), shape=(N // 2,)),
     [(2.5, 6.25), (0.5, 0.25)], (0.05, 0.2)),
    ("_sample_gamma", lambda mx, nd: nd._sample_gamma(
        nd.array([3.0, 1.0]), nd.array([2.0, 1.0]), shape=(N // 2,)),
     [(6.0, 12.0), (1.0, 1.0)], (0.09, 0.6)),
    ("_sample_poisson", lambda mx, nd: nd._sample_poisson(
        nd.array([4.0, 1.0]), shape=(N // 2,)),
     [(4.0, 4.0), (1.0, 1.0)], (0.06, 0.2)),
    ("_sample_negative_binomial", lambda mx, nd: nd._sample_negative_binomial(
        nd.array([5.0, 2.0]), nd.array([0.4, 0.5]), shape=(N // 2,)),
     [(7.5, 18.75), (2.0, 4.0)], (0.17, 1.1)),
    ("_sample_gnb", lambda mx, nd: nd._sample_generalized_negative_binomial(
        nd.array([2.0, 1.0]), nd.array([0.5, 1.0]), shape=(N // 2,)),
     [(2.0, 4.0), (1.0, 2.0)], (0.06, 0.3)),
]


# the reference's per-row samplers run its fixed-parameter ones' jax
# samplers (tested above) on parameter arrays: it runs the two whose draws
# are arithmetic on those arrays
PER_ROW_RUNS = [(c, w) for c in PER_ROW for w in ("port", "ref")
                if w == "port"
                or c[0] in ("_sample_uniform", "_sample_normal")]


@pytest.mark.parametrize("case,which", PER_ROW_RUNS,
                         ids=["%s-%s" % (c[0], w) for c, w in PER_ROW_RUNS])
def test_per_row_sampler_moments(case, which):
    _, draw, theory, (bm, bv) = case
    mx, nd = _pkg(which)
    with mx.cpu():
        mx.random.seed(11)
        rows = _rows(draw(mx, nd))
    assert rows.shape == (2, N // 2)
    for row, (mean, var) in zip(rows, theory):
        assert abs(row.mean() - mean) < bm and abs(row.var() - var) < bv, \
            (row.mean(), row.var())


@pytest.mark.parametrize("which", ["port", "ref"])
def test_multinomial_frequencies(which):
    mx, nd = _pkg(which)
    with mx.cpu():
        mx.random.seed(3)
        probs = nd.array(np.array([[0.2, 0.3, 0.5]], "float32"))
        s, lp = nd._sample_multinomial(probs, shape=(N,), get_prob=True)
        v = mx.random.multinomial(nd.array([0.2, 0.3, 0.5]), shape=(N,))
    s, lp = s.asnumpy(), lp.asnumpy()
    assert s.dtype == np.int32 and s.shape == (1, N) and lp.shape == (1, N)
    for draws in (s.ravel(), v.asnumpy().ravel()):
        freq = np.bincount(draws.astype(int), minlength=3) / N
        np.testing.assert_allclose(freq, [0.2, 0.3, 0.5], atol=0.01)
    np.testing.assert_allclose(lp, np.log([0.2, 0.3, 0.5])[s], rtol=1e-6)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_unique_zipfian_counts(which):
    mx, nd = _pkg(which)
    with mx.cpu():
        mx.random.seed(5)
        draws, counts = nd._sample_unique_zipfian(range_max=1000,
                                                  shape=(4, 256))
    d, c = draws.asnumpy(), counts.asnumpy()
    assert d.dtype == np.int64 and c.dtype == np.int64
    assert d.shape == (4, 256) and c.shape == (4, 1)
    assert d.min() >= 0 and d.max() < 1000
    assert [len(np.unique(r)) for r in d] == c.ravel().tolist()
    # log-uniform: P(draw < 31) = log(32) / log(1000) ~ 0.50
    assert abs((d < 31).mean() - np.log(32) / np.log(1000)) < 0.05


# ---- seeding ---------------------------------------------------------------


def _seq(which, s):
    """Draws of samplers the moment tests above ran at these shapes (the
    reference's compiled programs are cached by then)."""
    mx, nd = _pkg(which)
    with mx.cpu():
        mx.random.seed(s)
        return [x.asnumpy() for x in (
            nd._random_normal(loc=1.5, scale=2.0, shape=(N,)),
            nd._random_uniform(low=-2.0, high=4.0, shape=(N,)),
            nd._random_gamma(alpha=3.0, beta=2.0, shape=(N,)),
            nd._random_normal(loc=1.5, scale=2.0, shape=(N,)))]


@pytest.mark.parametrize("which", ["port", "ref"])
def test_seed_repeats_a_sequence_bitwise(which):
    a, b, c = _seq(which, 42), _seq(which, 42), _seq(which, 43)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))


def test_bound_key_repeats_the_draw():
    """A sampler is a function of its key words: the kwargs that
    ``invoke`` bound (and a tape records) replay to the same numbers."""
    op = tregistry.get_op("_random_normal")
    with tmx.cpu():
        key = (123, 456)
        a = op.fn(shape=(6,), key=key)
        b = op.fn(shape=(6,), key=key)
        c = op.fn(shape=(6,), key=(123, 457))
    assert a.device.type == "cpu"
    assert np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())


class _Noisy(gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x + F._random_normal_like(x)


def test_hybridized_sampler_draws_anew_each_call():
    with tmx.cpu():
        net = _Noisy()
        net.hybridize()
        x = tnd.zeros((4, 3))
        tmx.random.seed(9)
        a, b = net(x).asnumpy(), net(x).asnumpy()
        tmx.random.seed(9)
        a2, b2 = net(x).asnumpy(), net(x).asnumpy()
    assert not np.array_equal(a, b)
    assert np.array_equal(a, a2) and np.array_equal(b, b2)


# ---- densities -------------------------------------------------------------


def _pdf_inputs():
    r = np.random.default_rng(0)
    f = np.float32
    pos = lambda *s: r.uniform(0.5, 3.0, s).astype(f)  # noqa: E731
    cnt = lambda *s: r.integers(0, 8, s).astype(f)     # noqa: E731
    simplex = r.dirichlet([1.0, 2.0, 3.0], (2, 4)).astype(f)
    return [
        ("uniform", [r.uniform(0, 1, (2, 5)).astype(f),
                     np.array([-1.0, 0.0], f), np.array([2.0, 1.5], f)]),
        ("normal", [r.standard_normal((2, 5)).astype(f),
                    np.array([0.3, -1.0], f), pos(2)]),
        ("gamma", [pos(2, 5), pos(2), pos(2)]),
        ("exponential", [pos(2, 5), pos(2)]),
        ("poisson", [cnt(2, 5), pos(2)]),
        ("negative_binomial", [cnt(2, 5), pos(2),
                               np.array([0.3, 0.6], f)]),
        ("generalized_negative_binomial", [cnt(2, 5), pos(2), pos(2)]),
        ("dirichlet", [simplex, pos(2, 3)]),
    ]


PDFS = _pdf_inputs()


@functools.lru_cache(maxsize=None)
def _ref_pdf(dist):
    """The reference density's values and log values, under one jit."""
    fn = jregistry.get_op("_random_pdf_" + dist).fn
    args = dict(PDFS)[dist]
    both = jax.jit(lambda *a: (fn(*a, is_log=False), fn(*a, is_log=True)))(
        *[jnp.asarray(a) for a in args])
    return {False: np.asarray(both[0]), True: np.asarray(both[1])}


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("case", PDFS, ids=[c[0] for c in PDFS])
def test_pdf_matches_reference(case, is_log):
    dist, args = case
    name = "_random_pdf_" + dist
    with tmx.cpu():
        own = getattr(tnd, name)(*[tnd.array(a) for a in args],
                                 is_log=is_log).asnumpy()
    ref = _ref_pdf(dist)[is_log]
    assert own.dtype == ref.dtype and own.shape == ref.shape
    np.testing.assert_allclose(own, ref, rtol=PDF_RTOL, atol=PDF_ATOL)
    assert tregistry.get_op("random_pdf_" + dist) is tregistry.get_op(name)


@pytest.mark.parametrize("case", PDFS, ids=[c[0] for c in PDFS])
def test_pdf_gradient_matches_reference(case):
    dist, args = case
    name = "_random_pdf_" + dist
    with tmx.cpu():
        xs = [tnd.array(a) for a in args]
        for x in xs:
            x.attach_grad()
        with tag.record():
            loss = getattr(tnd, name)(*xs, is_log=True).sum()
        loss.backward()
        own = [x.grad.asnumpy() for x in xs]
    fn = jregistry.get_op(name).fn
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a, is_log=True)),
                             argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    for o, g in zip(own, grads):
        g = np.asarray(g)
        assert np.abs(o - g).max() <= GRAD_TOL * max(np.abs(g).max(), 1e-30)


SAMPLER_ALIASES = {
    "random_uniform": "_random_uniform", "uniform": "_random_uniform",
    "_npi_uniform": "_random_uniform", "random_normal": "_random_normal",
    "normal": "_random_normal", "_npi_normal": "_random_normal",
    "random_exponential": "_random_exponential",
    "random_gamma": "_random_gamma", "random_poisson": "_random_poisson",
    "random_negative_binomial": "_random_negative_binomial",
    "random_generalized_negative_binomial":
        "_random_generalized_negative_binomial",
    "random_randint": "_random_randint",
    "_npi_random_randint": "_random_randint",
    "sample_uniform": "_sample_uniform", "sample_normal": "_sample_normal",
    "sample_exponential": "_sample_exponential",
    "sample_gamma": "_sample_gamma", "sample_poisson": "_sample_poisson",
    "sample_negative_binomial": "_sample_negative_binomial",
    "sample_generalized_negative_binomial":
        "_sample_generalized_negative_binomial",
    "sample_multinomial": "_sample_multinomial",
    "sample_unique_zipfian": "_sample_unique_zipfian",
}


@pytest.mark.parametrize("alias", sorted(SAMPLER_ALIASES))
def test_sampler_alias_resolves_as_reference(alias):
    primary = SAMPLER_ALIASES[alias]
    assert jregistry.get_op(alias).name == primary
    assert tregistry.get_op(alias) is tregistry.get_op(primary)


def test_nd_random_and_linalg_namespaces():
    assert tnd.random.normal is tmx.random.normal
    assert tnd.linalg.gemm2 is tregistry.get_op("linalg_gemm2")
    assert tnd.linalg.potrf is tregistry.get_op("linalg_potrf")
    with pytest.raises(AttributeError):
        tnd.linalg.no_such_op
