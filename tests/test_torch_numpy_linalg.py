"""The explicit functions of ``mx.np`` (the reference's ``:204-687``:
joins, splits, ``where``, index and set routines, ``pad``, ...) and the
axis functions called with arguments, the cases named ``f`` to ``z`` (the
others are in ``test_torch_numpy_functions.py``), and ``mx.np.linalg`` of
the port against the JAX package's, on the same numpy inputs, on the
CPU. Tolerances as in ``_np_cases``. The
factors of ``svd``, ``eigh``, ``qr``, ``cholesky`` and ``eig`` are held
by reconstruction (within 1e-5 of the input's max; ``eig`` 1e-4) and
each singular or eigen vector ``|<u, u_ref>| = 1`` within 1e-4, since a
solver may return another sign; the values directly (rtol 1e-5)."""
import numpy as onp
import pytest

import mxnet_tpu.numpy as jnp_
import mxnet_tpu_torch as tmx

from _np_cases import B, CASES, HOST, U, _flat, run_case

tnp = tmx.np
NAMES = tuple(sorted(n for n in CASES if n not in U and n not in B and (
    n.startswith("linalg.") or n >= "f")))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.mark.parametrize("case", NAMES)
def test_function_matches_reference(case):
    run_case(tnp, case, NAMES)


@pytest.mark.parametrize("name", ["svd", "eigh", "qr", "cholesky", "eig",
                                  "eigvals"])
def test_linalg_factors(name):
    a = HOST["m"][0] if name != "svd" else HOST["x"][0]
    want = getattr(jnp_.linalg, name)(jnp_.array(a))
    got = getattr(tnp.linalg, name)(tnp.array(a))
    for g, w in zip(_flat(got), _flat(want)):
        assert str(g.dtype) == str(w.dtype) and g.shape == w.shape, name
    g = [o.asnumpy().astype(onp.complex128 if name.startswith("eig") and
                            name != "eigh" else onp.float64)
         for o in _flat(got)]
    w = [o.asnumpy() for o in _flat(want)]
    scale = onp.abs(a).max()
    if name == "svd":
        u, s, vh = g
        onp.testing.assert_allclose(s, w[1], rtol=1e-5)
        onp.testing.assert_allclose(u * s @ vh, a, atol=1e-5 * scale)
        for k in range(s.shape[0]):
            assert abs(abs(u[:, k] @ w[0][:, k]) - 1) < 1e-4
    elif name == "eigh":
        lam, vec = g
        onp.testing.assert_allclose(lam, w[0], rtol=1e-5)
        onp.testing.assert_allclose(vec * lam @ vec.T, a, atol=1e-5 * scale)
        for k in range(lam.shape[0]):
            assert abs(abs(vec[:, k] @ w[1][:, k]) - 1) < 1e-4
    elif name == "qr":
        q, r = g
        onp.testing.assert_allclose(q @ r, a, atol=1e-5 * scale)
        onp.testing.assert_allclose(onp.abs(r), onp.abs(w[1]), atol=1e-4)
    elif name == "cholesky":
        onp.testing.assert_allclose(g[0], w[0], rtol=1e-5, atol=1e-6)
    elif name == "eig":
        lam, vec = g
        onp.testing.assert_allclose(onp.sort_complex(lam),
                                    onp.sort_complex(w[0]), rtol=1e-5)
        onp.testing.assert_allclose(vec * lam @ onp.linalg.inv(vec), a,
                                    atol=1e-4 * scale)
    else:
        onp.testing.assert_allclose(onp.sort_complex(g[0]),
                                    onp.sort_complex(w[0]), rtol=1e-5)


def test_multi_dot_against_numpy():
    """The reference's ``multi_dot`` cannot take its own arrays (it passes
    the list to jnp whole), so the port's is held to numpy's."""
    x, m, y = HOST["x"][0], HOST["m"][0], HOST["y"][0]
    got = tnp.linalg.multi_dot([tnp.array(x.T), tnp.array(m),
                                tnp.array(y)])
    assert str(got.dtype) == "float32"
    onp.testing.assert_allclose(got.asnumpy(), onp.linalg.multi_dot(
        [x.T, m, y]), rtol=1e-4, atol=1e-5)


def test_svd_is_the_npi_svd_layout():
    """``np.linalg.svd`` with no arguments is the ``_npi_svd`` op: the
    reduced ``(u, s, vh)``; asked for, the full factors."""
    a = HOST["x"][0]
    u, s, vh = tnp.linalg.svd(tnp.array(a))
    assert (u.shape, s.shape, vh.shape) == ((3, 3), (3,), (3, 4))
    u2, s2, vh2 = tmx.nd._npi_svd(tmx.nd.array(a))
    onp.testing.assert_array_equal(s.asnumpy(), s2.asnumpy())
    full = tnp.linalg.svd(tnp.array(a), full_matrices=True)
    ref = jnp_.linalg.svd(jnp_.array(a), full_matrices=True)
    assert [tuple(o.shape) for o in full] == [tuple(o.shape) for o in ref]
