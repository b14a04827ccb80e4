"""``ops/linalg_extra.py`` of the port against the JAX package's, on the
same numpy inputs (batches of 4 x 4 and 3 x 5 matrices), on the CPU.

Values within rtol 1e-5 and atol 1e-6 of each output's largest value
(``det``, ``slogdet``, ``inverse``, ``potri``, ``trmm``, ``syevd``'s
eigenvalues; exact for ``makediag``, ``maketrian`` and
``extracttrian``). The factors of ``gelqf`` and ``syevd`` are held by
reconstruction (``L Q = A`` and ``U^T diag(w) U = A`` within 1e-5 of the
input's max, ``Q`` and ``U`` orthonormal) and each row against the
reference's up to its sign (``|<q, q_ref>| = 1`` within 1e-4), since
another LAPACK may return other signs.
"""
import jax.numpy as jjnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

from _parity import compare, reference_results, result

RNG = onp.random.default_rng(41)
F = onp.float32
_m = RNG.standard_normal((2, 4, 4)).astype(F)
SPD = (_m @ _m.transpose(0, 2, 1) + 4 * onp.eye(4)).astype(F)
LOW = onp.linalg.cholesky(SPD.astype(onp.float64)).astype(F)
A = RNG.standard_normal((2, 4, 4)).astype(F)
B = RNG.standard_normal((2, 4, 3)).astype(F)
WIDE = RNG.standard_normal((2, 3, 5)).astype(F)
VEC = RNG.standard_normal((2, 6)).astype(F)

CASES = {
    "det": ("linalg_det", [A], {}),
    "_linalg_det": ("_linalg_det", [SPD], {}),
    "det_alias": ("det", [A[0]], {}),
    "slogdet": ("linalg_slogdet", [A], {}),
    "inverse": ("linalg_inverse", [SPD], {}),
    "inverse_alias": ("inverse", [A], {}),
    "_npi_inv": ("_npi_inv", [SPD], {}),
    "potri": ("linalg_potri", [LOW], {}),
    "trmm": ("linalg_trmm", [A, B], {"alpha": 0.5}),
    "trmm_upper_t": ("_linalg_trmm", [A, B], {"lower": False,
                                              "transpose": True}),
    "trmm_right": ("linalg_trmm", [A, B.transpose(0, 2, 1).copy()],
                   {"rightside": True}),
    "makediag": ("linalg_makediag", [VEC], {}),
    "makediag_offset": ("_linalg_makediag", [VEC], {"offset": -2}),
    "extracttrian": ("linalg_extracttrian", [A], {}),
    "extracttrian_upper": ("_linalg_extracttrian", [A], {"lower": False}),
    "extracttrian_offset": ("linalg_extracttrian", [A], {"offset": 1}),
    "extracttrian_neg": ("linalg_extracttrian", [A], {"offset": -2}),
    "maketrian": ("linalg_maketrian", [VEC], {}),
    "maketrian_upper": ("_linalg_maketrian", [VEC], {"lower": False}),
    "maketrian_offset": ("linalg_maketrian", [VEC], {"offset": 1}),
    "maketrian_neg": ("linalg_maketrian", [VEC[:, :3]], {"offset": -1}),
}


@pytest.fixture(scope="module")
def reference():
    return reference_results({
        c: (lambda c=c: jreg.get_op(CASES[c][0]).fn(
            *[jjnp.asarray(a) for a in CASES[c][1]], **CASES[c][2]))
        for c in CASES})


@pytest.mark.parametrize("case", sorted(CASES))
def test_values_match_reference(case, reference):
    name, arrays, kw = CASES[case]
    got = treg.get_op(name).fn(*[torch.from_numpy(a.copy()) for a in arrays],
                               **kw)
    want = result(reference, case)
    for k, (g, w) in enumerate(zip(got if isinstance(got, tuple) else [got],
                                   want if isinstance(want, list)
                                   else [want])):
        scale = max(float(onp.abs(onp.asarray(w)).max()), 1e-30)
        compare(g, w, rtol=1e-5, atol=1e-6 * scale, what="%s[%d]" % (case,
                                                                     k))


def _rows_match(got, want):
    """Each row of ``got`` is the reference's row up to its sign."""
    dots = onp.abs((got * want).sum(-1))
    onp.testing.assert_allclose(dots, onp.ones_like(dots), atol=1e-4)


@pytest.mark.parametrize("name", ["linalg_gelqf", "_linalg_gelqf"])
def test_gelqf_factors(name):
    l, q = treg.get_op(name).fn(torch.from_numpy(WIDE))
    rl, rq = (onp.asarray(o) for o in jreg.get_op(name).fn(
        jjnp.asarray(WIDE)))
    assert l.shape == rl.shape and q.shape == rq.shape
    assert l.dtype == torch.float32 and q.dtype == torch.float32
    l, q = l.numpy(), q.numpy()
    scale = onp.abs(WIDE).max()
    onp.testing.assert_allclose(l @ q, WIDE, atol=1e-5 * scale)
    onp.testing.assert_allclose(q @ q.transpose(0, 2, 1),
                                onp.broadcast_to(onp.eye(3), (2, 3, 3)),
                                atol=1e-5)
    assert onp.allclose(onp.triu(l, 1), 0)
    _rows_match(q, rq)
    onp.testing.assert_allclose(onp.abs(l), onp.abs(rl), rtol=1e-4,
                                atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["linalg_syevd", "_linalg_syevd"])
def test_syevd_factors(name):
    u, w = treg.get_op(name).fn(torch.from_numpy(SPD))
    ru, rw = (onp.asarray(o) for o in jreg.get_op(name).fn(
        jjnp.asarray(SPD)))
    u, w = u.numpy(), w.numpy()
    onp.testing.assert_allclose(w, rw, rtol=1e-5)
    scale = onp.abs(SPD).max()
    recon = onp.einsum("bki,bk,bkj->bij", u, w, u)
    onp.testing.assert_allclose(recon, SPD, atol=1e-5 * scale)
    _rows_match(u, ru)
