"""The generated families of ``mx.np`` (every function of the
reference's ``_UNARY``, ``_BINARY`` and ``_AXIS_FNS`` lists, each on an
input it takes) and the other cases of ``_np_cases`` named ``a`` to ``e``
(the rest, with ``np.linalg``, are in ``test_torch_numpy_linalg.py``) of
the port against the JAX package's, on the same numpy inputs, on the
CPU. The cases and the tolerances are in ``_np_cases``:
the reference's dtype and shape, values within rtol 1e-5 and atol 1e-6
(exact for integer and boolean results; rtol 1e-4 where marked
``"loose"``)."""
import inspect

import pytest

import mxnet_tpu.numpy as jnp_
import mxnet_tpu_torch as tmx

from _np_cases import B, CASES, U, run_case

tnp = tmx.np
NAMES = tuple(sorted(n for n in CASES if n in U or n in B or (
    not n.startswith("linalg.") and n < "f")))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.mark.parametrize("case", NAMES)
def test_function_matches_reference(case):
    run_case(tnp, case, NAMES)


def test_every_public_function_has_a_case():
    """Each public function of ``mx.np`` is run by a case here or in
    ``test_torch_numpy_linalg.py``, or by a test of
    ``test_torch_numpy.py`` (creation, utilities, ``put_along_axis``)."""
    names = {n for n in dir(jnp_) if not n.startswith("_") and
             inspect.isfunction(getattr(jnp_, n))}
    covered = set(CASES) | {k.rsplit("_", 1)[0] for k in CASES} | {
        "array", "asarray", "ascontiguousarray", "zeros", "ones", "empty",
        "full", "arange", "linspace", "logspace", "eye", "identity", "tri",
        "indices", "hanning", "hamming", "blackman", "bartlett",
        "fromfunction", "frombuffer", "genfromtxt", "set_printoptions",
        "asnumpy", "isscalar", "result_type", "may_share_memory",
        "shares_memory", "allclose", "array_equal", "ndim", "shape", "size",
        "put_along_axis", "copyto", "current_context", "dtype_np",
        "histogram_bin_edges"}
    assert names - covered == set()


