"""``ops/spatial_ops.py`` of the port against the JAX package on the CPU:
``GridGenerator``, ``BilinearSampler``, ``SpatialTransformer``, ``Crop``,
``SVMOutput``, ``Correlation``, ``fft``/``ifft``, ``count_sketch`` and
``SyncBatchNorm``, on the same seeded numpy arrays (``_op_cases``).

Tolerances: ``Crop`` bitwise; every float op within 1e-5 of its output's
largest magnitude in float32, and its gradients (``jax.grad`` against
autograd, the same seeded cotangents) alike; ``SVMOutput``'s injected
hinge gradients bitwise. Sampling grids stay off the integer lattice by
at least 1e-3 pixel, where the bilinear weights' slopes change.
"""
import numpy as onp
import pytest

from _op_cases import Case, check, reference_thunks
from _parity import reference_results, result

RNG = onp.random.default_rng(17)


def _f(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(onp.float32)


def _off_lattice(g, size):
    """Normalised coordinates whose pixel positions keep 1e-3 from an
    integer (the bilinear weights' kinks)."""
    px = (g + 1.0) * (size - 1) / 2.0
    frac = px - onp.floor(px)
    px = onp.where(onp.abs(frac - 0.5) > 0.499, onp.floor(px) + 0.25, px)
    return (px * 2.0 / (size - 1) - 1.0).astype(onp.float32)


IMG = _f(2, 3, 7, 9)
THETA = onp.array([[0.9, 0.1, 0.05, -0.2, 1.1, -0.1],
                   [1.2, -0.3, 0.2, 0.25, 0.8, 0.1]], onp.float32)
GRID = onp.stack([_off_lattice(RNG.uniform(-1.2, 1.2, (2, 5, 6)), 9),
                  _off_lattice(RNG.uniform(-1.2, 1.2, (2, 5, 6)), 7)],
                 axis=1).astype(onp.float32)
FLOW = _f(2, 2, 5, 6, scale=1.5)
SCORES = _f(6, 4)
LABELS = onp.array([0, 3, 1, 1, 2, 0], onp.float32)
C1, C2 = _f(2, 3, 8, 9), _f(2, 3, 8, 9)
SIG = _f(3, 16)
SK_H = RNG.integers(0, 6, 10).astype(onp.float32)
SK_S = onp.sign(_f(10)).astype(onp.float32)
BN_X = _f(4, 3, 5, 5, scale=2.0) + 0.5
BN = [_f(3), _f(3), _f(3), onp.abs(_f(3)) + 0.5]

CASES = {
    "grid_affine": Case("GridGenerator", [THETA],
                        {"transform_type": "affine",
                         "target_shape": (5, 6)}, grad=(0,)),
    "grid_warp": Case("grid_generator", [FLOW], {"transform_type": "warp"},
                      grad=(0,)),
    "bilinear_sampler": Case("BilinearSampler", [IMG, GRID], grad=(0, 1)),
    "spatial_transformer": Case("SpatialTransformer", [IMG, THETA],
                                {"target_shape": (6, 5)}, grad=(0,)),
    "crop_like": Case("Crop", [IMG, _f(1, 1, 4, 5)], {"offset": (1, 2)},
                      tol="exact"),
    "crop_center": Case("crop_v1", [IMG], {"h_w": (3, 4),
                                           "center_crop": True},
                        tol="exact"),
    "svm_l2": Case("SVMOutput", [SCORES, LABELS], {"margin": 0.5},
                   tol="exact", grad=(0,)),
    "svm_linear": Case("svm_output", [SCORES, LABELS],
                       {"use_linear": True,
                        "regularization_coefficient": 0.3},
                       tol="exact", grad=(0,)),
    "correlation": Case("Correlation", [C1, C2],
                        {"max_displacement": 2, "pad_size": 2}, grad=(0, 1)),
    "correlation_k3": Case("correlation", [C1, C2],
                           {"kernel_size": 3, "max_displacement": 2,
                            "stride1": 2, "stride2": 2, "pad_size": 3,
                            "is_multiply": False}, grad=(0, 1)),
    "fft": Case("_contrib_fft", [SIG], grad=(0,)),
    "ifft": Case("ifft", [_f(3, 32)], grad=(0,)),
    "count_sketch": Case("_contrib_count_sketch", [_f(4, 10), SK_H, SK_S],
                         {"out_dim": 6}, grad=(0,)),
    "sync_batchnorm": Case("_contrib_SyncBatchNorm", [BN_X] + BN,
                           {"fix_gamma": False}, grad=(0, 1, 2)),
    "sync_batchnorm_stats": Case("SyncBatchNorm", [BN_X] + BN,
                                 {"output_mean_var": True, "eps": 1e-5},
                                 grad=(0, 2)),
    "sync_batchnorm_global": Case("SyncBatchNorm", [BN_X] + BN,
                                  {"use_global_stats": True,
                                   "fix_gamma": False}, grad=(0, 1)),
}


@pytest.fixture(scope="module")
def ref():
    return reference_results(reference_thunks(CASES), chunk=8, probe=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(ref, name):
    check(CASES[name], result(ref, name), name)


def test_ifft_inverts_fft_unnormalised():
    """``ifft(fft(x)) = d x`` (the reference's cuFFT-style inverse)."""
    from mxnet_tpu_torch.ops import spatial_ops
    import torch
    x = torch.from_numpy(SIG)
    back = spatial_ops.ifft.fn(spatial_ops.fft.fn(x))
    onp.testing.assert_allclose(back.numpy(), 16 * SIG, rtol=1e-5,
                                atol=1e-4)
