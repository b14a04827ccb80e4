"""``ops/image_ops.py`` of the port against the JAX package's, on the CPU.

- The deterministic ops (``to_tensor``, ``normalize``, ``crop``, the
  flips, ``adjust_lighting``) on the same numpy images: float32 within
  rtol 1e-5, atol 1e-6; uint8 exactly.
- ``_image_resize`` (``jax.image.resize``'s antialiased linear filter,
  and nearest): float32 within 1e-5 of the range; uint8 within one level
  of the reference's, and the count of differing pixels is asserted small
  (at most 1% here; the card phase prints its count at full size).
- The random ops with a fixed factor: the reference's own draws are
  replaced by the same factor (``jax.random.uniform``/``normal``/
  ``bernoulli`` patched in its module, the port's ``_uniform`` and
  ``randn`` likewise), then the whole op is held to the reference's:
  float32 within 1e-5, uint8 (values past 255 saturate) within one level.
- The random ops in distribution: the flips' rate and the factors' range
  over seeds, and a key repeats a draw.
"""
import jax
import jax.numpy as jjnp
import numpy as onp
import pytest
import torch

import mxnet_tpu.ops.image_ops as jimg
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import image_ops as timg
from mxnet_tpu_torch.ops import registry as treg

from _parity import compare, reference_results, result

RNG = onp.random.default_rng(51)
U8 = RNG.integers(0, 256, (2, 16, 12, 3)).astype(onp.uint8)
IMG = RNG.uniform(0, 255, (16, 12, 3)).astype(onp.float32)
CHW = RNG.standard_normal((2, 3, 8, 8)).astype(onp.float32)

CASES = {
    "to_tensor": ("_image_to_tensor", [U8[0]], {}),
    "to_tensor_batch": ("_npx__image_to_tensor", [U8], {}),
    "normalize": ("_image_normalize", [CHW], {
        "mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)}),
    "normalize_chw": ("image_normalize", [CHW[0]], {"mean": 0.5,
                                                   "std": 2.0}),
    "crop": ("_image_crop", [U8], {"x": 2, "y": 3, "width": 5,
                                   "height": 7}),
    "flip_lr": ("_image_flip_left_right", [U8], {}),
    "flip_tb": ("image_flip_top_bottom", [IMG], {}),
    "adjust_lighting": ("_image_adjust_lighting", [IMG],
                        {"alpha": (0.1, -0.2, 0.05)}),
    "adjust_lighting_u8": ("_npx__image_adjust_lighting", [U8],
                           {"alpha": (2.0, -1.0, 0.5)}),
    "resize_down": ("_image_resize", [IMG], {"size": (7, 9)}),
    "resize_up": ("image_resize", [IMG], {"size": 20}),
    "resize_nearest": ("_image_resize", [IMG], {"size": (5, 22),
                                                "interp": 0}),
}


@pytest.fixture(scope="module")
def reference():
    return reference_results({
        c: (lambda c=c: jreg.get_op(CASES[c][0]).fn(
            *[jjnp.asarray(a) for a in CASES[c][1]], **CASES[c][2]))
        for c in CASES})


@pytest.mark.parametrize("case", sorted(CASES))
def test_deterministic_ops(case, reference):
    name, arrays, kw = CASES[case]
    got = treg.get_op(name).fn(*[torch.from_numpy(a.copy()) for a in arrays],
                               **kw)
    want = result(reference, case)
    scale = float(onp.abs(onp.asarray(want)).max())
    compare(got, want, rtol=1e-5, atol=1e-6 * max(scale, 1.0), what=case)


@pytest.mark.parametrize("size", [(10, 12), (12, 8), (24, 20)])
def test_resize_uint8_within_one_level(size):
    got = treg.get_op("_image_resize").fn(torch.from_numpy(U8), size=size)
    want = onp.asarray(jreg.get_op("_image_resize").fn(jjnp.asarray(U8),
                                                       size=size))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    d = onp.abs(got.numpy().astype(onp.int32) - want.astype(onp.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.01, (d > 0).sum()


FACTORS = {"_image_random_brightness": {"min_factor": 0.5,
                                        "max_factor": 1.5},
           "_image_random_contrast": {"min_factor": 0.5, "max_factor": 1.5},
           "_image_random_saturation": {"min_factor": 0.5,
                                        "max_factor": 1.5},
           "_image_random_hue": {"min_factor": -0.3, "max_factor": 0.3},
           "_image_random_lighting": {"alpha_std": 0.5},
           "_image_random_color_jitter": {"brightness": 0.4, "contrast": 0.4,
                                          "saturation": 0.4, "hue": 0.2},
           "_image_random_flip_left_right": {},
           "_image_random_flip_top_bottom": {}}
U_FIXED = 0.8      # the fixed uniform draw (a factor at 80% of its range)
ALPHA = (0.3, -0.6, 0.2)


@pytest.mark.parametrize("name", sorted(FACTORS))
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_random_ops_with_a_fixed_factor(name, dtype, monkeypatch):
    monkeypatch.setattr(jimg.jax.random, "uniform",
                        lambda key, shape=(), dtype=None, minval=0.0,
                        maxval=1.0: jjnp.asarray(
                            minval + U_FIXED * (maxval - minval),
                            jjnp.float32))
    monkeypatch.setattr(jimg.jax.random, "normal",
                        lambda key, shape=(), dtype=None: jjnp.asarray(
                            ALPHA, jjnp.float32))
    monkeypatch.setattr(jimg.jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jjnp.asarray(True))
    monkeypatch.setattr(timg, "_uniform", lambda data, key, lo, hi, n=():
                        torch.full(n, U_FIXED) * (hi - lo) + lo if n else
                        torch.tensor(lo + U_FIXED * (hi - lo)))
    monkeypatch.setattr(timg.torch, "randn", lambda *a, **k:
                        torch.tensor(ALPHA))
    data = U8[0] if dtype == "uint8" else IMG
    want = onp.asarray(jreg.get_op(name).fn(jjnp.asarray(data),
                                            key=jax.random.PRNGKey(0),
                                            **FACTORS[name]))
    got = treg.get_op(name).fn(torch.from_numpy(data.copy()), key=(0, 0),
                               **FACTORS[name])
    if "flip" in name:       # the port's draw is < 0.5 at U_FIXED = 0.8
        got = treg.get_op(name.replace("_random", "")).fn(
            torch.from_numpy(data.copy()))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    gv = got.numpy().astype(onp.float64)
    if want.dtype == onp.uint8:
        assert onp.abs(gv - want).max() <= 1, name
    else:
        onp.testing.assert_allclose(gv, want, rtol=1e-5,
                                    atol=1e-6 * onp.abs(want).max())


def test_random_ops_in_distribution():
    x = torch.from_numpy(U8[0].copy())
    flips = [bool(torch.equal(treg.get_op(
        "_image_random_flip_left_right").fn(x, key=(s, 7)),
        torch.flip(x, (-2,)))) for s in range(200)]
    assert 0.35 < sum(flips) / 200 < 0.65
    img = torch.ones((2, 2, 3))
    f = [float(treg.get_op("_image_random_brightness").fn(
        img, 0.5, 1.5, key=(s, 1))[0, 0, 0]) for s in range(200)]
    assert 0.5 <= min(f) and max(f) <= 1.5 and abs(sum(f) / 200 - 1) < 0.06
    a = treg.get_op("_image_random_color_jitter").fn(
        x, 0.4, 0.4, 0.4, 0.1, key=(3, 4))
    b = treg.get_op("_image_random_color_jitter").fn(
        x, 0.4, 0.4, 0.4, 0.1, key=(3, 4))
    assert torch.equal(a, b) and a.dtype == torch.float32  # brightness first
