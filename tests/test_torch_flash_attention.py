"""The port's flash-attention module against the JAX package.

``flash_attention_plain`` (the CUDA kernel's twin) is held against the
Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them: both compute an exact softmax in fp32 and differ only in summation
order, hence atol/rtol 1e-4. The dropout keep bits must equal the TPU
kernels' ``_keep_bits`` exactly. ``dot_product_attention`` is held against
the reference op's XLA path (the path the JAX package takes off the TPU).
The kernel itself is held against its plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.nn import dot_product_attention as jax_dpa
from mxnet_tpu.ops.pallas_kernels import (_keep_bits, flash_attention,
                                          flash_attention_bshd)
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.nn import dot_product_attention

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent


def _inputs(seed, B, S, H, D, variant):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype("float32")
               for _ in range(3))
    mask = None
    if variant in ("mask", "masked_row"):
        mask = (rng.random((B, S)) > 0.3).astype("int32")
        mask[:, 0] = 1
        if variant == "masked_row":
            mask[B - 1] = 0
    return q, k, v, mask


def _bhsd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _run_jax(layout, q, k, v, mask, seed, causal, dropout):
    if layout == "BHSD":
        q, k, v = _bhsd(q), _bhsd(k), _bhsd(v)
    fn = flash_attention_bshd if layout == "BSHD" else flash_attention
    m = None if mask is None else jnp.asarray(mask)
    s = None if seed is None else jnp.int32(seed)
    out = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), m, s,
                        causal, dropout, True))
    return _bhsd(out) if layout == "BHSD" else out


def _run_port(layout, q, k, v, mask, seed, causal, dropout):
    if layout == "BHSD":
        q, k, v = _bhsd(q), _bhsd(k), _bhsd(v)
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    m = None if mask is None else torch.from_numpy(mask)
    out = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), m,
             seed, causal, dropout).numpy()
    return _bhsd(out) if layout == "BHSD" else out


# each S in {128, 256} and each D in {32, 64} appears in both layouts and
# every variant; the full product would double the interpret-mode runs
@pytest.mark.parametrize("variant", ["causal", "mask", "masked_row"])
@pytest.mark.parametrize("S,D", [(128, 64), (256, 32)])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
def test_plain_matches_pallas(layout, S, D, variant):
    q, k, v, mask = _inputs(S + D, 2, S, 2, D, variant)
    causal = variant != "mask"
    ref = _run_jax(layout, q, k, v, mask, None, causal, 0.0)
    out = _run_port(layout, q, k, v, mask, None, causal, 0.0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if variant == "masked_row":
        assert np.all(out[-1] == 0.0)       # a fully masked row outputs 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
def test_plain_dropout_matches_pallas(layout, causal):
    q, k, v, mask = _inputs(7, 2, 128, 2, 32, "mask")
    seed = -123456789
    ref = _run_jax(layout, q, k, v, mask, seed, causal, 0.3)
    out = _run_port(layout, q, k, v, mask, seed, causal, 0.3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed,bh,q0,keep", [
    (0, 0, 0, 0.9), (-7, 3, 128, 0.7), (2 ** 31 - 1, 11, 896, 0.5),
    (-2 ** 31, 63, 1920, 0.1)])
def test_keep_bits_bitwise(seed, bh, q0, keep):
    blk_q, blk_k, k0 = 128, 256, 256
    ref = np.asarray(_keep_bits(jnp.int32(seed), jnp.int32(bh),
                                jnp.int32(q0), jnp.int32(k0), blk_q, blk_k,
                                keep))
    out = tfa.keep_mask(seed, torch.tensor(bh),
                        torch.arange(q0, q0 + blk_q).reshape(-1, 1),
                        torch.arange(k0, k0 + blk_k).reshape(1, -1),
                        keep).numpy()
    np.testing.assert_array_equal(out, ref)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    q, k, v, mask = _inputs(3, 1, 100, 2, 64, "mask")
    tfa.reset_launches()
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    out, lse = tfa.flash_attention_bshd(*args, causal=True, return_lse=True)
    ref, ref_lse = tfa.flash_attention_plain(*args, causal=True,
                                             layout="BSHD", return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert lse.shape == (1, 2, 100)
    assert tfa.flash_attention_bshd.launches == 0
    assert tfa.flash_attention.launches == 0


def _dpa_case(case):
    rng = np.random.default_rng(len(case))
    B, S, H, D = 2, 24, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype("float32")
    k = rng.standard_normal((B, S, H, D)).astype("float32")
    v = rng.standard_normal((B, S, H, D)).astype("float32")
    mask = rng.random((B, S)) > 0.3
    mask[:, 0] = True
    kw = dict(layout="BSHD", causal=False)
    if case == "bshd_causal_mask":
        kw.update(causal=True)
    elif case == "bhsd_4d_mask":
        q, k, v = _bhsd(q), _bhsd(k), _bhsd(v)
        mask = mask[:, None, None, :]
        kw.update(layout="BHSD")
    elif case == "decode_step":
        q = q[:, :1]
    elif case == "fully_masked_row":
        mask[1] = False
    return q, k, v, mask, kw


@pytest.mark.parametrize("case", ["bshd_causal_mask", "bhsd_4d_mask",
                                  "decode_step", "fully_masked_row"])
def test_dot_product_attention_matches_xla_path(case):
    q, k, v, mask, kw = _dpa_case(case)
    ref = np.asarray(jax_dpa.fn(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask=jnp.asarray(mask), **kw))
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # the workers of the port's multi-process tests and its launcher
    workers = sorted((REPO / "tests" / "dist_torch").glob("*.py"))
    assert len(workers) >= 4
    assert REPO / "mxnet_tpu_torch" / "tools" / "launch.py" in files
    files += workers
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), \
                "%s imports %s" % (path.relative_to(REPO), name)
