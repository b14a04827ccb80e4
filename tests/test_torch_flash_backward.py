"""The port's flash-attention backward against the JAX package.

``flash_attention_bwd_plain`` (the twin of the CUDA dQ and dK/dV kernels)
is held against ``jax.vjp`` of the Pallas kernels run in interpret mode, as
``tests/test_pallas.py`` runs them: both recompute P from the forward's
logsumexp in fp32 and differ only in summation order, hence atol/rtol 1e-4.
The dropout case injects the same int32 seed into both. Two cases feed both
the same bf16 inputs: the bf16 twin is what the card holds the bf16 dQ and
dK/dV kernels against (tolerance at ``BF16_TOL``). The
``autograd.Function`` behind both entry points is held against
``torch.autograd`` through ``flash_attention_plain`` on CPU tensors. The
kernels themselves are held against the plain backward on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention, flash_attention_bshd
from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
# bf16: both sides round dS, Pdrop and the gradients to bf16 and sum in
# fp32 in another order, so a value on a bf16 rounding edge may move by one
# bf16 ulp (2^-8, 3.9e-3 of its own size): the largest error is held to
# 1e-2 of each gradient's largest |value|
BF16_TOL = 1e-2
B, S, H = 2, 128, 2
SEED = -987654321


def _inputs(seed, D, variant):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype("float32")
                  for _ in range(4))
    mask = None
    if variant != "causal":
        mask = (rng.random((B, S)) > 0.3).astype("int32")
        mask[:, 0] = 1
        if variant == "masked_row":
            mask[B - 1] = 0
    return q, k, v, g, mask


def _bhsd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _layout(xs, layout):
    return [_bhsd(x) for x in xs] if layout == "BHSD" else list(xs)


def _jax_grads(layout, q, k, v, g, mask, seed, causal, dropout,
               dtype=jnp.float32):
    fn = flash_attention_bshd if layout == "BSHD" else flash_attention
    m = None if mask is None else jnp.asarray(mask)
    s = None if seed is None else jnp.int32(seed)
    q, k, v, g = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, m, s, causal, dropout, True),
                     q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(g)]


def _port_grads(layout, q, k, v, g, mask, seed, causal, dropout,
                dtype=torch.float32):
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    m = None if mask is None else torch.from_numpy(mask)
    o, lse = tfa.flash_attention_plain(q, k, v, m, seed, causal, dropout,
                                       layout=layout, return_lse=True)
    return [x.float().numpy() for x in tfa.flash_attention_bwd_plain(
        q, k, v, m, seed, o, lse, g, causal, dropout, layout)]


# at most 8 interpret-mode backward runs: each layout meets causal, a key
# mask, a fully masked row and dropout; D 32 and 64 both appear
@pytest.mark.parametrize("layout,D,variant,dropout", [
    ("BSHD", 64, "causal", 0.0), ("BHSD", 64, "causal", 0.0),
    ("BSHD", 32, "mask", 0.0), ("BHSD", 32, "mask", 0.0),
    ("BSHD", 32, "masked_row", 0.0), ("BHSD", 64, "masked_row", 0.0),
    ("BSHD", 32, "mask", 0.2), ("BHSD", 32, "causal", 0.2)])
def test_plain_backward_matches_pallas(layout, D, variant, dropout):
    q, k, v, g, mask = _inputs(D + len(variant), D, variant)
    causal = variant != "mask"
    seed = SEED if dropout else None
    args = _layout((q, k, v, g), layout) + [mask, seed, causal, dropout]
    ref = _jax_grads(layout, *args)
    out = _port_grads(layout, *args)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=RTOL, err_msg=name)
        if variant == "masked_row":           # no live key: zero gradients
            assert np.all(a[B - 1] == 0.0), name


# two more interpret-mode runs, in bf16 (the Pallas kernels take bf16
# operands and sum in fp32, as the port's twin does)
@pytest.mark.parametrize("layout,D,variant", [
    ("BSHD", 64, "causal"), ("BHSD", 32, "mask")])
def test_plain_backward_matches_pallas_in_bf16(layout, D, variant):
    q, k, v, g, mask = _inputs(D + len(variant), D, variant)
    causal = variant != "mask"
    args = _layout((q, k, v, g), layout) + [mask, None, causal, 0.0]
    ref = _jax_grads(layout, *args, dtype=jnp.bfloat16)
    out = _port_grads(layout, *args, dtype=torch.bfloat16)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        err = np.abs(a - r).max()
        top = np.abs(r).max()
        assert err <= BF16_TOL * top, "%s: max err %g, max |ref| %g" % (
            name, err, top)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
def test_autograd_function_matches_autograd_through_plain(layout, dropout):
    q, k, v, g, mask = _inputs(5, 32, "masked_row")
    q, k, v, g = (torch.from_numpy(x) for x in _layout((q, k, v, g), layout))
    m = torch.from_numpy(mask)
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, m, 77, True, dropout)
    grads = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = tfa.flash_attention_plain(*ref_leaves, m, 77, True, dropout,
                                    layout=layout)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    assert torch.equal(out, ref)
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=RTOL)


def test_cpu_backward_wrappers_take_plain_version_and_count_nothing():
    q, k, v, g, mask = _inputs(9, 64, "mask")
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    m = torch.from_numpy(mask)
    tfa.reset_launches()
    o, lse = tfa.flash_attention_bshd(q, k, v, m, causal=True,
                                      return_lse=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, m, None, o, lse, g, True,
                                        0.0, "BSHD")
    out = tfa.flash_attention_bwd(q, k, v, m, None, o, lse, g, True, 0.0,
                                  "BSHD")
    delta = tfa._delta(g, o, "BSHD")
    assert delta.shape == (B, H, S)
    dq = tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, m, None, True,
                                    0.0, "BSHD")
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, m, None,
                                         True, 0.0, "BSHD")
    for a, b, r in zip(out, (dq, dk, dv), ref):
        assert torch.equal(a, r) and torch.equal(b, r)
    assert all(w.launches == 0 for w in tfa._WRAPPERS)
