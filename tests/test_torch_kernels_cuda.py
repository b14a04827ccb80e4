"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a CUDA kernel has no CPU mode; its plain twin is what the CPU tests
hold against the JAX package). The module imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: forward fp32 atol/rtol 2e-4 (the kernel sums in another
order); bf16 2e-2 (P is rounded to bf16 before PV). Backward: the largest
error at most 2e-4 (fp32) or 2e-2 (bf16) of the largest |value| of each
gradient (dS and Pdrop are rounded to bf16 before their products, and a
value that lands on a rounding edge may round the other way). The bf16
forward, dQ and dK/dV run on the tensor cores (``wgmma``) with the same
tolerances: their products are bf16 x bf16 with fp32 sums, as the plain
version's. Every fp32 kernel (forward, dQ, dK/dV) runs on the CUDA cores
in fp32 and takes ``ex2.approx`` (~2 ulp) for exp, far inside 2e-4.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("S,D,causal,dropout", [
    (200, 64, True, 0.1), (77, 32, False, 0.0), (130, 128, True, 0.0)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, layout, S, D, causal,
                                    dropout):
    rng = np.random.default_rng(S + D)
    B, H = 2, 3
    shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype("float32"))
               .to(cuda, dtype) for _ in range(3))
    mask = torch.from_numpy((rng.random((B, S)) > 0.3).astype("int32"))
    mask[:, 0] = 1
    mask[1] = 0                                  # a fully masked row: 0 out
    mask = mask.to(cuda)
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    before = fn.launches
    out, lse = fn(q, k, v, mask, 99, causal, dropout, return_lse=True)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, mask, 99, causal,
                                             dropout, layout=layout,
                                             return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=2e-4)
    assert bool((out[1] == 0).all())


def _inputs(cuda, dtype, layout, S, D, seed, H=3):
    rng = np.random.default_rng(seed)
    B = 2
    shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        "float32")).to(cuda, dtype) for _ in range(4))
    mask = torch.from_numpy((rng.random((B, S)) > 0.3).astype("int32"))
    mask[:, 0] = 1
    mask[1] = 0                                  # a fully masked row
    return q, k, v, g, mask.to(cuda)


def _assert_close_to_max(out, ref, tol, name):
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    assert err <= tol * max(top, 1e-6), "%s: max err %g, max |ref| %g" % (
        name, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("S,D,causal,dropout", [
    (200, 64, True, 0.1), (77, 32, False, 0.0), (130, 128, True, 0.0)])
def test_flash_backward_kernels_match_plain(cuda, dtype, tol, layout, S, D,
                                            causal, dropout):
    q, k, v, g, mask = _inputs(cuda, dtype, layout, S, D, S * D)
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    o, lse = fn(q, k, v, mask, 99, causal, dropout, return_lse=True)
    delta = tfa._delta(g, o, layout)
    n_dq = tfa.flash_attention_bwd_dq.launches
    n_dkv = tfa.flash_attention_bwd_dkv.launches
    dq = tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, mask, 99, causal,
                                    dropout, layout)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, mask, 99,
                                         causal, dropout, layout)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches == n_dq + 1
    assert tfa.flash_attention_bwd_dkv.launches == n_dkv + 1
    ref = tfa.flash_attention_bwd_plain(q, k, v, mask, 99, o, lse, g, causal,
                                        dropout, layout)
    for name, out, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert out.dtype == dtype and out.shape == q.shape
        _assert_close_to_max(out, r, tol, name)
        assert bool((out[1] == 0).all()), name   # the fully masked row


@pytest.mark.cuda
def test_cuda_backward_runs_the_kernels(cuda):
    q, k, v, g, mask = _inputs(cuda, torch.float32, "BSHD", 96, 64, 5)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention_bshd(*leaves, mask, 7, True, 0.1)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bshd.launches == 1
    assert tfa.flash_attention_bwd_dq.launches == 1
    assert tfa.flash_attention_bwd_dkv.launches == 1
    _, lse = tfa.flash_attention_plain(q, k, v, mask, 7, True, 0.1,
                                       layout="BSHD", return_lse=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, mask, 7, out.detach(), lse,
                                        g, True, 0.1, "BSHD")
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        _assert_close_to_max(a, r, 2e-4, name)


# ------------------------------------- bf16 forward, dQ and dK/dV on wgmma

_EDGES = [63, 64, 65, 77, 130, 200]          # around the 64-row tiles


def _forward_at_edge(cuda, dtype, tol, layout, causal, D, S, seed, H=3):
    """The forward kernel against the plain forward (output and LSE);
    dropout where S is odd (ragged); batch row 1 fully masked."""
    q, k, v, _, mask = _inputs(cuda, dtype, layout, S, D, seed, H)
    dropout = 0.1 if S % 2 else 0.0
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    out, lse = fn(q, k, v, mask, 5, causal, dropout, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, mask, 5, causal,
                                             dropout, layout=layout,
                                             return_lse=True)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=2e-4)
    assert bool((out[1] == 0).all())         # the fully masked batch row


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _EDGES)
def test_bf16_forward_at_tile_edges(cuda, layout, causal, D, S):
    _forward_at_edge(cuda, torch.bfloat16, 2e-2, layout, causal, D, S,
                     7 * S + D)


def _grads_at_edge(cuda, dtype, tol, part, layout, causal, D, S, seed):
    """One backward kernel (``part`` "dq" or "dkv") against the plain
    backward; dropout where S is odd; batch row 1 fully masked."""
    q, k, v, g, mask = _inputs(cuda, dtype, layout, S, D, seed)
    dropout = 0.1 if S % 2 else 0.0
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    o, lse = fn(q, k, v, mask, 5, causal, dropout, return_lse=True)
    delta = tfa._delta(g, o, layout)
    args = (q, k, v, g, lse, delta, mask, 5, causal, dropout, layout)
    if part == "dq":
        outs = (("dq", tfa.flash_attention_bwd_dq(*args), 0),)
    else:
        dk, dv = tfa.flash_attention_bwd_dkv(*args)
        outs = (("dk", dk, 1), ("dv", dv, 2))
    torch.cuda.synchronize()
    ref = tfa.flash_attention_bwd_plain(q, k, v, mask, 5, o, lse, g, causal,
                                        dropout, layout)
    for name, out, i in outs:
        assert out.dtype == dtype and out.shape == q.shape
        _assert_close_to_max(out, ref[i], tol, name)
        assert bool((out[1] == 0).all()), name   # the fully masked row


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _EDGES)
def test_bf16_dkv_at_tile_edges(cuda, layout, causal, D, S):
    _grads_at_edge(cuda, torch.bfloat16, 2e-2, "dkv", layout, causal, D, S,
                   11 * S + D)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _EDGES)
def test_bf16_dq_at_tile_edges(cuda, layout, causal, D, S):
    _grads_at_edge(cuda, torch.bfloat16, 2e-2, "dq", layout, causal, D, S,
                   13 * S + D)


# the fp32 kernels stream 32-row tiles past blocks of 64 rows (dK/dV and
# dQ: 32 at D 128)
_F32_EDGES = [31, 32, 33, 63, 64, 65, 97, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["small", "large"])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _F32_EDGES)
def test_fp32_forward_at_tile_edges(cuda, grid, layout, causal, D, S):
    # the fp32 forward takes 32-row query tiles where 64-row ones would give
    # fewer than 2 blocks an SM (the small grid, B 2 x H 3), else 64-row
    # ones (B 2 x H = the card's SM count)
    H = 3 if grid == "small" else \
        torch.cuda.get_device_properties(cuda).multi_processor_count
    _forward_at_edge(cuda, torch.float32, 2e-4, layout, causal, D, S,
                     19 * S + D, H)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _F32_EDGES)
def test_fp32_dq_at_tile_edges(cuda, layout, causal, D, S):
    _grads_at_edge(cuda, torch.float32, 2e-4, "dq", layout, causal, D, S,
                   23 * S + D)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", _F32_EDGES)
def test_fp32_dkv_at_tile_edges(cuda, layout, causal, D, S):
    _grads_at_edge(cuda, torch.float32, 2e-4, "dkv", layout, causal, D, S,
                   17 * S + D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_kernels_on_unaligned_views(cuda, dtype, tol, D):
    # BHSD views whose seq stride (D + 1 elements) and base (one element
    # in) break the 16-byte rows cp.async needs: the wrappers copy them
    B, H, S = 2, 3, 100
    rng = np.random.default_rng(D)

    def view(base_off):
        n = B * H * S * (D + 1) + base_off
        flat = torch.from_numpy(rng.standard_normal(n).astype("float32")).to(
            cuda, dtype)
        return flat[base_off:].view(B, H, S, D + 1)[..., :D]

    q, k, v, g = view(1), view(0), view(3), view(1)
    assert q.stride(2) == D + 1 and q.data_ptr() % 16 != 0
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[:, -7:] = 0
    out, lse = tfa.flash_attention(q, k, v, mask, None, True, 0.0,
                                   return_lse=True)
    delta = tfa._delta(g, out, "BHSD")
    dq = tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, mask, None, True,
                                    0.0, "BHSD")
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, mask, None,
                                         True, 0.0, "BHSD")
    torch.cuda.synchronize()
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, mask, None, True, 0.0,
                                             layout="BHSD", return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=2e-4)
    rb = tfa.flash_attention_bwd_plain(q, k, v, mask, None, out, lse, g,
                                       True, 0.0, "BHSD")
    _assert_close_to_max(dq, rb[0], tol, "dq")
    _assert_close_to_max(dk, rb[1], tol, "dk")
    _assert_close_to_max(dv, rb[2], tol, "dv")


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("dtype,part", [(torch.bfloat16, "dkv"),
                                        (torch.bfloat16, "dq"),
                                        (torch.float32, "dkv"),
                                        (torch.float32, "dq")])
def test_backward_kernels_are_deterministic(cuda, dtype, part, dropout):
    q, k, v, g, mask = _inputs(cuda, dtype, "BSHD", 333, 64, 3)
    o, lse = tfa.flash_attention_bshd(q, k, v, mask, 9, True, dropout,
                                      return_lse=True)
    delta = tfa._delta(g, o, "BSHD")
    args = (q, k, v, g, lse, delta, mask, 9, True, dropout, "BSHD")
    kern = tfa.flash_attention_bwd_dq if part == "dq" else \
        tfa.flash_attention_bwd_dkv
    first = kern(*args)
    second = kern(*args)
    o2, lse2 = tfa.flash_attention_bshd(q, k, v, mask, 9, True, dropout,
                                        return_lse=True)
    torch.cuda.synchronize()
    if part == "dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)             # bitwise: no atomics
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("S,causal,dropout", [
    (129, True, 0.0), (200, False, 0.1), (257, True, 0.1), (320, False, 0.0)])
def test_forward_on_a_large_grid(cuda, dtype, tol, layout, S, causal,
                                 dropout):
    # B * H = 288 heads: several blocks on every SM at once, as in
    # training; both the masked and the unmasked (interior-tile) paths
    rng = np.random.default_rng(S)
    B, H, D = 24, 12, 64
    shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype("float32"))
               .to(cuda, dtype) for _ in range(3))
    mask = torch.from_numpy((rng.random((B, S)) > 0.2).astype("int32"))
    mask[:, 0] = 1
    mask[3] = 0                                  # a fully masked batch row
    mask = mask.to(cuda)
    fn = tfa.flash_attention_bshd if layout == "BSHD" else tfa.flash_attention
    for m in (None, mask):
        out, lse = fn(q, k, v, m, 17, causal, dropout, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, m, 17, causal,
                                                 dropout, layout=layout,
                                                 return_lse=True)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=2e-4, rtol=2e-4)
    assert bool((out[3] == 0).all())
