"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a CUDA kernel has no CPU mode; its plain twin is what the CPU tests
hold against the JAX package). The module imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: fp32 atol/rtol 2e-4 (the kernel sums in another order); bf16
2e-2 (P is rounded to bf16 before PV).
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


@pytest.mark.cuda
def test_flash_kernel_refuses_grad(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tfa.flash_attention_bshd(q, q, q)
    with torch.no_grad():
        assert tfa.flash_attention_bshd(q, q, q).shape == q.shape
