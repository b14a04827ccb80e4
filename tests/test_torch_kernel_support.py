"""CPU tests of the Python around the port's CUDA kernels: the build digest
(``_build._target``), the operand normalisation of the kernel wrappers
(``flash_attention._aligned``) and the switches of the kernel gate
(``ops.nn._kernel_gate``). None needs a card or ``nvcc``."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops import nn as tnn


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _lib_name(name):
    return _build._target(name)[1].name


def test_build_digest_follows_an_edited_header(csrc):
    first = _lib_name("kern")
    assert first.startswith("libkern-") and first.endswith(".so")
    assert _lib_name("kern") == first                  # stable
    (csrc / "common.cuh").write_text("// v2\n")
    second = _lib_name("kern")
    assert second != first
    (csrc / "common.cuh").write_text("// v1\n")
    assert _lib_name("kern") == first


@pytest.mark.parametrize("change", ["source", "new_header", "flags"])
def test_build_digest_follows_source_headers_and_flags(csrc, monkeypatch,
                                                       change):
    first = _lib_name("kern")
    if change == "source":
        (csrc / "kern.cu").write_text('#include "common.cuh"\n// edit\n')
    elif change == "new_header":
        (csrc / "other.cuh").write_text("// another shared header\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-I/opt/include",))
    assert _lib_name("kern") != first


def test_build_digest_of_the_package_sources_covers_their_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "hopper_tc.cuh" in headers
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        src, lib = _build._target(name)
        assert src.exists() and lib.parent == _build.BUILD_DIR


def _bf16(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aligned_keeps_the_qkv_split_views(dtype):
    B, T, H, D = 2, 5, 3, 32
    qkv = _bf16((B, T, 3 * H * D)).to(dtype)
    parts = qkv.reshape(B, T, 3, H, D)
    for i in range(3):
        x = parts[:, :, i]                     # seq stride 3*H*D, offset i*H*D
        y = tfa._aligned(x)
        assert y is x                           # no copy on the main path
        bhsd = x.transpose(1, 2)
        assert tfa._aligned(bhsd) is bhsd


@pytest.mark.parametrize("make", ["odd_seq_stride", "odd_base", "last_axis",
                                  "odd_head_stride"])
def test_aligned_copies_unaligned_views(make):
    B, H, S, D = 2, 3, 7, 32
    if make == "odd_seq_stride":
        x = _bf16((B, H, S, D + 1))[..., :D]    # seq stride D + 1 elements
    elif make == "odd_base":
        flat = _bf16((B * H * S * D + 1,))
        x = flat[1:].view(B, H, S, D)           # base 2 bytes past 16
    elif make == "last_axis":
        x = _bf16((B, H, D, S)).transpose(-1, -2)
    else:                                       # head stride D + 4 elements
        L = H * (D + 4) + 4                     # seq stride: 16-byte multiple
        x = _bf16((B * S * L,)).as_strided((B, S, H, D),
                                           (S * L, L, D + 4, 1))
    y = tfa._aligned(x)
    assert y is not x and y.is_contiguous()
    assert y.data_ptr() % 16 == 0
    torch.testing.assert_close(y, x, atol=0, rtol=0)


def test_aligned_ignores_strides_of_unit_dims():
    x = _bf16((1, 4, 1, 32)).as_strided((1, 4, 1, 32), (3, 32, 5, 1))
    assert tfa._aligned(x) is x


def test_check_normalises_every_operand():
    B, S, H, D = 2, 9, 3, 64
    q = _bf16((B, S, H, D + 8))[..., :D]        # aligned: 72 * 2 bytes
    k = _bf16((B, S, H, D + 1))[..., :D]        # unaligned seq stride
    v = _bf16((B, S, H, D), 1)
    q2, k2, v2, *dims = tfa._check(q, k, v, "BSHD")
    assert dims == [B, H, S, D]
    assert q2 is q and v2 is v and k2 is not k
    torch.testing.assert_close(k2, k, atol=0, rtol=0)


class _CardTensor:
    """Stands for a CUDA tensor of ``shape`` at the gate, which reads only
    ``is_cuda``, ``dim()``, ``shape`` and ``dtype``."""

    is_cuda = True
    dtype = torch.float32

    def __init__(self, shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("env,on", [
    ({}, True), ({"MXTPU_DISABLE_FLASH": "1"}, False),
    ({"MXTPU_DISABLE_FLASH": ""}, True),
    ({"MXNET_FLASH_ATTENTION": "0"}, False),
    ({"MXNET_FLASH_ATTENTION": "1", "MXTPU_DISABLE_FLASH": "yes"}, False)])
def test_flash_switches_are_read_at_each_call(monkeypatch, env, on):
    """``MXTPU_DISABLE_FLASH`` (any non-empty value) and
    ``MXNET_FLASH_ATTENTION=0`` turn the kernel off, as the reference's
    ``_flash_enabled`` does; both are read when the gate is asked."""
    for name in ("MXTPU_DISABLE_FLASH", "MXNET_FLASH_ATTENTION"):
        monkeypatch.delenv(name, raising=False)
    q = _CardTensor((2, 16, 3, 64))
    assert tnn._kernel_gate(q, q, q, True, True)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tnn._flash_enabled() is on
    assert tnn._kernel_gate(q, q, q, True, True) is on
