"""Flash-attention forward: the CUDA kernel's wrappers and its plain twin.

Port of the forward half of ``mxnet_tpu/ops/pallas_kernels.py``. The TPU
package has two Pallas forward kernels, ``_bshd_fwd_kernel`` (the
head-fused ``(B, S, H, D)`` family) and ``_attn_fwd_kernel`` (the per-head
``(B*H, S, D)`` family); two exist there only because Mosaic forbids
per-head blocks. Here one hand-written CUDA kernel,
``csrc/flash_attn_fwd.cu``, serves both: it takes element strides for
(batch, seq, head), so :func:`flash_attention_bshd` and
:func:`flash_attention` hand it views of their inputs without a copy.
The source note in that file says what bounds it on the H100 and how it is
laid out.

- On a CUDA tensor a wrapper launches the kernel or raises. There is no
  fallback to the plain version.
- On a CPU tensor it computes :func:`flash_attention_plain`, the same
  function in plain PyTorch (exact softmax instead of the online one; the
  same zero rows, pre-dropout normaliser and lowbias32 keep bits).
- Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The backward kernels are not ported yet, so a CUDA input that requires
grad under grad mode is refused instead of differentiating the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_plain",
           "keep_mask", "lowbias32", "SUPPORTED_HEAD_DIMS",
           "SUPPORTED_DTYPES", "reset_launches"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_M32 = 0xFFFFFFFF


# --------------------------------------------------------------- dropout bits

def _mul32(x, c):
    """``(x * c) mod 2^32`` on int64 tensors holding uint32 values, split
    into 16-bit halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def lowbias32(x):
    """lowbias32 over int64 tensors holding uint32 values (the TPU package's
    ``pallas_kernels._lowbias32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _threshold(keep_prob):
    return min(int(keep_prob * 4294967296.0), 4294967295)


def keep_mask(seed, bh, q_idx, k_idx, keep_prob):
    """Dropout keep bits for global coordinates, broadcast over ``bh``,
    ``q_idx`` and ``k_idx`` (int64 tensors): the TPU kernels'
    ``_keep_bits`` bit for bit."""
    seed = int(seed) & _M32
    c = ((q_idx * 0x9E3779B9) & _M32) ^ ((k_idx * 0x85EBCA6B) & _M32) \
        ^ ((bh * 0xC2B2AE35) & _M32) ^ seed
    return lowbias32(c) < _threshold(keep_prob)


# ------------------------------------------------------------ plain version

def _to_bhsd(x, layout):
    return x.transpose(1, 2) if layout == "BSHD" else x


def flash_attention_plain(q, k, v, kv_mask=None, seed=None, causal=False,
                          dropout=0.0, layout="BHSD", return_lse=False):
    """The kernel's function in plain PyTorch, in either layout.

    Same semantics as the kernel: products in the operand type with fp32
    sums, fp32 softmax, masked positions exactly 0, a fully masked row 0,
    the normaliser over pre-dropout P, lowbias32 keep bits, and P rounded
    to the operand type before PV. With ``return_lse`` it also returns the
    per-row logsumexp ``(B, H, S)`` fp32."""
    dt = q.dtype
    qh = _to_bhsd(q, layout).float()
    kh = _to_bhsd(k.to(dt), layout).float()
    vh = _to_bhsd(v.to(dt), layout).float()
    B, H, S, D = qh.shape
    scale = float(np.float32(1.0 / math.sqrt(D)))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    dead = torch.zeros((1, 1, S, S), dtype=torch.bool, device=q.device)
    if causal:
        dead = dead | torch.ones((S, S), dtype=torch.bool,
                                 device=q.device).triu(1)
    if kv_mask is not None:
        dead = dead | (kv_mask.reshape(B, 1, 1, S) == 0)
    s = s.masked_fill(dead, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(dead, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if dropout > 0.0:
        dev = q.device
        keep = keep_mask(0 if seed is None else int(seed),
                         torch.arange(B * H, device=dev).view(B, H, 1, 1),
                         torch.arange(S, device=dev).view(1, 1, S, 1),
                         torch.arange(S, device=dev).view(1, 1, 1, S),
                         1.0 - dropout)
        keep_f = torch.tensor(1.0 - dropout, dtype=torch.float32, device=dev)
        p = torch.where(keep, p / keep_f, torch.zeros((), device=dev))
    out = torch.matmul(p.to(dt).float(), vh) / l_safe
    out = out.to(dt)
    if layout == "BSHD":
        out = out.transpose(1, 2).contiguous()
    if return_lse:
        return out, (m + torch.log(l_safe)).squeeze(-1)
    return out


# ------------------------------------------------------------------- kernel

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("flash_attn_fwd").flash_attn_fwd
        P, LL, I, U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint)
        fn.argtypes = [P, P, P, P, P, P] + [LL] * 13 + \
            [I, I, I, I, I, ctypes.c_float, I, I, ctypes.c_float, U, U, P]
        fn.restype = I
        _fn = fn
    return _fn


def _bsh_strides(x, layout):
    """(batch, seq, head) element strides of a 4-D tensor."""
    if layout == "BSHD":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _launch(q, k, v, kv_mask, seed, causal, dropout, layout):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash attention on CUDA has no backward kernel yet: call it "
            "under torch.no_grad() or on tensors that do not require grad")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError("flash attention kernel takes float32 or bfloat16, "
                        "got %s" % q.dtype)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError("flash attention kernel needs q, k, v of one 4-D "
                         "shape, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if layout == "BSHD":
        B, S, H, D = q.shape
    else:
        B, H, S, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError("head_dim %d not in %s" % (D, SUPPORTED_HEAD_DIMS))
    # the kernel reads each head row as D contiguous elements
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = None, 0
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, S):
            raise ValueError("kv_mask must be (B, S) = %s, got %s"
                             % ((B, S), tuple(kv_mask.shape)))
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        mask_ptr, mask_sb = kv_mask.data_ptr(), kv_mask.stride(0)
    keep = 1.0 - float(dropout)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            mask_ptr, lse.data_ptr(),
            *_bsh_strides(q, layout), *_bsh_strides(k, layout),
            *_bsh_strides(v, layout), *_bsh_strides(out, layout), mask_sb,
            B, H, S, D, int(q.dtype == torch.bfloat16),
            float(np.float32(1.0 / math.sqrt(D))), int(bool(causal)),
            int(dropout > 0.0), float(np.float32(keep)), _threshold(keep),
            (0 if seed is None else int(seed)) & _M32, stream)
    if err != 0:
        raise RuntimeError("flash_attn_fwd launch failed: cudaError %d" % err)
    return out, lse


def _dispatch(wrapper, q, k, v, kv_mask, seed, causal, dropout, layout,
              return_lse):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, seed, causal, dropout,
                                     layout=layout, return_lse=return_lse)
    if q.device.type != "cuda":
        raise RuntimeError("flash attention runs on CUDA or CPU tensors, "
                           "not %s" % q.device)
    out, lse = _launch(q, k, v, kv_mask, seed, causal, dropout, layout)
    wrapper.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bshd(q, k, v, kv_mask=None, seed=None, causal=False,
                         dropout=0.0, return_lse=False):
    """Exact attention over ``(B, S, H, D)`` tensors (the transformer's
    layout straight out of the qkv projection), with the TPU kernel's
    signature. ``kv_mask`` ``(B, S)``, nonzero = attend; ``seed`` int32 for
    attention dropout. Returns ``(B, S, H, D)`` (and the ``(B, H, S)``
    logsumexp with ``return_lse``)."""
    return _dispatch(flash_attention_bshd, q, k, v, kv_mask, seed, causal,
                     dropout, "BSHD", return_lse)


def flash_attention(q, k, v, kv_mask=None, seed=None, causal=False,
                    dropout=0.0, return_lse=False):
    """Exact attention over ``(B, H, S, D)`` tensors; same semantics as
    :func:`flash_attention_bshd`."""
    return _dispatch(flash_attention, q, k, v, kv_mask, seed, causal,
                     dropout, "BHSD", return_lse)


flash_attention_bshd.launches = 0
flash_attention.launches = 0


def reset_launches():
    """Set both wrappers' launch counts to 0."""
    flash_attention_bshd.launches = 0
    flash_attention.launches = 0
