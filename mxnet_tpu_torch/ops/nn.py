"""Neural-network operators on the slice's path.

Counterpart of the subset of ``mxnet_tpu/ops/nn.py`` that the transformer
LM calls: ``FullyConnected``, the exact ``gelu``, ``LayerNorm`` and
``dot_product_attention`` (the ``_contrib_dot_product_attention`` op) with
its key-mask reduction and kernel dispatch. Plain functions on tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import config as _config
from .flash_attention import (SUPPORTED_DTYPES, SUPPORTED_HEAD_DIMS,
                              flash_attention, flash_attention_bshd)

__all__ = ["FullyConnected", "gelu", "LayerNorm", "dot_product_attention"]


def FullyConnected(data, weight, bias=None, flatten=True):
    """``data @ weight.T (+ bias)``; ``weight`` is ``(out, in)``. With
    ``flatten`` the input is flattened to ``(batch, -1)`` first."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def gelu(data):
    """The exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(data, approximate="none")


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer norm over ``axis`` with the biased variance and ``eps`` inside
    the square root."""
    if axis in (-1, data.dim() - 1):
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


def _reduce_key_mask(mask, batch, key_len):
    """Reduce a broadcastable keep-mask to ``(B, S_k)`` for the kernel.
    Returns ``(kv_mask, ok)``; ``ok`` False means the kernel cannot take
    it (full ``(B, H, Q, K)`` masks and the like)."""
    if mask is None:
        return None, True
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1 and \
            mask.shape[0] == batch and mask.shape[3] == key_len:
        return mask[:, 0, 0, :], True
    if mask.dim() == 2 and tuple(mask.shape) == (batch, key_len):
        return mask, True
    return None, False


def _kernel_gate(query, key, value, mask_ok, scaled):
    """The port's own gate for the CUDA flash kernel (not the TPU's VMEM
    and tiling gates): all of

    - the tensors are on a CUDA device;
    - self-attention, ``key.shape == value.shape == query.shape``;
    - the mask reduces to ``(B, S)``;
    - ``scaled``;
    - head_dim in ``SUPPORTED_HEAD_DIMS`` and a supported dtype;
    - ``MXNET_FLASH_ATTENTION`` set.

    Every prefill of the transformer LM passes it at full width; the
    one-token decode step (``key.shape != query.shape``) does not."""
    return (query.is_cuda and query.dim() == 4
            and key.shape == query.shape and value.shape == query.shape
            and mask_ok and scaled
            and query.shape[-1] in SUPPORTED_HEAD_DIMS
            and query.dtype in SUPPORTED_DTYPES
            and bool(_config.get("MXNET_FLASH_ATTENTION")))


def _kernel_seed(drop, generator, device):
    """The kernel's int32 dropout seed, drawn from ``generator``."""
    if drop <= 0.0:
        return None
    if generator is not None:
        device = generator.device
    return int(torch.randint(-2 ** 31, 2 ** 31 - 1, (), generator=generator,
                             device=device))


def dot_product_attention(query, key, value, mask=None, dropout=0.0,
                          scaled=True, causal=False, layout="BHSD",
                          generator=None, train=False):
    """Attention with the reference op's semantics.

    ``layout`` ``"BSHD"`` takes ``(B, S, H, D)`` tensors, ``"BHSD"`` (or
    any other rank) ``(..., S, D)``. ``mask`` is a broadcastable keep-mask
    (nonzero = attend). When :func:`_kernel_gate` holds, the CUDA flash
    kernel runs (masked positions are exactly 0 there; the dropout bits
    are lowbias32, seeded from ``generator``). Otherwise the plain path
    runs: a matmul, a softmax with masked scores filled with the dtype's
    ``finfo.min``, and dropout drawn from ``generator``."""
    drop = float(dropout) if train else 0.0
    if layout == "BSHD" and query.dim() == 4:
        kv_mask, mask_ok = _reduce_key_mask(mask, query.shape[0],
                                            key.shape[1])
        if _kernel_gate(query, key, value, mask_ok, scaled):
            return flash_attention_bshd(
                query, key, value, kv_mask,
                _kernel_seed(drop, generator, query.device), causal, drop)
        out = dot_product_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
            mask=mask, dropout=dropout, scaled=scaled, causal=causal,
            layout="BHSD", generator=generator, train=train)
        return out.transpose(1, 2)
    if query.dim() == 4:
        kv_mask, mask_ok = _reduce_key_mask(mask, query.shape[0],
                                            key.shape[2])
        if _kernel_gate(query, key, value, mask_ok, scaled):
            return flash_attention(
                query, key, value, kv_mask,
                _kernel_seed(drop, generator, query.device), causal, drop)
    return _plain_attention(query, key, value, mask, drop, scaled, causal,
                            generator)


def _plain_attention(query, key, value, mask, drop, scaled, causal,
                     generator):
    """The reference's XLA path (``mxnet_tpu/ops/nn.py:836-854``). Unlike
    the kernel, a fully masked row averages V uniformly here."""
    scores = torch.matmul(query, key.transpose(-1, -2))
    if scaled:
        scores = scores / math.sqrt(query.shape[-1])
    fill = torch.finfo(scores.dtype).min
    if causal:
        q, k = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((q, k), dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~cm, fill)
    if mask is not None:
        m = mask
        if m.dim() == 2 and scores.dim() == 4 and \
                tuple(m.shape) == (scores.shape[0], scores.shape[-1]):
            m = m[:, None, None, :]
        scores = scores.masked_fill(~m.bool(), fill)
    w = torch.softmax(scores, dim=-1)
    if drop > 0.0:
        keep = torch.rand(w.shape, generator=generator, device=w.device,
                          dtype=torch.float32) < (1.0 - drop)
        w = torch.where(keep, w / (1.0 - drop), torch.zeros_like(w))
    return torch.matmul(w, value)
