"""Flash attention: the CUDA kernels' wrappers and their plain twins.

Port of ``mxnet_tpu/ops/pallas_kernels.py``. The TPU package has six Pallas
kernels, a forward, a dQ and a dK/dV kernel in each of two families: the
head-fused ``(B, S, H, D)`` one (``_bshd_*``) and the per-head
``(B*H, S, D)`` one (``_attn_*``); two families exist there only because
Mosaic forbids per-head blocks. Here three hand-written CUDA kernels serve
both layouts: ``csrc/flash_attn_fwd.cu`` (forward) and
``csrc/flash_attn_bwd.cu`` (dQ, and dK/dV). Each takes element strides for
(batch, seq, head), so :func:`flash_attention_bshd` and
:func:`flash_attention` hand them views of their inputs without a copy
(views whose rows are not 16-byte aligned are copied first, see
:func:`_aligned`). bf16 runs all three on the tensor cores (``wgmma``,
with ``csrc/hopper_tc.cuh``); fp32 runs all three on the CUDA cores, in
fp32 with no TF32, on float4 micro-tiles fed by ``cp.async``
(``csrc/hopper_simt.cuh``). The source notes say what bounds each kernel
on the H100 and how it is laid out.

Both entry points are differentiable: a ``torch.autograd.Function`` runs the
forward kernel, saves ``q, k, v, kv_mask, o`` and the ``(B, H, S)``
logsumexp, and its backward runs the two backward kernels
(:func:`flash_attention_bwd`). ``kv_mask``, ``seed`` and the dropout rate get
no gradient, as in the reference's ``custom_vjp``.

- On a CUDA tensor a wrapper launches its kernel or raises. There is no
  fallback to the plain version.
- On a CPU tensor it computes the plain version in PyTorch:
  :func:`flash_attention_plain` (exact softmax instead of the online one;
  the same zero rows, pre-dropout normaliser and lowbias32 keep bits) and
  :func:`flash_attention_bwd_plain` (the reference's backward formulas, not
  autograd).
- Each wrapper counts its kernel launches in ``<wrapper>.launches``; the
  two backward ones also by layout, in ``.launches_by_layout``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_plain",
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


# ----------------------------------------------------------- plain versions

def _to_bhsd(x, layout):
    return x.transpose(1, 2) if layout == "BSHD" else x


def _from_bhsd(x, layout):
    return x.transpose(1, 2).contiguous() if layout == "BSHD" else x


def _dead(B, S, kv_mask, causal, device):
    """``(B or 1, 1, S, S)`` bool: positions that take no part (causal
    ``q < k`` or a masked key)."""
    dead = torch.zeros((1, 1, S, S), dtype=torch.bool, device=device)
    if causal:
        dead = dead | torch.ones((S, S), dtype=torch.bool,
                                 device=device).triu(1)
    if kv_mask is not None:
        dead = dead | (kv_mask.reshape(B, 1, 1, S) == 0)
    return dead


def _keep_tile(seed, B, H, S, keep_prob, device):
    """``(B, H, S, S)`` keep bits over global (b*H+h, q, k)."""
    return keep_mask(0 if seed is None else int(seed),
                     torch.arange(B * H, device=device).view(B, H, 1, 1),
                     torch.arange(S, device=device).view(1, 1, S, 1),
                     torch.arange(S, device=device).view(1, 1, 1, S),
                     keep_prob)


def _scale(D):
    return float(np.float32(1.0 / math.sqrt(D)))


def flash_attention_plain(q, k, v, kv_mask=None, seed=None, causal=False,
                          dropout=0.0, layout="BHSD", return_lse=False):
    """The forward kernel's function in plain PyTorch, in either layout.

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
    s = torch.matmul(qh, kh.transpose(-1, -2)) * _scale(D)
    dead = _dead(B, S, kv_mask, causal, q.device)
    s = s.masked_fill(dead, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(dead, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if dropout > 0.0:
        dev = q.device
        keep = _keep_tile(seed, B, H, S, 1.0 - dropout, dev)
        keep_f = torch.tensor(1.0 - dropout, dtype=torch.float32, device=dev)
        p = torch.where(keep, p / keep_f, torch.zeros((), device=dev))
    out = torch.matmul(p.to(dt).float(), vh) / l_safe
    out = _from_bhsd(out.to(dt), layout)
    if return_lse:
        return out, (m + torch.log(l_safe)).squeeze(-1)
    return out


def _delta(g, o, layout):
    """``rowsum(dO * O)`` in fp32, ``(B, H, S)`` contiguous: computed
    outside the kernels, as the reference does (``pallas_kernels.py:463,
    779``)."""
    d = (g.float() * o.float()).sum(dim=-1)
    return (d.transpose(1, 2) if layout == "BSHD" else d).contiguous()


def _bwd_plain(q, k, v, g, lse, delta, kv_mask, seed, causal, dropout,
               layout):
    """dQ, dK, dV from the saved logsumexp and delta, in plain PyTorch."""
    dt = q.dtype
    qh, kh, vh, gh = (_to_bhsd(x.to(dt), layout).float()
                      for x in (q, k, v, g))
    B, H, S, D = qh.shape
    scale = _scale(D)
    dev = q.device
    dead = _dead(B, S, kv_mask, causal, dev)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float().unsqueeze(-1)).masked_fill(dead, 0.0)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    pd = p
    if dropout > 0.0:
        keep = _keep_tile(seed, B, H, S, 1.0 - dropout, dev)
        keep_f = torch.tensor(1.0 - dropout, dtype=torch.float32, device=dev)
        zero = torch.zeros((), device=dev)
        pd = torch.where(keep, p / keep_f, zero)
        dp = torch.where(keep, dp / keep_f, zero)
    ds = (p * (dp - delta.float().unsqueeze(-1))).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), gh)
    return tuple(_from_bhsd(x.to(dt), layout) for x in (dq, dk, dv))


def flash_attention_bwd_plain(q, k, v, kv_mask, seed, o, lse, g,
                              causal=False, dropout=0.0, layout="BHSD"):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    for the forward's output ``o``, its logsumexp ``lse`` ``(B, H, S)`` and
    the output gradient ``g``. Written from the reference's tile formulas
    (``_recompute_tile``/``_bwd_tile_ds``), not through autograd: P =
    exp(S*scale - LSE) with dead positions 0, then Pdrop and dP under the
    keep bits, dS = P * (dP - delta) with delta = rowsum(dO * O), and dS and
    Pdrop rounded to the operand type before their products."""
    return _bwd_plain(q, k, v, g, lse, _delta(g, o, layout), kv_mask, seed,
                      causal, dropout, layout)


# ------------------------------------------------------------------ kernels

_fns = {}


def _kernel(name):
    """The ctypes handle of one kernel entry point, bound at first use."""
    fn = _fns.get(name)
    if fn is None:
        from .. import _build
        P, LL, I, U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint)
        if name == "flash_attn_fwd":
            fn = _build.load("flash_attn_fwd").flash_attn_fwd
            fn.argtypes = [P, P, P, P, P, P] + [LL] * 13 + \
                [I, I, I, I, I, ctypes.c_float, I, I, ctypes.c_float, U, U, P]
        else:
            fn = getattr(_build.load("flash_attn_bwd"), name)
            fn.argtypes = [P] * 11 + [LL, I, I, I, I, I, ctypes.c_float,
                                      I, I, ctypes.c_float, U, U, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def _bsh_strides(x, layout):
    """(batch, seq, head) element strides of a 4-D tensor."""
    if layout == "BSHD":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _check(q, k, v, layout):
    """Validate the operands of a kernel; ``(q, k, v, B, H, S, D)`` with k
    and v in q's type and every head row contiguous and 16-byte aligned
    (:func:`_aligned`)."""
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
    q, k, v = (_aligned(x) for x in (q, k, v))
    return q, k, v, B, H, S, D


def _aligned(x):
    """``x`` as the kernels read it: every head row D contiguous elements
    starting on a 16-byte boundary (the base and every stride of a dimension
    longer than 1 a multiple of 16 bytes), which every kernel's 16-byte
    ``cp.async`` copies need. Any other view is copied into a contiguous
    tensor: the operand is normalised, and the kernel still runs."""
    item = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            st * item % 16 == 0
            for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _mask_arg(kv_mask, B, S, device):
    """``(int32 mask or None, its batch stride)``; the caller keeps the
    tensor alive across the launch."""
    if kv_mask is None:
        return None, 0
    if tuple(kv_mask.shape) != (B, S):
        raise ValueError("kv_mask must be (B, S) = %s, got %s"
                         % ((B, S), tuple(kv_mask.shape)))
    kv_mask = kv_mask.to(device=device, dtype=torch.int32).contiguous()
    return kv_mask, kv_mask.stride(0)


def _launch(q, k, v, kv_mask, seed, causal, dropout, layout):
    q, k, v, B, H, S, D = _check(q, k, v, layout)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    mask, mask_sb = _mask_arg(kv_mask, B, S, q.device)
    keep = 1.0 - float(dropout)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel("flash_attn_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(),
            *_bsh_strides(q, layout), *_bsh_strides(k, layout),
            *_bsh_strides(v, layout), *_bsh_strides(out, layout), mask_sb,
            B, H, S, D, int(q.dtype == torch.bfloat16), _scale(D),
            int(bool(causal)), int(dropout > 0.0), float(np.float32(keep)),
            _threshold(keep), (0 if seed is None else int(seed)) & _M32,
            stream)
    if err != 0:
        raise RuntimeError("flash_attn_fwd launch failed: cudaError %d" % err)
    return out, lse


def _bwd_launch(name, q, k, v, g, lse, delta, kv_mask, seed, causal,
                dropout, layout):
    """Launch ``flash_attn_bwd_dq`` (returns dq) or ``flash_attn_bwd_dkv``
    (returns dk, dv)."""
    q, k, v, B, H, S, D = _check(q, k, v, layout)
    g = g.to(q.dtype)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError("output gradient %s on %s does not match q %s on %s"
                         % (tuple(g.shape), g.device, tuple(q.shape),
                            q.device))
    g = _aligned(g)
    rows = []
    for what, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (B, H, S):
            raise ValueError("%s must be (B, H, S) = %s, got %s"
                             % (what, (B, H, S), tuple(x.shape)))
        rows.append(x.to(device=q.device, dtype=torch.float32).contiguous())
    lse, delta = rows

    def new():
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    dkv = name == "flash_attn_bwd_dkv"
    dq, dk, dv = (None, new(), new()) if dkv else (new(), None, None)
    strides = []
    for x in (q, k, v, g, dq, dk, dv):
        strides += _bsh_strides(x, layout) if x is not None else (0, 0, 0)
    strides = (ctypes.c_longlong * len(strides))(*strides)
    mask, mask_sb = _mask_arg(kv_mask, B, S, q.device)
    keep = 1.0 - float(dropout)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name)(
            ptr(q), ptr(k), ptr(v), ptr(g), ptr(lse), ptr(delta), ptr(mask),
            ptr(dq), ptr(dk), ptr(dv), strides, mask_sb, B, H, S, D,
            int(q.dtype == torch.bfloat16), _scale(D), int(bool(causal)),
            int(dropout > 0.0), float(np.float32(keep)), _threshold(keep),
            (0 if seed is None else int(seed)) & _M32, stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))
    return (dk, dv) if dkv else dq


def _on_card(x):
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError("flash attention runs on CUDA or CPU tensors, not %s"
                       % x.device)


def flash_attention_bwd_dq(q, k, v, g, lse, delta, kv_mask=None, seed=None,
                           causal=False, dropout=0.0, layout="BHSD"):
    """dQ from the output gradient ``g``, the forward's logsumexp ``lse``
    and ``delta = rowsum(dO * O)`` (both ``(B, H, S)`` fp32), in
    ``layout``. The dQ kernel on CUDA tensors; the plain version on CPU
    ones."""
    if not _on_card(q):
        return _bwd_plain(q, k, v, g, lse, delta, kv_mask, seed, causal,
                          dropout, layout)[0]
    dq = _bwd_launch("flash_attn_bwd_dq", q, k, v, g, lse, delta, kv_mask,
                     seed, causal, dropout, layout)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_layout[layout] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, kv_mask=None, seed=None,
                            causal=False, dropout=0.0, layout="BHSD"):
    """``(dK, dV)``; arguments as :func:`flash_attention_bwd_dq`. The dK/dV
    kernel on CUDA tensors; the plain version on CPU ones."""
    if not _on_card(q):
        return _bwd_plain(q, k, v, g, lse, delta, kv_mask, seed, causal,
                          dropout, layout)[1:]
    dkv = _bwd_launch("flash_attn_bwd_dkv", q, k, v, g, lse, delta, kv_mask,
                      seed, causal, dropout, layout)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_layout[layout] += 1
    return dkv


def flash_attention_bwd(q, k, v, kv_mask, seed, o, lse, g, causal=False,
                        dropout=0.0, layout="BHSD"):
    """``(dq, dk, dv)`` of attention with the forward's output ``o`` and
    logsumexp ``lse``: delta by a torch reduction, then the dQ and the
    dK/dV kernels on CUDA tensors; :func:`flash_attention_bwd_plain` on CPU
    ones."""
    if not _on_card(q):
        return flash_attention_bwd_plain(q, k, v, kv_mask, seed, o, lse, g,
                                         causal, dropout, layout)
    delta = _delta(g, o, layout)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, kv_mask, seed,
                                causal, dropout, layout)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, kv_mask, seed,
                                     causal, dropout, layout)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or plain forward on the CPU) with the backward
    kernels (or plain backward) as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, causal, dropout, layout,
                wrapper):
        if _on_card(q):
            out, lse = _launch(q, k, v, kv_mask, seed, causal, dropout,
                               layout)
            wrapper.launches += 1
        else:
            out, lse = flash_attention_plain(q, k, v, kv_mask, seed, causal,
                                             dropout, layout=layout,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (seed, causal, dropout, layout)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        seed, causal, dropout, layout = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, seed, out, lse, g,
                                         causal, dropout, layout)
        return dq, dk, dv, None, None, None, None, None, None


def _dispatch(wrapper, q, k, v, kv_mask, seed, causal, dropout, layout,
              return_lse):
    _on_card(q)
    # cast outside the Function, so that autograd returns dk/dv in k's and
    # v's own types
    out, lse = _FlashAttention.apply(q, k.to(q.dtype), v.to(q.dtype),
                                     kv_mask, seed, causal, dropout, layout,
                                     wrapper)
    return (out, lse) if return_lse else out


def flash_attention_bshd(q, k, v, kv_mask=None, seed=None, causal=False,
                         dropout=0.0, return_lse=False):
    """Exact attention over ``(B, S, H, D)`` tensors (the transformer's
    layout straight out of the qkv projection), with the TPU kernel's
    signature. ``kv_mask`` ``(B, S)``, nonzero = attend; ``seed`` int32 for
    attention dropout. Returns ``(B, S, H, D)`` (and the ``(B, H, S)``
    logsumexp with ``return_lse``). Differentiable in q, k and v."""
    return _dispatch(flash_attention_bshd, q, k, v, kv_mask, seed, causal,
                     dropout, "BSHD", return_lse)


def flash_attention(q, k, v, kv_mask=None, seed=None, causal=False,
                    dropout=0.0, return_lse=False):
    """Exact attention over ``(B, H, S, D)`` tensors; same semantics as
    :func:`flash_attention_bshd`."""
    return _dispatch(flash_attention, q, k, v, kv_mask, seed, causal,
                     dropout, "BHSD", return_lse)


_WRAPPERS = (flash_attention_bshd, flash_attention, flash_attention_bwd_dq,
             flash_attention_bwd_dkv)
_BWD_WRAPPERS = (flash_attention_bwd_dq, flash_attention_bwd_dkv)


def reset_launches():
    """Set every kernel wrapper's launch count to 0 (the backward ones'
    counts by layout too)."""
    for w in _WRAPPERS:
        w.launches = 0
    for w in _BWD_WRAPPERS:
        w.launches_by_layout = {"BSHD": 0, "BHSD": 0}


reset_launches()
