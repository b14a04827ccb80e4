"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``FullyConnected``, the exact
``gelu``, ``LayerNorm``, ``log_softmax``, ``Dropout`` (with the reference's
lowbias32 counter-hash mask) and ``dot_product_attention`` (the
``_contrib_dot_product_attention`` op) with its key-mask reduction and
kernel dispatch, which the transformer LM and BERT call; and the vision
ops: ``Convolution``, ``Deconvolution``, ``Pooling``, ``BatchNorm``,
``InstanceNorm`` and ``GroupNorm``; and the rest of the reference's file:
``hard_sigmoid``, ``softmin``, ``SoftmaxActivation``,
``softmax_cross_entropy``, ``L2Normalization``, ``LRN``, ``batch_take``
(jnp's fill for an out-of-range index), ``UpSampling`` and the
``Convolution_v1``/``Pooling_v1`` aliases. Plain functions on tensors.

The vision ops are XLA's in the reference (``lax.conv_general_dilated``,
``lax.reduce_window``, fused elementwise chains), so they run on torch's
own convolutions and pooling (cuDNN on the card). ``BatchNorm`` is taken
op for op as the reference takes it: one-pass batch statistics
(E[x^2] - E[x]^2 in float32, clamped at 0), cast to the moving
statistics' dtype, ``rsqrt`` cast to the data's dtype, and the output in
the data's dtype, because a fused batch norm rounds bfloat16 otherwise.
Max pooling gives a window's gradient whole to its first largest element
in row-major order, as XLA's select-and-scatter does. The reference's two
TPU rewrites that are off by default (``MXTPU_CONV_S2D``,
``MXTPU_MAXPOOL_EQBWD``) and its scheduling barrier
(``MXTPU_BN_BARRIER``) are not ported: they compute the same functions.

``dot_product_attention`` takes the TransformerLM's causal calls (every
prefill and training step) and BERT's non-causal ones, which carry a
``(B, 1, 1, T)`` key mask when a ``valid_len`` is given: both reach the
CUDA flash kernels in the ``(B, S, H, D)`` layout. As in the reference,
``MXNET_FLASH_ATTENTION=0`` or a non-empty ``MXTPU_DISABLE_FLASH`` sends
every call to the plain path. ``MXTPU_DROPOUT_THREEFRY=1``, the reference's
switch to ``jax.random.bernoulli`` dropout masks, is refused: threefry is
not ported.

Each of these, and ``Activation``, ``LeakyReLU``, ``softmax`` and the
activations, is also registered in the op registry
(:mod:`~mxnet_tpu_torch.ops.registry`) under the reference op's name and
arguments, with the reference's state binders (the RNG key words and the
training flag): ``nd.FullyConnected``, ``nd.Dropout``,
``nd._contrib_dot_product_attention`` and the rest call the functions
here, so the registry op of attention reaches the CUDA kernels on the
card in both layouts.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as _config
from .. import random as _random
from . import _collective
from . import core as _core
from .core import _const
from .registry import bind_key, bind_train, register, register_alias
from .flash_attention import (_M32, SUPPORTED_DTYPES, SUPPORTED_HEAD_DIMS,
                              _mul32, _threshold, flash_attention,
                              flash_attention_bshd, lowbias32)

__all__ = ["FullyConnected", "gelu", "LayerNorm", "log_softmax", "Dropout",
           "dot_product_attention", "Activation", "LeakyReLU", "softmax",
           "Convolution", "Deconvolution", "Pooling", "BatchNorm",
           "InstanceNorm", "GroupNorm", "sigmoid", "softrelu",
           "SoftmaxOutput", "hard_sigmoid", "softmin", "SoftmaxActivation",
           "softmax_cross_entropy", "L2Normalization", "LRN", "batch_take",
           "UpSampling"]


def FullyConnected(data, weight, bias=None, flatten=True):
    """``data @ weight.T (+ bias)``; ``weight`` is ``(out, in)``. With
    ``flatten`` the input is flattened to ``(batch, -1)`` first."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


# dtypes in which the reference's rounding after every op shows: there the
# ops below mirror the reference's jax functions op for op. In float32 a
# fused torch op agrees with them within 1e-6 in one kernel (and one
# backward kernel), and is taken.
_PER_OP_DTYPES = (torch.bfloat16, torch.float16)


def _per_op(data):
    return data.dtype in _PER_OP_DTYPES


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu(approximate=False)`` op for op: ``0.5 * x * erfc(-x *
    sqrt(0.5))`` with ``sqrt(0.5)`` rounded to the dtype (``F.gelu``
    rounds bf16 once, one ulp off the reference on ~38% of elements); the
    gradient in one fused kernel."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (0.5 * x) * torch.erfc(x * -_const(math.sqrt(0.5), x))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="none")


def gelu(data):
    """The exact (erf) GELU, ``jax.nn.gelu(approximate=False)``: op for op
    in bf16 and fp16 (:class:`_Gelu`), ``F.gelu`` in float32."""
    if _per_op(data):
        return _Gelu.apply(data)
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


class _LogSoftmax(torch.autograd.Function):
    """``jax.nn.log_softmax`` op for op, rounded where XLA rounds it: the
    shift by the max in the input's dtype; ``exp`` and its sum in float32
    (XLA fuses them into one reduction), the sum rounded to the dtype; then
    ``log`` and the difference in the dtype (``torch.log_softmax`` rounds
    bf16 once, and so differs from the reference by up to a bf16 ulp).
    The gradient in one fused kernel."""

    @staticmethod
    def forward(ctx, x, axis):
        shifted = x - x.amax(dim=axis, keepdim=True)
        total = torch.exp(shifted.float()).sum(dim=axis, keepdim=True)
        y = shifted - torch.log(total.to(x.dtype))
        ctx.save_for_backward(y)
        ctx.axis = axis
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return torch._log_softmax_backward_data(g, y, ctx.axis,
                                                y.dtype), None


def log_softmax(data, axis=-1):
    """``jax.nn.log_softmax``: op for op in bf16 and fp16
    (:class:`_LogSoftmax`), ``torch.log_softmax`` in float32."""
    if _per_op(data):
        return _LogSoftmax.apply(data, axis)
    return torch.log_softmax(data, dim=axis)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` op for op in the input's dtype: ``u = exp(x -
    max)``, then ``u / sum(u)`` (``torch.softmax`` rounds bf16 once). The
    gradient in one fused kernel for one axis, else ``y * (g - sum(g *
    y))``."""

    @staticmethod
    def forward(ctx, x, axis):
        u = torch.exp(x - x.amax(dim=axis, keepdim=True))
        y = u / u.sum(dim=axis, keepdim=True)
        ctx.save_for_backward(y)
        ctx.axis = axis
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        if isinstance(ctx.axis, int):
            return torch._softmax_backward_data(g, y, ctx.axis,
                                                y.dtype), None
        gy = g * y
        return gy - y * gy.sum(dim=ctx.axis, keepdim=True), None


def _softmax(data, axis=-1):
    """``jax.nn.softmax`` over ``axis`` (an int or a tuple): op for op in
    bf16 and fp16 (:class:`_Softmax`), ``torch.softmax`` in float32 over
    one axis."""
    if _per_op(data) or not isinstance(axis, int):
        return _Softmax.apply(data, axis)
    return torch.softmax(data, dim=axis)


class _Sigmoid(torch.autograd.Function):
    """``lax.logistic`` as XLA expands it, ``1 / (1 + exp(-x))`` op for op
    in the input's dtype; its gradient is the reference's ``y * (1 - y)``
    (the expansion's own would give NaN where ``exp(-x)`` overflows)."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * y * (1 - y)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` as jax writes it:
    ``max(x, 0) + log1p(exp(-|x|))`` op for op in the input's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.sigmoid(x)


def sigmoid(data):
    """``jax.nn.sigmoid``: op for op in bf16 and fp16, ``torch.sigmoid``
    in float32."""
    return _Sigmoid.apply(data) if _per_op(data) else torch.sigmoid(data)


def softrelu(data):
    """``jax.nn.softplus``: op for op in bf16 and fp16, ``F.softplus`` in
    float32."""
    return _Softplus.apply(data) if _per_op(data) else F.softplus(data)


def _hash_keep_mask(key, shape, keep_prob, device=None):
    """Counter-hash keep mask of ``shape``: lowbias32 over each element's
    row-major linear index mixed with the key's first and last words,
    ``idx*0x9E3779B9 ^ s0*0x85EBCA6B ^ s1*0xC2B2AE35`` in uint32 (int64
    tensors here), then the threshold. Bit for bit the reference's
    ``ops/nn.py:_hash_keep_mask``."""
    s0, s1 = int(key[0]) & _M32, int(key[-1]) & _M32
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape)) & _M32
    c = _mul32(idx, 0x9E3779B9) ^ ((s0 * 0x85EBCA6B) & _M32) \
        ^ ((s1 * 0xC2B2AE35) & _M32)
    return lowbias32(c) < _threshold(keep_prob)


def Dropout(data, p=0.5, mode="training", axes=(), key=None, train=False):
    """Dropout with the reference op's semantics: identity unless ``train``
    (or ``mode="always"``) and ``p > 0``; else ``data / (1 - p)`` where the
    hash keep mask holds and 0 elsewhere. The mask has size 1 on ``axes``
    and broadcasts there. ``key`` is the two uint32 words; None draws them
    with :func:`mxnet_tpu_torch.random.next_key`.

    Raises :class:`NotImplementedError` when dropout would run under
    ``MXTPU_DROPOUT_THREEFRY=1``, the reference's switch to threefry
    (``jax.random.bernoulli``) masks, which the port does not have."""
    if (not train and mode != "always") or p <= 0.0:
        return data
    if os.environ.get("MXTPU_DROPOUT_THREEFRY", "0") == "1":
        raise NotImplementedError(
            "MXTPU_DROPOUT_THREEFRY=1: threefry dropout masks are not "
            "ported; unset it to draw the lowbias32 counter-hash masks")
    if key is None:
        key = _random.next_key()
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = _hash_keep_mask(key, shape, 1.0 - p, data.device)
    return torch.where(keep, data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype, device=data.device))


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


def _flash_enabled():
    """The reference's ``_flash_enabled``: False when ``MXTPU_DISABLE_FLASH``
    is set to a non-empty value or ``MXNET_FLASH_ATTENTION`` is 0; both are
    read at each call."""
    if os.environ.get("MXTPU_DISABLE_FLASH"):
        return False
    return bool(_config.get("MXNET_FLASH_ATTENTION"))


def _kernel_gate(query, key, value, mask_ok, scaled):
    """The port's own gate for the CUDA flash kernel (not the TPU's VMEM
    and tiling gates): all of

    - the tensors are on a CUDA device;
    - self-attention, ``key.shape == value.shape == query.shape``;
    - the mask reduces to ``(B, S)``;
    - ``scaled``;
    - head_dim in ``SUPPORTED_HEAD_DIMS`` and a supported dtype;
    - :func:`_flash_enabled`: ``MXNET_FLASH_ATTENTION`` set and
      ``MXTPU_DISABLE_FLASH`` unset, both read at each call.

    Every prefill and training step of the transformer LM (causal) and
    every BERT layer (non-causal, with its ``(B, 1, 1, T)`` key mask when a
    ``valid_len`` is given) passes it at full width; the one-token decode
    step (``key.shape != query.shape``) does not."""
    return (query.is_cuda and query.dim() == 4
            and key.shape == query.shape and value.shape == query.shape
            and mask_ok and scaled
            and query.shape[-1] in SUPPORTED_HEAD_DIMS
            and query.dtype in SUPPORTED_DTYPES
            and _flash_enabled())


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
        scores = scores / _const(math.sqrt(query.shape[-1]), scores)
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
    w = _softmax(scores, -1)
    if drop > 0.0:
        # drawn where the generator lives (a CPU generator may serve a
        # CUDA tensor)
        dev = w.device if generator is None else generator.device
        keep = torch.rand(w.shape, generator=generator, device=dev,
                          dtype=torch.float32).to(w.device) < (1.0 - drop)
        w = torch.where(keep, w / (1.0 - drop), torch.zeros_like(w))
    return torch.matmul(w, value)


# ---- vision ops ------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _pair(v, n):
    """The reference's ``_pair``: an int or a sequence as an ``n``-tuple;
    None or an empty sequence gives ones."""
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if t else (1,) * n


def _bias_shape(bias, n):
    return bias.reshape((1, -1) + (1,) * n)


def Convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=None):
    """1-D, 2-D or 3-D convolution of ``(N, C, *spatial)`` data with a
    ``(O, C / num_group, *kernel)`` weight: symmetric ``pad``, ``stride``,
    ``dilate``, grouped by ``num_group``. The bias is added after the
    convolution, as the reference adds it."""
    n = data.dim() - 2
    pad = _pair(pad, n) if pad else (0,) * n
    out = _CONV[n](data, weight, None, _pair(stride, n), pad,
                   _pair(dilate, n), num_group)
    if not no_bias and bias is not None:
        out = out + _bias_shape(bias, n)
    return out


def Deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                  layout=None, target_shape=None, cudnn_tune=None,
                  cudnn_off=False, workspace=None):
    """Transposed convolution with MXNet's ``(C_in, C_out / num_group,
    *kernel)`` weight: the output size is ``(in - 1) * stride - 2 * pad +
    dilate * (kernel - 1) + 1 + adj``. ``target_shape`` is ignored, as in
    the reference."""
    n = data.dim() - 2
    pad = _pair(pad, n) if pad else (0,) * n
    adj = _pair(adj, n) if adj else (0,) * n
    out = _DECONV[n](data, weight, None, _pair(stride, n), pad, adj,
                     num_group, _pair(dilate, n))
    if not no_bias and bias is not None:
        out = out + _bias_shape(bias, n)
    return out


def _window_sum(x, kernel, stride):
    """Sums over the windows of ``x`` (already padded). In bf16 and fp16
    as the reference's ``reduce_window`` takes them: from 0, adding each
    window's elements in row-major order, each sum rounded to the dtype (a
    pooling kernel accumulates in float32 and rounds once); in float32 one
    pooling kernel (exact to float32's rounding)."""
    n = len(kernel)
    if not _per_op(x) and x.is_floating_point():
        if n == 1:
            return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel,
                                (1,) + stride, divisor_override=1).squeeze(2)
        pool = F.avg_pool2d if n == 2 else F.avg_pool3d
        return pool(x, kernel, stride, divisor_override=1)
    return _window_reduce(x, kernel, stride, torch.add)


def _window_reduce(x, kernel, stride, op):
    """``op`` folded over each window of ``x`` (already padded), one
    strided slice an offset, in row-major order: exact for integers."""
    n = len(kernel)
    lead = x.dim() - n
    outs = [(x.shape[lead + i] - kernel[i]) // stride[i] + 1
            for i in range(n)]
    total = None
    for offs in np.ndindex(*kernel):
        idx = (slice(None),) * lead + tuple(
            slice(o, o + (m - 1) * s + 1, s)
            for o, m, s in zip(offs, outs, stride))
        total = x[idx] if total is None else op(total, x[idx])
    return total


def Pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            p_value=2, count_include_pad=True, layout=None):
    """``max``, ``avg``, ``sum`` or ``lp`` pooling over the spatial axes,
    with the reference's windows: ``pad`` on both sides, and under
    ``pooling_convention="full"`` enough extra padding at the high edge for
    a last partial window (ceil mode; ``avg`` with ``count_include_pad``
    then still divides by the whole kernel, as the reference does).
    ``avg`` without ``count_include_pad`` divides by the window's count of
    real elements. ``global_pool`` reduces every spatial axis. Integer
    data pools exactly and averages in the reference's dtypes (float64
    with ``count_include_pad``, else float32)."""
    n = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=dims, keepdim=True)
        if pool_type == "lp":
            return data.abs().pow(p_value).sum(dim=dims, keepdim=True) \
                .pow(1.0 / p_value)
        if not data.is_floating_point():
            # as the reference's jnp.mean: a float32 sum times the float32
            # reciprocal of the count (XLA's division by a constant)
            count = int(np.prod([data.shape[d] for d in dims]))
            return data.to(torch.float32).sum(dim=dims, keepdim=True) * \
                torch.full((), np.float32(1.0 / count), dtype=torch.float32,
                           device=data.device)
        return data.mean(dim=dims, keepdim=True)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type %s" % pool_type)
    kernel, stride = _pair(kernel, n), _pair(stride, n)
    pad = _pair(pad, n) if pad else (0,) * n
    high = list(pad)
    if pooling_convention == "full":
        for i in range(n):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                high[i] += stride[i] - rem
    widths = tuple(w for i in reversed(range(n)) for w in (pad[i], high[i]))
    if pool_type == "max":
        if not data.is_floating_point():
            return _window_reduce(
                F.pad(data, widths, value=torch.iinfo(data.dtype).min),
                kernel, stride, torch.maximum)
        if tuple(high) == pad and all(2 * p <= k
                                      for p, k in zip(pad, kernel)):
            return _MAXPOOL[n](data, kernel, stride, pad)
        fill = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAXPOOL[n](F.pad(data, widths, value=fill), kernel, stride)
    x = data.abs().pow(p_value) if pool_type == "lp" else data
    s = _window_sum(F.pad(x, widths), kernel, stride)
    if pool_type == "sum":
        return s
    if pool_type == "lp":
        return s.pow(1.0 / p_value)
    if count_include_pad:
        if not s.is_floating_point():     # a 0-d divisor: see optim_ops
            s = s.to(torch.float64)
            return s / torch.full((), float(np.prod(kernel)),
                                  dtype=s.dtype, device=s.device)
        return s / float(np.prod(kernel))
    ones = F.pad(torch.ones_like(data), widths)
    if not s.is_floating_point():
        s = s.to(torch.float32)
    return s / _window_sum(ones, kernel, stride)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False,
              min_calib_range=None, max_calib_range=None, train=False):
    """Batch normalization, op for op the reference's: in training (and
    without ``use_global_stats``) the batch mean and the one-pass variance
    ``max(E[x^2] - E[x]^2, 0)`` over every axis but ``axis``, taken in
    float32 and cast to the moving statistics' dtype; otherwise the moving
    statistics. ``rsqrt(var + eps)`` is cast to the data's dtype, and
    ``(x - mean) * inv * gamma + beta`` is computed in it (``gamma`` = 1
    under ``fix_gamma``). The moving statistics are not updated here: the
    ``BatchNorm`` layer writes them. ``output_mean_var`` also returns the
    mean and variance. Inside a mesh step (``ShardedTrainer`` over data
    axes) the two moments are averaged over the step's replicas, so they
    are the global batch's, as in the reference's SPMD program."""
    dims = tuple(i for i in range(data.dim()) if i != axis % data.dim())
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_global_stats or not train:
        mean, var = moving_mean, moving_var
    else:
        xf = data.float()
        mean = xf.mean(dim=dims)
        sq = (xf * xf).mean(dim=dims)
        # in a mesh step's replica: the moments of the global batch
        mean, sq = _collective.batch_mean((mean, sq))
        var = torch.clamp_min(sq - mean * mean, 0.0)
        mean = mean.to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
    dt = data.dtype
    inv = torch.rsqrt(var + eps).to(dt)
    out = (data - mean.reshape(shape).to(dt)) * inv.reshape(shape) \
        * g.reshape(shape).to(dt) + beta.reshape(shape).to(dt)
    if output_mean_var:
        return out, mean, var
    return out


def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Normalization over each sample's and channel's spatial axes (biased
    variance), then ``gamma`` and ``beta`` per channel."""
    dims = tuple(range(2, data.dim()))
    mean = data.mean(dim=dims, keepdim=True)
    var = data.var(dim=dims, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalization over each sample's groups of ``C / num_groups``
    channels (biased variance), then ``gamma`` and ``beta`` per
    channel."""
    b, c = data.shape[:2]
    x = data.reshape((b, num_groups, c // num_groups) + tuple(data.shape[2:]))
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


# ---- registry ops (the reference's names and arguments) -------------------

def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    return FullyConnected(data, weight, None if no_bias else bias, flatten)


def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    out = LayerNorm(data, gamma, beta, axis, eps)
    if output_mean_var:
        return (out, data.mean(dim=axis),
                data.var(dim=axis, unbiased=False))
    return out


def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             key=None, train=False):
    return Dropout(data, p, mode, axes, key, train)


def Activation(data, act_type="relu"):
    """``relu``, ``sigmoid``, ``tanh``, ``softrelu`` or ``softsign``."""
    fns = {"relu": _core.relu.fn, "sigmoid": sigmoid,
           "tanh": torch.tanh, "softrelu": softrelu,
           "softsign": F.softsign}
    if act_type not in fns:
        raise ValueError("unknown act_type %s" % act_type)
    return fns[act_type](data)


def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, key=None, train=False):
    """The reference's ``leaky``, ``prelu``, ``elu``, ``selu``, ``gelu``
    and ``rrelu`` variants. ``rrelu`` in training scales each negative
    element by its own slope drawn uniformly from ``[lower_bound,
    upper_bound)`` with the generator of the key words ``key``
    (``random_ops.generator_for``: one key gives one draw; threefry is not
    ported, so the draws are not the reference's), outside training by the
    bounds' mean. The scalars are rounded to ``data``'s dtype first, as
    the reference's weakly typed ones are."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if act_type == "leaky":
        return torch.where(data > zero, data, _const(slope, data) * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > zero, data, g * data)
    if act_type == "elu":
        return torch.where(data > zero, data,
                           _const(slope, data) * torch.expm1(data))
    if act_type == "selu":
        alpha = _const(1.6732632423543772, data)
        scale = _const(1.0507009873554805, data)
        return scale * torch.where(data > zero, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return gelu(data)
    if act_type == "rrelu":
        if train:
            from .random_ops import generator_for
            from .registry import bind_key
            gen = generator_for(data.device,
                                bind_key() if key is None else key)
            u = torch.rand(data.shape, generator=gen, device=data.device)
            u = (lower_bound + u * (upper_bound - lower_bound)).to(data.dtype)
            return torch.where(data > zero, data, u * data)
        return torch.where(data > zero, data,
                           _const((lower_bound + upper_bound) / 2.0, data)
                           * data)
    raise ValueError("unknown act_type %s" % act_type)


def softmax(data, axis=-1, length=None, temperature=None, dtype=None,
            use_length=False):
    """The reference's ``softmax`` (op for op, :func:`_softmax`; ``axis``
    may be a tuple): with ``use_length`` the positions at or past
    ``length`` along ``axis`` give 0."""
    from ..base import torch_dtype
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if use_length and length is not None:
        shp = [1] * x.dim()
        shp[axis] = x.shape[axis]
        steps = torch.arange(x.shape[axis], device=x.device).reshape(shp)
        keep = steps < length.unsqueeze(axis)
        out = _softmax(x.masked_fill(~keep, float("-inf")), axis)
        return out.masked_fill(~keep, 0.0)
    out = _softmax(x, axis if isinstance(axis, int) else tuple(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


def _log_softmax(data, axis=-1, temperature=None, dtype=None,
                 use_length=False, length=None):
    from ..base import torch_dtype
    x = data if temperature in (None, 1.0) else data / temperature
    out = log_softmax(x, axis)
    return out.to(torch_dtype(dtype)) if dtype else out


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the loss layer's own backward, whatever gradient
    reaches it: ``(softmax - one_hot(label)) * grad_scale``, zero where
    the label is ``ignore_label`` under ``use_ignore``. The label takes
    no gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                axis):
        out = _softmax(data, axis)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, axis = ctx.args
        depth = out.shape[axis]
        idx = label.long()
        # an index outside [0, depth) one-hots to a zero row, as jax's
        hot = F.one_hot(idx.clamp(0, depth - 1), depth).to(out.dtype) \
            * ((idx >= 0) & (idx < depth)).unsqueeze(-1).to(out.dtype)
        grad = (out - hot.movedim(-1, axis)) * grad_scale
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype).unsqueeze(axis)
            grad = grad * keep
        return grad, None, None, None, None, None


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """The softmax loss layer (over axis 1 with ``multi_output``, else
    the last): the forward is ``softmax``, the backward the loss's own
    gradient (:class:`_SoftmaxOutput`); a ``Module`` scales it by
    ``1 / batch_size`` through the optimizer's ``rescale_grad``."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                1 if multi_output else -1)


def _key_generator(rng_key):
    """A CPU ``torch.Generator`` seeded from the op's two key words: the
    plain path's dropout draws and the kernel's int32 seed come from it.
    Torch's CPU generator keeps only 32 bits of a seed, so both words are
    mixed into those 32 (a golden-ratio multiply of the last word, xored
    with the first)."""
    s0, s1 = int(rng_key[0]) & _M32, int(rng_key[-1]) & _M32
    return torch.Generator().manual_seed((s0 ^ (s1 * 0x9E3779B9)) & _M32)


def _attention_op(query, key, value, mask=None, dropout=0.0, scaled=True,
                  causal=False, layout="BHSD", rng_key=None, train=False):
    generator = None
    if train and dropout > 0.0 and rng_key is not None:
        generator = _key_generator(rng_key)
    return dot_product_attention(query, key, value, mask=mask,
                                 dropout=dropout, scaled=scaled,
                                 causal=causal, layout=layout,
                                 generator=generator, train=train)


register("FullyConnected", aliases=("fully_connected",))(_fully_connected)
register("LayerNorm", aliases=("layer_norm",))(_layer_norm)
register("Dropout", aliases=("dropout",),
         state_binders={"key": bind_key, "train": bind_train})(_dropout)
register("Activation", aliases=("activation",))(Activation)
register("LeakyReLU", state_binders={"key": bind_key,
                                     "train": bind_train})(LeakyReLU)
register("gelu", aliases=("LeakyReLU_gelu", "_contrib_gelu"))(gelu)
register("softmax")(softmax)
register("log_softmax")(_log_softmax)
register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))(SoftmaxOutput)
register("softrelu")(softrelu)
register("sigmoid")(sigmoid)
register("softsign")(F.softsign)
register("_contrib_dot_product_attention",
         state_binders={"rng_key": bind_key,
                        "train": bind_train})(_attention_op)
register("Convolution", aliases=("convolution",))(Convolution)
register("Deconvolution", aliases=("deconvolution",))(Deconvolution)
register("Pooling", aliases=("pooling",))(Pooling)
register("BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
         state_binders={"train": bind_train})(BatchNorm)
register("InstanceNorm")(InstanceNorm)
register("GroupNorm")(GroupNorm)
register_alias("Convolution", "Convolution_v1")
register_alias("Pooling", "Pooling_v1")


# ---- the rest of the reference's nn.py: small functions -------------------


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(_const(alpha, data) * data + _const(beta, data),
                       0.0, 1.0)


@register("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("SoftmaxActivation")
def SoftmaxActivation(data, mode="instance"):
    """Softmax over the channel axis (``mode="channel"``) or over each
    instance's flattened values."""
    if mode == "channel":
        return _softmax(data, 1)
    return _softmax(data.reshape(data.shape[0], -1), -1).reshape(data.shape)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed negative log-likelihood of the labels; a label below 0
    adds nothing (the native RecordIO reader marks a corrupt record -1)."""
    from . import _jnp
    logp = log_softmax(data, -1)
    idx = _jnp.astype(label, torch.int32)
    nll = -_jnp.take_fill(logp, idx.clamp(min=0)[:, None], -1)
    return torch.where(idx[:, None] >= 0, nll,
                       torch.zeros((), dtype=nll.dtype,
                                   device=nll.device)).sum()


@register("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.square(data).sum(axes, keepdim=True)
                             + _const(eps, data))


@register("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: the window's squares
    summed one shifted slice at a time, as the reference sums them."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = torch.zeros_like(data)
    for i in range(nsize):
        acc = acc + padded[:, i:i + data.shape[1]]
    return data / torch.pow(_const(knorm, data)
                            + _const(alpha / nsize, data) * acc,
                            _const(beta, data))


@register("batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` for each row; an index in ``[-n, 0)`` wraps and
    one outside ``[-n, n)`` gives ``jnp.take``'s fill value."""
    from . import _jnp
    idx = _jnp.astype(indices, torch.int32).reshape(-1, 1)
    return _jnp.take_fill(a, idx, 1).reshape(-1)


@register("UpSampling")
def UpSampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=None):
    """Nearest (repeat) or bilinear (``jax.image.resize``'s weights, as
    ``_image_resize``) upsampling of NCHW data by ``scale``."""
    x = data[0]
    s = int(scale)
    if sample_type == "nearest":
        return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
    from .image_ops import resize_linear
    b, c, h, w = x.shape
    return resize_linear(x, (b, c, h * s, w * s))
