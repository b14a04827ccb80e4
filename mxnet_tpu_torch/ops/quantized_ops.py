"""The INT8 quantization op family: counterpart of
``mxnet_tpu/ops/quantized_ops.py``.

Thirteen ops, each also under its ``_contrib_`` name: ``quantize``,
``quantize_v2``, ``dequantize``, ``requantize``, ``quantized_fully_
connected``, ``quantized_conv``, ``quantized_pooling``, ``quantized_act``,
``quantized_flatten``, ``quantized_elemwise_add``, ``quantized_concat``,
``quantized_batch_norm`` and ``calibrate_entropy``. The reference's range
convention: int8 is symmetric, scale ``max(|min|, |max|) / 127``; uint8 is
affine over ``[min, max]`` in 255 steps; an int32 accumulator carries the
range ``±(2^31 - 1) * s_data * s_weight``; every range travels as a (1,)
float32 tensor.

The products ``int8 x int8`` are summed in int32 and are exact, so they
match the reference bit for bit:

- ``quantized_fully_connected`` is one ``torch._int_mm`` (cuBLASLt's int8
  GEMM on the card);
- ``quantized_conv`` is an im2col (``F.unfold`` over the int8 values held
  in float16 on the card, which holds them exactly) and the same GEMM.

On the card ``_int_mm`` wants more than 16 rows and a contraction and a
width that are multiples of 8: :func:`int8_matmul` pads with zero rows and
columns, which adds nothing (ResNet-50's stem contracts 3·7·7 = 147).
:func:`int8_matmul_plain` is the plain version (a float64 product: each
sum stays under 2^53). The scalings divide by 0-d tensors on the data's
device, as the reference divides (the card multiplies by the reciprocal of
a Python scalar), and round half to even (``torch.round``).
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from .registry import get_op, register

__all__ = ["int8_matmul", "int8_matmul_plain"]

_INT32_MAX = float(2 ** 31 - 1)


def _t(v, like):
    """A float32 0-d tensor of ``v`` on ``like``'s device (filled there,
    so that a CUDA-graph capture may make it)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(like.device, torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _maxabs(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def _r1(v):
    return v.reshape(1).to(torch.float32)


def _floor(v, eps):
    return torch.maximum(v, torch.full_like(v, eps))


def _float(data):
    """``data`` in the type a float32 scale promotes it to."""
    return data.to(torch.promote_types(data.dtype, torch.float32))


def _to_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


# ---- (de)quantize ----------------------------------------------------------

def _quantize(data, mn, mx, out_type):
    x = _float(data)
    if out_type == "uint8":
        scale = _floor((mx - mn) / _t(255.0, mn), 1e-12)
        q = torch.clamp(torch.round((x - mn) / scale), 0, 255)
        return q.to(torch.uint8), _r1(mn), _r1(mx)
    amax = _floor(_maxabs(mn, mx), 1e-12)
    return _to_int8(x, amax / _t(127.0, amax)), _r1(-amax), _r1(amax)


@register("_contrib_quantize_v2", aliases=("quantize_v2",), n_out=3,
          differentiable=False)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float -> int8/uint8 with its (1,) range tensors; without a
    calibrated range, the data's own min and max."""
    if min_calib_range is None or max_calib_range is None:
        mn = data.min().to(torch.float32)
        mx = data.max().to(torch.float32)
    else:
        mn, mx = _t(min_calib_range, data), _t(max_calib_range, data)
    return _quantize(data, mn, mx, out_type)


@register("_contrib_quantize", aliases=("quantize",), n_out=3,
          differentiable=False)
def quantize(data, min_range, max_range, out_type="uint8"):
    """As ``quantize_v2``, with the range given as (1,) tensors."""
    return _quantize(data, _t(min_range, data), _t(max_range, data),
                     out_type)


@register("_contrib_dequantize", aliases=("dequantize",),
          differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    mn, mx = _t(min_range, data), _t(max_range, data)
    if data.dtype == torch.uint8:
        scale = _floor((mx - mn) / _t(255.0, mn), 1e-12)
        return data.to(torch.float32) * scale + mn
    top = _INT32_MAX if data.dtype == torch.int32 else 127.0
    return data.to(torch.float32) * (_maxabs(mn, mx) / _t(top, mn))


def _amax_of(real, min_calib_range, max_calib_range):
    if min_calib_range is not None and max_calib_range is not None:
        return _t(max(abs(float(min_calib_range)),
                      abs(float(max_calib_range))), real)
    return _floor(real.abs().max(), 1e-12)


@register("_contrib_requantize", aliases=("requantize",), n_out=3,
          differentiable=False)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8, in a calibrated range when given."""
    real = dequantize.fn(data, min_range, max_range)
    amax = _amax_of(real, min_calib_range, max_calib_range)
    return _to_int8(real, amax / _t(127.0, amax)), _r1(-amax), _r1(amax)


# ---- int8 compute ----------------------------------------------------------

def int8_matmul(a, b):
    """``a (m, k) @ b (n, k)^T`` of int8 matrices in int32, exact: one
    ``torch._int_mm``, padded on the card to its shape rules (more than
    16 rows, k and n multiples of 8) with zeros."""
    m, k = a.shape
    n = b.shape[0]
    if a.is_cuda:
        kp, npad, mp = -k % 8, -n % 8, max(0, 17 - m)
        if kp or mp:
            a = F.pad(a, (0, kp, 0, mp))
        if kp or npad:
            b = F.pad(b, (0, kp, 0, npad))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if out.shape != (m, n) else out


def int8_matmul_plain(a, b):
    """:func:`int8_matmul`'s plain version: a float64 product (exact)."""
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64).t()).to(torch.int32)


def _i32_ranges(min_d, max_d, min_w, max_w, like):
    c = _t(127.0, like)
    s = (_maxabs(_t(min_d, like), _t(max_d, like)) / c) * \
        (_maxabs(_t(min_w, like), _t(max_w, like)) / c)
    amax = s * _INT32_MAX
    return s, _r1(-amax), _r1(amax)


def _bias_to_i32(bias, min_b, max_b, s_out):
    sb = _maxabs(_t(min_b, s_out), _t(max_b, s_out)) / _t(127.0, s_out)
    return torch.round(bias.to(torch.float32) * (sb / s_out)).to(torch.int32)


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",), n_out=3,
          differentiable=False)
def quantized_fully_connected(data, weight, bias=None, min_data=0.0,
                              max_data=0.0, min_weight=0.0, max_weight=0.0,
                              min_bias=0.0, max_bias=0.0, num_hidden=0,
                              no_bias=False, flatten=True):
    """int8 x int8 -> int32 fully connected layer."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8),
                      weight.to(torch.int8)).reshape(lead + (-1,))
    s_out, mn, mx = _i32_ranges(min_data, max_data, min_weight, max_weight,
                                acc)
    if bias is not None and not no_bias:
        acc = acc + _bias_to_i32(bias, min_bias, max_bias, s_out)
    return acc, mn, mx


def _conv_columns(data, kernel, stride, pad, dilate):
    """im2col of int8 ``data`` (N, C, H, W): ``(N * L, C * kh * kw)``
    int8 rows and the output's spatial shape."""
    hold = torch.float16 if data.is_cuda else torch.float32
    cols = F.unfold(data.to(hold), kernel, dilation=dilate, padding=pad,
                    stride=stride)
    out_hw = [(data.shape[2 + i] + 2 * pad[i] - dilate[i] * (kernel[i] - 1)
               - 1) // stride[i] + 1 for i in range(2)]
    rows = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
    return rows, out_hw


def int8_conv(data, weight, stride, pad, dilate):
    """int8 NCHW/NCW convolution with OIHW/OIW weights, summed in int32."""
    one_d = data.dim() == 3
    if one_d:
        data, weight = data.unsqueeze(2), weight.unsqueeze(2)
        stride, pad, dilate = (1,) + stride, (0,) + pad, (1,) + dilate
    n, o = data.shape[0], weight.shape[0]
    rows, (oh, ow) = _conv_columns(data, tuple(weight.shape[2:]), stride,
                                   pad, dilate)
    acc = int8_matmul(rows, weight.reshape(o, -1).to(torch.int8))
    acc = acc.reshape(n, oh * ow, o).transpose(1, 2).reshape(n, o, oh, ow)
    return acc.squeeze(2) if one_d else acc


@register("_contrib_quantized_conv", aliases=("quantized_conv",), n_out=3,
          differentiable=False)
def quantized_conv(data, weight, bias=None, min_data=0.0, max_data=0.0,
                   min_weight=0.0, max_weight=0.0, min_bias=0.0,
                   max_bias=0.0, kernel=(), stride=(), pad=(), dilate=(),
                   num_filter=0, no_bias=False, layout="NCHW"):
    """int8 convolution summed in int32 (NCHW data, OIHW weights)."""
    nd = data.dim() - 2
    acc = int8_conv(data, weight, tuple(stride) or (1,) * nd,
                    tuple(pad) or (0,) * nd, tuple(dilate) or (1,) * nd)
    s_out, mn, mx = _i32_ranges(min_data, max_data, min_weight, max_weight,
                                acc)
    if bias is not None and not no_bias:
        b = _bias_to_i32(bias, min_bias, max_bias, s_out)
        acc = acc + b.reshape((1, -1) + (1,) * nd)
    return acc, mn, mx


def _pass_range(data, min_data, max_data):
    return _r1(_t(min_data, data)), _r1(_t(max_data, data))


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",),
          n_out=3, differentiable=False)
def quantized_pooling(data, min_data=0.0, max_data=0.0, kernel=(),
                      pool_type="max", stride=(), pad=(),
                      global_pool=False, **kwargs):
    """Pooling on the int8 payload in int32: max exact; avg rounded half to
    even and clipped to the payload's range. The range passes through."""
    pool = get_op("Pooling").fn
    wide = data.to(torch.int32)
    if pool_type == "avg":
        out = pool(wide, kernel=kernel, pool_type="avg", stride=stride,
                   pad=pad, global_pool=global_pool)
        lo, hi = (0, 255) if data.dtype == torch.uint8 else (-127, 127)
        out = torch.clamp(torch.round(out), lo, hi).to(data.dtype)
    else:
        out = pool(wide, kernel=kernel, pool_type="max", stride=stride,
                   pad=pad, global_pool=global_pool).to(data.dtype)
    return (out,) + _pass_range(data, min_data, max_data)


@register("_contrib_quantized_act", aliases=("quantized_act",), n_out=3,
          differentiable=False)
def quantized_act(data, min_data=0.0, max_data=0.0, act_type="relu"):
    if act_type != "relu":
        raise NotImplementedError(
            "quantized_act supports relu only (reference mkldnn parity)")
    out = torch.maximum(data, torch.zeros((), dtype=data.dtype,
                                          device=data.device))
    return (out,) + _pass_range(data, min_data, max_data)


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",),
          n_out=3, differentiable=False)
def quantized_flatten(data, min_data=0.0, max_data=0.0):
    return (data.reshape(data.shape[0], -1),) + \
        _pass_range(data, min_data, max_data)


@register("_contrib_quantized_elemwise_add",
          aliases=("quantized_elemwise_add",), n_out=3,
          differentiable=False)
def quantized_elemwise_add(lhs, rhs, lhs_min=0.0, lhs_max=0.0,
                           rhs_min=0.0, rhs_max=0.0):
    """int8 + int8 -> int32 at a shared scale (the wider range's, over
    2^22: 8 guard bits)."""
    c = _t(127.0, lhs)
    sl = _maxabs(_t(lhs_min, lhs), _t(lhs_max, lhs)) / c
    sr = _maxabs(_t(rhs_min, lhs), _t(rhs_max, lhs)) / c
    s_out = torch.maximum(sl, sr) / _t(1 << 22, lhs)
    acc = torch.round(lhs.to(torch.float32) * (sl / s_out)).to(torch.int32) \
        + torch.round(rhs.to(torch.float32) * (sr / s_out)).to(torch.int32)
    amax = s_out * _INT32_MAX
    return acc, _r1(-amax), _r1(amax)


@register("_contrib_quantized_concat", aliases=("quantized_concat",),
          differentiable=False)
def quantized_concat(*args, num_args=0, dim=1):
    """``num_args`` int8 inputs, then their (min, max) pairs in turn:
    every payload rescaled to the widest range, then concatenated."""
    n = int(num_args) or len(args) // 3
    data, mins, maxs = args[:n], args[n::2][:n], args[n + 1::2][:n]
    c = _t(127.0, data[0])
    scales = [_maxabs(_t(mn, data[0]), _t(mx, data[0])) / c
              for mn, mx in zip(mins, maxs)]
    s_out = scales[0]
    for s in scales[1:]:
        s_out = torch.maximum(s_out, s)
    parts = [torch.clamp(torch.round(d.to(torch.float32) * (s / s_out)),
                         -127, 127).to(torch.int8)
             for d, s in zip(data, scales)]
    amax = s_out * 127.0
    return torch.cat(parts, dim=dim), _r1(-amax), _r1(amax)


@register("_contrib_quantized_batch_norm", aliases=("quantized_batch_norm",),
          n_out=3, differentiable=False)
def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data=0.0, max_data=0.0, eps=1e-3,
                         min_calib_range=None, max_calib_range=None,
                         **kwargs):
    """Inference BatchNorm in float32 on the dequantized data, quantized
    again to int8 (in a calibrated range when given)."""
    s_in = _maxabs(_t(min_data, data), _t(max_data, data)) / _t(127.0, data)
    x = data.to(torch.float32) * s_in
    inv = gamma / torch.sqrt(moving_var + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    y = (x - moving_mean.reshape(shape)) * inv.reshape(shape) + \
        beta.reshape(shape)
    amax = _amax_of(y, min_calib_range, max_calib_range)
    return _to_int8(y, amax / _t(127.0, amax)), _r1(-amax), _r1(amax)


@register("_contrib_calibrate_entropy", aliases=("calibrate_entropy",),
          n_out=2, differentiable=False)
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255,
                      search_stride=1):
    """The KL-divergence threshold search over a histogram, in numpy on
    the host (a copy of the reference's): the threshold ``t`` as the
    range ``(-t, t)``. ``search_stride`` evaluates every stride-th
    candidate."""
    dev = hist.device if isinstance(hist, torch.Tensor) else None

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else _np.asarray(a)
    hist = host(hist).astype(_np.float64)
    edges = host(hist_edges).astype(_np.float64)
    num_bins = hist.size
    centers = (edges[:-1] + edges[1:]) / 2.0
    best_t, best_kl = float(edges[-1]), _np.inf
    for i in range(num_quantized_bins // 2, num_bins + 1,
                   max(1, int(search_stride))):
        t = centers[min(i, num_bins - 1)]
        p = hist[:i].copy()
        outliers = hist[i:].sum()
        if p.size == 0 or p.sum() + outliers == 0:
            continue
        p[-1] += outliers
        factor = max(1, p.size // num_quantized_bins)
        q = _np.zeros_like(p)
        for j in range(0, p.size, factor):
            chunk = p[j:j + factor]
            nz = (chunk > 0).sum()
            if nz:
                q[j:j + factor] = _np.where(chunk > 0, chunk.sum() / nz, 0)
        pm, qm = p / max(p.sum(), 1e-12), q / max(q.sum(), 1e-12)
        mask = (pm > 0) & (qm > 0)
        kl = float((pm[mask] * _np.log(pm[mask] / qm[mask])).sum())
        if kl < best_kl:
            best_kl, best_t = kl, float(abs(t))
    return (torch.tensor([-best_t], dtype=torch.float32, device=dev),
            torch.tensor([best_t], dtype=torch.float32, device=dev))
