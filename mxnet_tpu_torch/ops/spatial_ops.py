"""Spatial-transform and signal operators: counterpart of
``mxnet_tpu/ops/spatial_ops.py``.

``GridGenerator`` (affine: ``theta (B, 6)`` over the target's ``[-1, 1]``
grid, ``jnp.linspace``'s values; warp: a pixel flow added to the identity
grid and normalised), ``BilinearSampler`` (x = -1 is column 0, x = +1
column W - 1, zero outside the map), ``SpatialTransformer`` (the two
together), ``Crop``, ``SVMOutput`` (identity forward; backward injects
the one-vs-all hinge gradient and ignores the incoming one, as the
reference), ``Correlation`` (FlowNet), ``fft``/``ifft`` (the last axis,
complex values interleaved ``[re, im, ...]``; the inverse unnormalised:
``ifft(fft(x)) = d x``), ``count_sketch`` and ``SyncBatchNorm``
(BatchNorm's batch statistics, ``E[x^2] - E[x]^2``, averaged over
``comm_axis`` when it runs inside a mesh step whose data axes hold that
axis, local otherwise).

Sampling is four gathers with piecewise-linear weights, added in the
reference's order, so autograd gives the data and grid gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _collective
from .registry import register
from .tensor_extra import _spaced

__all__ = ["GridGenerator", "BilinearSampler", "SpatialTransformer", "Crop",
           "SVMOutput", "Correlation", "fft", "ifft", "count_sketch",
           "SyncBatchNorm", "sample_bilinear"]


def _linspace(lo, hi, num, dtype, device):
    """``jnp.linspace(lo, hi, num)`` (endpoint included)."""
    if num <= 1:
        return torch.full((num,), lo, dtype=dtype, device=device)
    s = torch.tensor(lo, dtype=dtype, device=device)
    e = torch.tensor(hi, dtype=dtype, device=device)
    return torch.cat([_spaced(s, e, num - 1, dtype, device), e.reshape(1)])


def _affine_grid(theta, H, W):
    """``(B, 6)`` affine -> ``(B, 2, H, W)`` source coordinates in
    ``[-1, 1]``, channel 0 = x."""
    B = theta.shape[0]
    th = theta.reshape(B, 2, 3)
    ys = _linspace(-1.0, 1.0, H, th.dtype, th.device)
    xs = _linspace(-1.0, 1.0, W, th.dtype, th.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tgt = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(H * W, dtype=th.dtype, device=th.device)])
    return torch.matmul(th, tgt).reshape(B, 2, H, W)


@register("GridGenerator", aliases=("grid_generator",))
def GridGenerator(data, transform_type="affine", target_shape=(0, 0)):
    H, W = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        return _affine_grid(data, H, W)
    if transform_type == "warp":
        _, _, Hf, Wf = data.shape
        gy, gx = torch.meshgrid(
            torch.arange(Hf, dtype=data.dtype, device=data.device),
            torch.arange(Wf, dtype=data.dtype, device=data.device),
            indexing="ij")
        x = (gx + data[:, 0]) * (2.0 / max(Wf - 1, 1)) - 1.0
        y = (gy + data[:, 1]) * (2.0 / max(Hf - 1, 1)) - 1.0
        return torch.stack([x, y], dim=1)
    raise ValueError("unknown transform_type %r" % (transform_type,))


def _index(v, hi):
    """A float coordinate clipped to ``[0, hi]`` as an int64 index (NaN to
    0, as jnp's cast)."""
    return torch.nan_to_num(torch.clamp(v, 0, hi), nan=0.0).long()


def sample_bilinear(img, gx, gy):
    """``img (B, C, H, W)`` sampled at absolute pixel coordinates ``gx``,
    ``gy`` ``(B, *S)`` -> ``(B, C, *S)``; zero outside the map (the
    reference's ``_sample_one`` over the batch)."""
    B, C, H, W = img.shape
    flat = img.reshape(B, C, H * W)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    out = torch.zeros((B, C) + tuple(gx.shape[1:]), dtype=img.dtype,
                      device=img.device)
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xi, yi = x0 + dx, y0 + dy
            w = (1.0 - torch.abs(gx - xi)) * (1.0 - torch.abs(gy - yi))
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (_index(yi, H - 1) * W + _index(xi, W - 1)).reshape(B, 1, -1)
            v = torch.gather(flat, 2, idx.expand(B, C, idx.shape[-1]))
            w = torch.where(valid, w, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))
            out = out + w[:, None] * v.reshape(out.shape)
    return out


@register("BilinearSampler", aliases=("bilinear_sampler",))
def BilinearSampler(data, grid, cudnn_off=False):
    """``data (B, C, H, W)`` at ``grid (B, 2, Ho, Wo)``'s normalised
    coordinates."""
    _, _, H, W = data.shape
    gx = (grid[:, 0] + 1.0) * ((W - 1) / 2.0)
    gy = (grid[:, 1] + 1.0) * ((H - 1) / 2.0)
    return sample_bilinear(data, gx, gy)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def SpatialTransformer(data, loc, target_shape=(0, 0),
                       transform_type="affine", sampler_type="bilinear",
                       cudnn_off=False):
    grid = _affine_grid(loc, int(target_shape[0]), int(target_shape[1]))
    return BilinearSampler.fn(data, grid)


@register("Crop", aliases=("crop_v1",))
def Crop(data, crop_like=None, offset=(0, 0), h_w=(0, 0), center_crop=False,
         num_args=1):
    """``(B, C, H, W)`` cropped to ``crop_like``'s H and W, or ``h_w``."""
    _, _, H, W = data.shape
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


class _SVM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, reg, linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        z, label = ctx.saved_tensors
        margin, reg, linear = ctx.args
        k = (label.long()[..., None] == torch.arange(
            z.shape[1], device=z.device)).to(z.dtype)
        if linear:
            pos = -reg * (margin > z).to(z.dtype)
            neg = reg * (margin > -z).to(z.dtype)
        else:
            pos = -reg * 2.0 * torch.clamp_min(margin - z, 0.0)
            neg = reg * 2.0 * torch.clamp_min(margin + z, 0.0)
        return (k * pos + (1.0 - k) * neg).to(z.dtype), None, None, None, \
            None


@register("SVMOutput", aliases=("svm_output",))
def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False):
    return _SVM.apply(data, label, float(margin),
                      float(regularization_coefficient), bool(use_linear))


@register("Correlation", aliases=("correlation",))
def Correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """For every displacement on the ``stride2`` grid, the channel sum of
    the products (or absolute differences) over a ``kernel_size`` window,
    divided by ``K * K * C``: ``(B, D*D, out_h, out_w)``."""
    B, C, H, W = data1.shape
    K = int(kernel_size)
    md, s1, s2, pad = (int(max_displacement), int(stride1), int(stride2),
                       int(pad_size))
    border = md + (K - 1) // 2
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    Hp, Wp = H + 2 * pad, W + 2 * pad
    out_h = -(-(Hp - 2 * border) // s1)
    out_w = -(-(Wp - 2 * border) // s1)
    norm = float(K * K * C)
    ones = torch.ones((1, 1, K, K), dtype=data1.dtype, device=data1.device)
    lo = (K - 1) // 2
    maps = []
    for iy in range(-(md // s2), md // s2 + 1):
        for ix in range(-(md // s2), md // s2 + 1):
            shifted = torch.roll(p2, shifts=(-iy * s2, -ix * s2), dims=(2, 3))
            prod = p1 * shifted if is_multiply else torch.abs(p1 - shifted)
            summed = torch.sum(prod, dim=1)
            if K > 1:
                summed = F.conv2d(F.pad(summed[:, None],
                                        (lo, K - 1 - lo, lo, K - 1 - lo)),
                                  ones)[:, 0]
            win = summed[:, border:border + out_h * s1:s1,
                         border:border + out_w * s1:s1]
            maps.append(win / norm)
    return torch.stack(maps, dim=1)


@register("_contrib_fft", aliases=("fft",))
def fft(data, compute_size=128):
    spec = torch.fft.fft(data.float(), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(data.dtype)


@register("_contrib_ifft", aliases=("ifft",))
def ifft(data, compute_size=128):
    d = data.shape[-1] // 2
    inter = data.float().reshape(data.shape[:-1] + (d, 2))
    spec = torch.complex(inter[..., 0], inter[..., 1])
    return (torch.fft.ifft(spec, dim=-1).real * d).to(data.dtype)


@register("_contrib_count_sketch", aliases=("count_sketch",))
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """``out[b, h[i]] += s[i] * data[b, i]`` (an index outside
    ``[0, out_dim)`` dropped, as ``segment_sum`` drops it)."""
    idx = h.reshape(-1).long()
    sign = s.reshape(-1).to(data.dtype)
    n_out = int(out_dim)
    ok = (idx >= 0) & (idx < n_out)
    vals = torch.where(ok, data * sign, torch.zeros((), dtype=data.dtype,
                                                    device=data.device))
    out = torch.zeros((data.shape[0], n_out), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx.clamp(0, max(n_out - 1, 0)), vals)


@register("_contrib_SyncBatchNorm", aliases=("SyncBatchNorm",), n_out=0)
def SyncBatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                  momentum=0.9, fix_gamma=True, use_global_stats=False,
                  output_mean_var=False, ndev=1, key="", comm_axis="dp",
                  **_ignored):
    sh = (1, -1) + (1,) * (data.dim() - 2)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_global_stats:
        mean, var = moving_mean, moving_var
    else:
        axes = (0,) + tuple(range(2, data.dim()))
        mean = torch.mean(data, dim=axes)
        sq = torch.mean(torch.square(data), dim=axes)
        mean, sq = _collective.batch_mean((mean, sq), axis=comm_axis)
        var = sq - torch.square(mean)
    out = (data - mean.reshape(sh)) * (
        g.reshape(sh) / torch.sqrt(var.reshape(sh) + eps)) + beta.reshape(sh)
    if output_mean_var:
        return out, mean, var
    return (out,)
