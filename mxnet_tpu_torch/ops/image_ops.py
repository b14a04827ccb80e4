"""Image operators (``_image_*``, behind ``nd.image`` and ``npx.image``).

Counterpart of ``mxnet_tpu/ops/image_ops.py`` (``image_random.cc``,
``resize.cc``, ``crop.cc``), with its ``_npx__image_*`` and ``image_*``
aliases. Images are HWC with any leading batch axes (``to_tensor`` makes
them CHW/NCHW float32 in [0, 1]); every op runs on its input's device.

- ``_image_resize`` is ``jax.image.resize``: linear interpolation with
  the triangle filter widened by the inverse scale when it shrinks
  (antialiasing), as two contractions with the same scale-and-translate
  weight matrices (:func:`resize_linear`), or nearest neighbour; the
  result is cast back to the input's dtype as jnp casts
  (:func:`._jnp.astype`: a float-to-uint8 cast truncates and saturates).
- The random ops draw their factor on the device from the key words
  (``random_ops.generator_for``; threefry is not ported, so the draws
  match the reference in distribution), then apply the deterministic
  part, which takes the factor as an argument (:func:`brightness`,
  :func:`contrast`, :func:`saturation`, :func:`hue`, :func:`lighting`).
  Brightness multiplies by a float32 factor, so a uint8 image comes back
  float32, as in the reference; the others cast back to the input's
  dtype.
"""
from __future__ import annotations

import math

import torch

from . import _jnp
from .random_ops import generator_for
from .registry import bind_key, register

__all__ = ["resize_linear", "resize_nearest", "brightness", "contrast",
           "saturation", "hue", "lighting"]

_RNG = {"key": bind_key}
_NPX = "_npx__image_"
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))
_YIQ = ((0.299, 0.587, 0.114),
        (0.596, -0.274, -0.321),
        (0.211, -0.523, 0.311))
_EPS32 = 1.1920928955078125e-07


# ---- resize: jax.image.resize's weights ---------------------------------

def _weight_mat(m, n, device):
    """The (m, n) weights of ``jax.image``'s ``compute_weight_mat`` for
    the triangle kernel, scale ``n / m``, translation 0, antialiased;
    computed in float64 (the reference's dtype for its Python scale)."""
    f64 = torch.float64
    inv = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=f64, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=f64,
                                        device=device)[:, None]).abs() \
        / torch.full((), max(inv, 1.0), dtype=f64, device=device)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    zero = torch.zeros((), dtype=f64, device=device)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)), zero)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, zero)


def resize_linear(x, shape):
    """``jax.image.resize(x, shape, "linear")`` of a floating ``x``: one
    contraction with a weight matrix for each axis whose size changes."""
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        w = _weight_mat(m, n, x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def resize_nearest(x, shape):
    """``jax.image.resize(x, shape, "nearest")``: the float32 offsets
    ``floor((i + 0.5) * m / n)``."""
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        off = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m
                          / torch.full((), float(n), device=x.device))
        x = torch.index_select(x, d, off.long())
    return x


# ---- deterministic ops -----------------------------------------------------

@register("_image_to_tensor", aliases=(_NPX + "to_tensor", "image_to_tensor"))
def _image_to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""
    x = data.to(torch.float32) / torch.full((), 255.0, device=data.device)
    return x.permute(2, 0, 1) if data.dim() == 3 else x.permute(0, 3, 1, 2)


def _channel_param(v, data, c_axis):
    """``mean``/``std`` as a tensor on ``data``'s device (per channel, or
    0-d): a tensor divisor divides exactly on the card too."""
    t = torch.as_tensor(v, dtype=data.dtype, device=data.device)
    if t.dim():
        shape = [1] * data.dim()
        shape[c_axis] = -1
        return t.reshape(-1).reshape(shape)
    return t


@register("_image_normalize", aliases=(_NPX + "normalize", "image_normalize"))
def _image_normalize(data, mean=0.0, std=1.0):
    """``(x - mean) / std`` over the channel axis of CHW/NCHW data."""
    c_axis = 0 if data.dim() == 3 else 1
    return (data - _channel_param(mean, data, c_axis)) / \
        _channel_param(std, data, c_axis)


@register("_image_crop", aliases=(_NPX + "crop", "image_crop"))
def _image_crop(data, x=0, y=0, width=1, height=1):
    x, y = int(x), int(y)
    return data[..., y:y + int(height), x:x + int(width), :]


@register("_image_resize", aliases=(_NPX + "resize", "image_resize"))
def _image_resize(data, size=None, keep_ratio=False, interp=1):
    """Resize HWC/NHWC to ``size`` (an int, or ``(w, h)``): ``interp`` 0
    nearest, else linear (:func:`resize_linear`), in float32, cast back
    to the input's dtype."""
    if isinstance(size, int):
        size = (size, size)
    w, h = int(size[0]), int(size[1])
    shape = (h, w, data.shape[2]) if data.dim() == 3 else \
        (data.shape[0], h, w, data.shape[3])
    x = data.to(torch.float32)
    out = resize_nearest(x, shape) if int(interp) == 0 else \
        resize_linear(x, shape)
    return _jnp.astype(out, data.dtype)


@register("_image_flip_left_right",
          aliases=(_NPX + "flip_left_right", "image_flip_left_right"))
def _image_flip_left_right(data):
    return torch.flip(data, dims=(-2,))


@register("_image_flip_top_bottom",
          aliases=(_NPX + "flip_top_bottom", "image_flip_top_bottom"))
def _image_flip_top_bottom(data):
    return torch.flip(data, dims=(-3,))


def _blend(a, b, w):
    return a * w + b * (1.0 - w)


def _to_gray(x):
    """BT.601 luma over the trailing channel, broadcast back."""
    wts = torch.tensor((0.299, 0.587, 0.114), dtype=x.dtype, device=x.device)
    return (x * wts).sum(-1, keepdim=True).expand(x.shape)


def brightness(data, f):
    """``data * f``, ``f`` a float32 factor (a uint8 image gives
    float32)."""
    f = torch.as_tensor(f, dtype=torch.float32, device=data.device)
    dt = _jnp.result_dtype("promote", data, f)
    return data.to(dt) * f.to(dt)


def contrast(data, f):
    x = data.to(torch.float32)
    mean = _to_gray(x)[..., :1].mean()
    return _jnp.astype(_blend(x, torch.full_like(x, 1.0) * mean, f),
                       data.dtype)


def saturation(data, f):
    x = data.to(torch.float32)
    return _jnp.astype(_blend(x, _to_gray(x), f), data.dtype)


def hue(data, f):
    """A hue rotation by ``f * pi`` in YIQ space."""
    dev = data.device
    f = torch.as_tensor(f, dtype=torch.float32, device=dev)
    theta = f * math.pi
    t_yiq = torch.tensor(_YIQ, dtype=torch.float32, device=dev)
    t_rgb = torch.linalg.inv(t_yiq)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, c, -s]),
                       torch.stack([zero, s, c])])
    m = t_rgb @ rot @ t_yiq
    x = data.to(torch.float32)
    return _jnp.astype(torch.einsum("...c,dc->...d", x, m), data.dtype)


def lighting(data, alpha):
    """AlexNet's PCA lighting: ``data + eigvec @ (alpha * eigval)``."""
    dev = data.device
    eigval = torch.tensor(_EIGVAL, dtype=torch.float32, device=dev)
    eigvec = torch.tensor(_EIGVEC, dtype=torch.float32, device=dev)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    delta = eigvec @ (alpha * eigval)
    return _jnp.astype(data.to(torch.float32) + delta, data.dtype)


@register("_image_adjust_lighting", aliases=(_NPX + "adjust_lighting",))
def _image_adjust_lighting(data, alpha=None):
    return lighting(data, alpha)


# ---- random ops: a factor drawn on the device, then the part above -------

def _uniform(data, key, lo, hi, n=()):
    u = torch.rand(n, generator=generator_for(data.device, key),
                   device=data.device)
    return lo + u * (hi - lo)


@register("_image_random_flip_left_right",
          aliases=(_NPX + "random_flip_left_right",),
          differentiable=False, state_binders=_RNG)
def _image_random_flip_left_right(data, key=None):
    return torch.where(_uniform(data, key, 0.0, 1.0) < 0.5,
                       torch.flip(data, dims=(-2,)), data)


@register("_image_random_flip_top_bottom",
          aliases=(_NPX + "random_flip_top_bottom",),
          differentiable=False, state_binders=_RNG)
def _image_random_flip_top_bottom(data, key=None):
    return torch.where(_uniform(data, key, 0.0, 1.0) < 0.5,
                       torch.flip(data, dims=(-3,)), data)


@register("_image_random_brightness",
          aliases=(_NPX + "random_brightness",),
          differentiable=False, state_binders=_RNG)
def _image_random_brightness(data, min_factor=0.0, max_factor=1.0, key=None):
    return brightness(data, _uniform(data, key, min_factor, max_factor))


@register("_image_random_contrast", aliases=(_NPX + "random_contrast",),
          differentiable=False, state_binders=_RNG)
def _image_random_contrast(data, min_factor=0.0, max_factor=1.0, key=None):
    return contrast(data, _uniform(data, key, min_factor, max_factor))


@register("_image_random_saturation",
          aliases=(_NPX + "random_saturation",),
          differentiable=False, state_binders=_RNG)
def _image_random_saturation(data, min_factor=0.0, max_factor=1.0, key=None):
    return saturation(data, _uniform(data, key, min_factor, max_factor))


@register("_image_random_hue", aliases=(_NPX + "random_hue",),
          differentiable=False, state_binders=_RNG)
def _image_random_hue(data, min_factor=0.0, max_factor=1.0, key=None):
    return hue(data, _uniform(data, key, min_factor, max_factor))


@register("_image_random_lighting", aliases=(_NPX + "random_lighting",),
          differentiable=False, state_binders=_RNG)
def _image_random_lighting(data, alpha_std=0.05, key=None):
    alpha = torch.randn(3, generator=generator_for(data.device, key),
                        device=data.device) * alpha_std
    return lighting(data, alpha)


_JITTER = (brightness, contrast, saturation, hue)


@register("_image_random_color_jitter",
          aliases=(_NPX + "random_color_jitter",),
          differentiable=False, state_binders=_RNG)
def _image_random_color_jitter(data, brightness=0.0, contrast=0.0,
                               saturation=0.0, hue=0.0, key=None):
    """Brightness, contrast, saturation and hue in that order, each with
    its own factor (four uniform draws from the key) where its range is
    above 0."""
    u = _uniform(data, key, 0.0, 1.0, (4,))
    x = data
    for i, (amount, fn) in enumerate(zip(
            (brightness, contrast, saturation, hue), _JITTER)):
        if amount > 0:
            lo, hi = (-amount, amount) if fn is _JITTER[3] else \
                (1 - amount, 1 + amount)
            x = fn(x, lo + u[i] * (hi - lo))
    return x
