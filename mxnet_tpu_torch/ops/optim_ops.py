"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optim_ops.py`` (``optimizer_op.cc``'s
update ops, ``contrib/adamw.cc`` and ``preloaded_multi_sgd.cc``): every
op returns the new weight and the new states, as the reference's pure
functions do, and the caller rebinds them. The arithmetic is the
reference's, in its order: the gradient is rescaled, then clipped, then
weight decay is added (:func:`_prep`). The ``mp_*`` ops compute in
float32 on the float32 master weight and round the new master to the
weight's dtype. ``adagrad_update`` takes dense arrays, as the reference's
(a row-sparse gradient updates lazily through ``optimizer.SGD``). The
``multi_*`` and ``preloaded_multi_*``
ops take their arrays flat and return a flat tuple; the ``preloaded``
ones take ``lrs``/``wds`` as tensors and read them where they lie (on the
card, no host read per weight).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _f32(x):
    return x.to(torch.float32)


def _div(x, scalar):
    """``x / scalar`` rounded once, as jnp divides (CUDA's kernel would
    multiply by a Python scalar's reciprocal: one more rounding)."""
    return x / torch.full((), scalar, dtype=x.dtype, device=x.device)


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", n_out=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("mp_sgd_update", n_out=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _prep(_f32(grad), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", n_out=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _prep(_f32(grad), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", n_out=2)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("mp_nag_mom_update", n_out=3)
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(_f32(grad), rescale_grad, clip_gradient) + wd * weight32
    new_mom = momentum * mom + g
    new_w32 = weight32 - lr * (g + momentum * new_mom)
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", n_out=3)
def adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("_adamw_update", aliases=("adamw_update",), n_out=3)
def _adamw_update(weight, grad, mean, var, rescale_grad, lr=0.01, beta1=0.9,
                  beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  clip_gradient=-1.0):
    """AdamW, decoupled weight decay; ``rescale_grad`` is a tensor (the
    dynamic loss scale)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                            + wd * weight)
    return new_w, new_mean, new_var


@register("_mp_adamw_update", aliases=("mp_adamw_update",), n_out=4)
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                     lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, clip_gradient=-1.0):
    g = _prep(_f32(grad), rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w32 = weight32 - eta * (lr * new_mean /
                                (torch.sqrt(new_var) + epsilon)
                                + wd * weight32)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


@register("ftml_update", n_out=4)
def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                clip_gradient=-1.0, t=1):
    clip = clip_gradient if clip_gradient is not None and \
        clip_gradient >= 0 else clip_grad
    g = _prep(grad, rescale_grad, clip) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    t = float(t)
    denom = 1 - beta1 ** t
    d_t = denom / lr * (torch.sqrt(_div(new_v, 1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("ftrl_update", n_out=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = _div(torch.sqrt(new_n) - torch.sqrt(n), lr)
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        (torch.sign(new_z) * lamda1 - new_z)
        / (_div(beta + torch.sqrt(new_n), lr) + wd))
    return new_w, new_z, new_n


@register("rmsprop_update", n_out=2)
def rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", n_out=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.01, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(gr) + gamma1 * n
    new_g = (1 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", n_out=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@register("_sparse_adagrad_update", aliases=("adagrad_update",), n_out=2)
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    new_w = weight - lr * (g / (torch.sqrt(new_hist) + epsilon) + wd * weight)
    return new_w, new_hist


@register("multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """Per-layer LARS learning rates: ``lr * eta ||w|| / (||g|| rescale +
    wd ||w|| + eps)``, or ``lr`` where either norm is 0."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps),
                        torch.ones_like(w_norm))
    return lrs * ratio


def _seq(v, i, default):
    if v is None:
        return default
    try:
        return float(v[i])
    except (TypeError, IndexError):
        return float(v)


@register("multi_sgd_update", n_out=-1)
def multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    return tuple(sgd_update.fn(arrays[2 * i], arrays[2 * i + 1],
                            lr=_seq(lrs, i, 0.01), wd=_seq(wds, i, 0.0),
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i in range(int(num_weights)))


@register("multi_sgd_mom_update", n_out=-1)
def multi_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    outs = []
    for i in range(int(num_weights)):
        outs.extend(sgd_mom_update.fn(
            *arrays[3 * i:3 * i + 3], lr=_seq(lrs, i, 0.01),
            momentum=momentum, wd=_seq(wds, i, 0.0),
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_update", n_out=-1)
def multi_mp_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    outs = []
    for i in range(int(num_weights)):
        outs.extend(mp_sgd_update.fn(
            *arrays[3 * i:3 * i + 3], lr=_seq(lrs, i, 0.01),
            wd=_seq(wds, i, 0.0), rescale_grad=rescale_grad,
            clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_mom_update", n_out=-1)
def multi_mp_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    outs = []
    for i in range(int(num_weights)):
        outs.extend(mp_sgd_mom_update.fn(
            *arrays[4 * i:4 * i + 4], lr=_seq(lrs, i, 0.01),
            momentum=momentum, wd=_seq(wds, i, 0.0),
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register("_multi_adamw_update", aliases=("multi_adamw_update",), n_out=-1)
def _multi_adamw_update(*arrays, lrs=None, wds=None, etas=None, beta1=0.9,
                        beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                        num_weights=1):
    rescale = arrays[-1]
    outs = []
    for i in range(int(num_weights)):
        outs.extend(_adamw_update.fn(
            *arrays[4 * i:4 * i + 4], rescale, lr=_seq(lrs, i, 0.01),
            beta1=beta1, beta2=beta2, epsilon=epsilon,
            wd=_seq(wds, i, 0.0), eta=_seq(etas, i, 1.0),
            clip_gradient=clip_gradient))
    return tuple(outs)


@register("_multi_mp_adamw_update", aliases=("multi_mp_adamw_update",),
          n_out=-1)
def _multi_mp_adamw_update(*arrays, lrs=None, wds=None, etas=None, beta1=0.9,
                           beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                           num_weights=1):
    rescale = arrays[-1]
    outs = []
    for i in range(int(num_weights)):
        outs.extend(_mp_adamw_update.fn(
            *arrays[5 * i:5 * i + 5], rescale, lr=_seq(lrs, i, 0.01),
            beta1=beta1, beta2=beta2, epsilon=epsilon,
            wd=_seq(wds, i, 0.0), eta=_seq(etas, i, 1.0),
            clip_gradient=clip_gradient))
    return tuple(outs)


def _preloaded(step, mom, mp):
    """A ``preloaded_multi_*`` op: arrays ``[w0, g0, (m0,) (w32_0,) ...,
    lrs, wds]``, ``lrs[i]``/``wds[i]`` 0-d slices of the tensors; the
    momentum ops run at the reference's default momentum (0), which takes
    no momentum argument here."""
    update = {(False, False): sgd_update, (True, False): sgd_mom_update,
              (False, True): mp_sgd_update,
              (True, True): mp_sgd_mom_update}[(mom, mp)].fn

    def run(*arrays, rescale_grad=1.0, clip_gradient=-1.0, num_weights=1):
        lrs, wds = arrays[-2], arrays[-1]
        outs = []
        for i in range(int(num_weights)):
            out = update(*arrays[step * i:step * (i + 1)], lr=lrs[i],
                         wd=wds[i], rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient)
            outs.extend(out if isinstance(out, tuple) else (out,))
        return tuple(outs)
    return run


register("preloaded_multi_sgd_update", n_out=-1)(_preloaded(2, False, False))
register("preloaded_multi_sgd_mom_update", n_out=-1)(
    _preloaded(3, True, False))
register("preloaded_multi_mp_sgd_update", n_out=-1)(
    _preloaded(3, False, True))
register("preloaded_multi_mp_sgd_mom_update", n_out=-1)(
    _preloaded(4, True, True))
