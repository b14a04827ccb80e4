"""Miscellaneous contrib operators: counterpart of
``mxnet_tpu/ops/contrib_misc.py``.

``quadratic`` (MXNet's custom-op tutorial op), ``index_copy`` (rows of the
new tensor written at the index vector's positions; an out-of-range
position is dropped, as jnp's scatter drops it), ``index_array`` (int64
coordinates), ``group_adagrad_update`` (row-wise AdaGrad), ``hawkesll``
(the univariate multi-mark Hawkes log-likelihood with an exponential
kernel, a loop over the events batched over the sequences, where the
reference scans them), and ``moe_ffn`` on one device: Switch-style top-1
routing with static capacity, the math of the reference's
``parallel/moe.py`` ``moe_ffn`` copied here (the port's
``parallel/moe.py`` uses it, and holds the expert-parallel form).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _jnp
from .registry import register

__all__ = ["quadratic", "index_copy", "index_array", "group_adagrad_update",
           "hawkesll", "moe_ffn"]


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a x^2 + b x + c``."""
    return a * data * data + b * data + c


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with ``new_tensor``'s rows at ``index_vector``."""
    out = old_tensor.clone()
    _jnp.setitem(out, index_vector.long(), new_tensor.to(out.dtype))
    return out


@register("_contrib_index_array", aliases=("index_array",),
          differentiable=False)
def index_array(data, axes=None):
    """``data.shape + (len(axes),)`` int64 coordinates (every axis when
    ``axes`` is None)."""
    sel = range(data.dim()) if axes is None else [int(a) for a in axes]
    grids = torch.meshgrid(*[torch.arange(n, device=data.device)
                             for n in data.shape], indexing="ij")
    return torch.stack([grids[a] for a in sel], dim=-1)


@register("_contrib_group_adagrad_update",
          aliases=("group_adagrad_update",), n_out=2, differentiable=False)
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """``history += mean(g^2)`` over each row; ``weight -= lr * g /
    sqrt(history + eps)``. Returns ``(weight, history)``."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    axes = tuple(range(1, g.dim()))
    hist = history + torch.mean(torch.square(g), dim=axes, keepdim=True)
    w = weight - lr * g / torch.sqrt(hist + epsilon)
    return w, hist


@register("_contrib_hawkesll", aliases=("hawkesll",), n_out=2)
def hawkesll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """``lda (N, K)``, ``alpha``/``beta (K,)``, ``state (N, K)``, ``lags``
    and ``marks (N, T)``, ``valid_length``/``max_time (N,)``. Returns the
    log-likelihoods ``(N,)`` and the states at ``max_time`` ``(N, K)``."""
    N, K = lda.shape
    dt = lda.dtype
    vl = valid_length.long()
    marks = _jnp.astype(marks, torch.int32).long()
    classes = torch.arange(K, device=lda.device)
    s = state
    t = torch.zeros(N, dtype=dt, device=lda.device)
    ll = torch.zeros(N, dtype=dt, device=lda.device)
    comp = torch.zeros(N, K, dtype=dt, device=lda.device)
    zero = torch.zeros((), dtype=dt, device=lda.device)
    for j in range(lags.shape[1]):
        valid = j < vl
        lag = lags[:, j]
        dec = torch.exp(-beta * lag[:, None])
        s2 = torch.where(valid[:, None], s * dec, s)
        t = torch.where(valid, t + lag, t)
        lam = lda + alpha * beta * s2
        onehot = (marks[:, j, None] == classes).to(dt)
        ll = ll + torch.where(valid, torch.log(torch.clamp_min(
            (lam * onehot).sum(-1), 1e-30)), zero)
        comp = comp + torch.where(
            valid[:, None],
            onehot * alpha * (1.0 - torch.exp(-beta * (max_time[:, None]
                                                       - t[:, None]))),
            zero)
        s = torch.where(valid[:, None], s2 + onehot, s2)
    T = max_time[:, None]
    comp_total = (lda * T).sum(-1) + comp.sum(-1) + \
        (alpha * state * (1.0 - torch.exp(-beta * T))).sum(-1)
    s_T = s * torch.exp(-beta * torch.clamp_min(T - t[:, None], 0.0))
    return ll - comp_total, s_T


def _route(x, gate_w, capacity):
    """Top-1 routing: ``(combine (t, E, C), dispatch (t, E, C), aux)``."""
    E = gate_w.shape[1]
    probs = torch.softmax(x @ gate_w, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.amax(probs, dim=-1)
    onehot = F.one_hot(expert, E).to(x.dtype)
    aux = E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    pos_tok = torch.sum(pos, dim=-1).to(torch.int64)
    keep = pos_tok < capacity
    pos_oh = (pos_tok[:, None] == torch.arange(
        capacity, device=x.device)).to(x.dtype)
    dispatch = (onehot * keep[:, None])[:, :, None] * pos_oh[:, None, :]
    return dispatch * gate[:, None, None], dispatch, aux


def moe_ffn(x, gate_w, w1, w2, capacity_factor=1.25):
    """``x (..., T, d)`` through a Switch FFN: ``(output, aux loss)``."""
    lead, (T, D) = x.shape[:-2], x.shape[-2:]
    xt = x.reshape(-1, D)
    E = gate_w.shape[1]
    C = max(1, int(capacity_factor * xt.shape[0] / E))
    combine, dispatch, aux = _route(xt, gate_w, C)
    buf = torch.einsum("tec,td->ecd", dispatch, xt)
    h = F.gelu(torch.einsum("ecd,edh->ech", buf, w1), approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, w2)
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.reshape(lead + (T, D)), aux


@register("_contrib_moe_ffn", aliases=("moe_ffn",), n_out=2)
def moe_ffn_op(data, gate_w, w1, w2, capacity_factor=1.25):
    """:func:`moe_ffn`: ``(output, load-balancing aux loss)``."""
    return moe_ffn(data, gate_w, w1, w2, float(capacity_factor))
