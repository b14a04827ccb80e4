"""Optimizers: counterpart of ``mxnet_tpu/optimizer/optimizer.py``.

Two layers, as in the reference:

- the pure update rules (``_sgd``, ``_sgd_mom``, ``_sgd_rowwise``,
  ``_nag_mom``, ``_adam``, ``_adagrad``, ``_rmsprop``, ``_rmsprop_alex``,
  ``_adadelta``, ``_adamax``, ``_nadam``, ``_ftrl``, ``_signum``,
  ``_signsgd``, ``_ftml``, ``_sgld``, ``_lars``, ``_lamb``, ``_dcasgd``).
  Each takes the reference's arguments in the reference's order and does
  its arithmetic op for op. The reference returns new arrays and lets XLA
  reuse the donated buffers; here each rule writes the new weight and state
  INTO the tensors it was given, under ``torch.no_grad()``, and returns
  them in the reference's order. This is elementwise work that XLA fused
  in the reference, so it is plain PyTorch, not a kernel. LARS and LAMB
  take their norms in float32 and keep them on the device (no host sync).
- the ``Optimizer`` classes (``SGD``, ``Signum``, ``FTML``, ``LARS``,
  ``LBSGD``, ``DCASGD``, ``NAG``, ``SGLD``, ``Adam``, ``AdaGrad``,
  ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``, ``Nadam``, ``LAMB``,
  ``Test``) with the reference's registry, learning-rate schedule,
  ``lr_mult``/``wd_mult`` lookup, update counts, ``multi_precision`` (an
  fp32 master copy of fp16/bf16 weights), and ``Updater``/``get_updater``.

Threefry is not ported, so ``_sgld`` draws its noise from a
``torch.Generator`` whose state is the rule's ``key`` (a uint8 tensor, as
``Generator.get_state`` gives it); ``noise=`` takes the standard-normal
draw from outside instead.

An ``Updater``'s ``get_states`` writes the JAX package's ``.states``
format and ``set_states`` reads it (and the port's older pickles of torch
tensors): a run moves between the packages mid-training
(:mod:`.states`). The optimizer goes without its ``param_dict`` (as
upstream MXNet's ``Optimizer.__getstate__`` leaves it);
``gluon.Trainer.load_states`` attaches it again.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from . import states as _states

__all__ = ["Optimizer", "register", "create", "SGD", "Signum", "FTML",
           "LARS", "LBSGD", "DCASGD", "NAG", "SGLD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "LAMB", "Test",
           "Updater", "get_updater"]

_INF = float("inf")
_OPT_REGISTRY = {}
_LOW_PRECISION = (torch.float16, torch.bfloat16)


def register(klass):
    """Register an optimizer class under its lowercased name."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (an instance is returned as is)."""
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _OPT_REGISTRY:
        raise ValueError("Cannot find optimizer %s (have %s)"
                         % (name, sorted(_OPT_REGISTRY)))
    return _OPT_REGISTRY[name.lower()](**kwargs)


class Optimizer:
    """Base optimizer (reference ``optimizer.py:56``): the learning rate
    (``lr_scheduler(num_update)`` when one is set), weight decay, per-index
    multipliers, update counts and the multi-precision wrapper. Weights,
    gradients and states are torch tensors, updated in place."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._all_index_update_counts = {0: {}}
        self._index_update_count = self._all_index_update_counts[0]
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = 0
        if param_idx2name is None:
            param_idx2name = {}
        self.idx2name = param_idx2name.copy()
        self.sym_info = ()
        self.param_dict = param_dict if param_dict else {}

    create_optimizer = staticmethod(create)

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def create_state(self, index, weight):
        return None

    def _low_precision(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, an fp16/bf16 weight keeps an fp32 master
        copy: the state is ``(master, create_state(index, master))``."""
        if self._low_precision(weight):
            master = weight.detach().to(torch.float32, copy=True)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` on the fp32 master copy (with the gradient in
        fp32), then the master rounded into ``weight``."""
        if self._low_precision(weight):
            master, base_state = state
            self.update(index, master, grad.to(torch.float32), base_state)
            with torch.no_grad():
                weight.copy_(master)
            return
        self.update(index, weight, grad, state)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = args_lr_mult.copy()

    def set_wd_mult(self, args_wd_mult):
        """Only names ending in ``_weight`` or ``_gamma`` keep weight decay;
        ``args_wd_mult`` then overrides."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _set_current_context(self, device_id):
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        """Count an update of each index; ``num_update`` (what the
        scheduler reads) is the largest count, 1 on the first update."""
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        ret = self.__dict__.copy()
        # the Parameters (and so the model's tensors) stay out of a pickle
        ret["param_dict"] = {}
        return ret

    def __setstate__(self, state):
        self.__dict__.update(state)


# ---- pure update rules -----------------------------------------------------

def _clip(g, rescale, clip):
    return torch.clamp(g * rescale, -clip, clip)


def _norm32(x):
    return torch.linalg.vector_norm(x.to(torch.float32))


@torch.no_grad()
def _sgd(w, g, lr, wd, rescale, clip):
    """``w -= lr * (clip(g * rescale) + wd * w)``; returns ``w``."""
    g = _clip(g, rescale, clip)
    w.sub_(lr * (g + wd * w))
    return w


@torch.no_grad()
def _sgd_mom(w, mom, g, lr, wd, mo, rescale, clip):
    """``mom = mo * mom - lr * (clip(g * rescale) + wd * w)``; ``w +=
    mom``. Returns ``(w, mom)``."""
    g = _clip(g, rescale, clip) + wd * w
    mom.mul_(mo).sub_(lr * g)
    w.add_(mom)
    return w, mom


@torch.no_grad()
def _sgd_rowwise(w, values, idx, lr, wd, rescale, clip):
    """SGD on the rows ``idx`` of ``w`` only (a row-sparse gradient whose
    rows are ``values``); the other rows take no weight decay. XLA fuses
    the reference's update into ``fma(-lr, fma(wd, rows, g), rows)`` with
    ``lr`` and ``wd`` in float32, each rounded once. Here each
    multiply-add is computed in float64 (the product exactly) and rounded
    to the weight's dtype: the rows match the reference's except where
    that double rounding (to 53 bits, then to 24) lands otherwise than an
    FMA's single rounding: only where the exact sum lies within half a
    float64 step of a point halfway between two float32 values, a rare
    case."""
    g = _clip(values, rescale, clip).double()
    rows = w.index_select(0, idx)
    r64 = rows.double()
    lr32, wd32 = (float(torch.tensor(v, dtype=torch.float32))
                  for v in (lr, wd))
    t = (wd32 * r64 + g).to(w.dtype).double()
    w.index_copy_(0, idx, (r64 - lr32 * t).to(w.dtype))
    return w


@torch.no_grad()
def _nag_mom(w, mom, g, lr, wd, mo, rescale, clip):
    """Nesterov: ``mom = mo * mom + g``; ``w -= lr * (g + mo * mom)``."""
    g = _clip(g, rescale, clip) + wd * w
    mom.mul_(mo).add_(g)
    w.sub_(lr * (g + mo * mom))
    return w, mom


@torch.no_grad()
def _adam(w, m, v, g, lr, wd, b1, b2, eps, rescale, clip, t):
    """Adam at step ``t`` (1-based) with the bias correction folded into
    the rate, ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` (a host scalar);
    then ``w -= lr_t * m / (sqrt(v) + eps)``. Returns ``(w, m, v)``."""
    return _adam_at(w, m, v, g, lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t),
                    wd, b1, b2, eps, rescale, clip)


@torch.no_grad()
def _adam_at(w, m, v, g, lr_t, wd, b1, b2, eps, rescale, clip):
    """Adam with the bias-corrected rate ``lr_t`` given: a host scalar, or
    a 0-dim float32 tensor holding that scalar rounded as a host scalar
    is (the same products, bit for bit)."""
    g = _clip(g, rescale, clip) + wd * w
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    w.sub_(lr_t * m / (v.sqrt() + eps))
    return w, m, v


@torch.no_grad()
def _adagrad(w, hist, g, lr, wd, eps, rescale, clip):
    g = _clip(g, rescale, clip) + wd * w
    hist.add_(g.square())
    w.sub_(lr * g / (hist.sqrt() + eps))
    return w, hist


@torch.no_grad()
def _rmsprop(w, n, g, lr, wd, rho, eps, rescale, clip):
    g = _clip(g, rescale, clip) + wd * w
    n.mul_(rho).add_((1 - rho) * g.square())
    w.sub_(lr * g / (n + eps).sqrt())
    return w, n


@torch.no_grad()
def _rmsprop_alex(w, n, gm, delta, g, lr, wd, rho, momentum, eps, rescale,
                  clip):
    """Centered RMSProp (Graves): mean-square ``n``, mean ``gm`` and the
    momentum ``delta``."""
    g = _clip(g, rescale, clip) + wd * w
    n.mul_(rho).add_((1 - rho) * g.square())
    gm.mul_(rho).add_((1 - rho) * g)
    delta.mul_(momentum).sub_(lr * g / (n - gm.square() + eps).sqrt())
    w.add_(delta)
    return w, n, gm, delta


@torch.no_grad()
def _adadelta(w, acc_g, acc_delta, g, wd, rho, eps, rescale, clip):
    g = _clip(g, rescale, clip) + wd * w
    acc_g.mul_(rho).add_((1 - rho) * g.square())
    delta = (acc_delta + eps).sqrt() / (acc_g + eps).sqrt() * g
    acc_delta.mul_(rho).add_((1 - rho) * delta.square())
    w.sub_(delta)
    return w, acc_g, acc_delta


@torch.no_grad()
def _adamax(w, m, u, g, lr, wd, b1, b2, rescale, clip, t):
    g = _clip(g, rescale, clip) + wd * w
    m.mul_(b1).add_((1 - b1) * g)
    torch.maximum(b2 * u, g.abs(), out=u)
    lr_t = lr / (1 - b1 ** t)
    w.sub_(lr_t * m / (u + 1e-8))
    return w, m, u


@torch.no_grad()
def _nadam(w, m, v, g, lr, wd, b1, b2, eps, schedule, m_schedule_next,
           mu_t, mu_t1, rescale, clip, t):
    g = _clip(g, rescale, clip) + wd * w
    grad_prime = g / (1 - schedule)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    m_prime = m / (1 - m_schedule_next)
    v_prime = v / (1 - b2 ** t)
    m_bar = (1 - mu_t) * grad_prime + mu_t1 * m_prime
    w.sub_(lr * m_bar / (v_prime.sqrt() + eps))
    return w, m, v


@torch.no_grad()
def _ftrl(w, z, n, g, lr, wd, lamda1, beta, rescale, clip):
    g = _clip(g, rescale, clip)
    n_new = n + g.square()
    sigma = (n_new.sqrt() - n.sqrt()) / lr
    z.add_(g).sub_(sigma * w)
    n.copy_(n_new)
    new = -(z - torch.sign(z) * lamda1) / ((beta + n.sqrt()) / lr + wd)
    w.copy_(torch.where(z.abs() > lamda1, new, torch.zeros_like(w)))
    return w, z, n


@torch.no_grad()
def _signum(w, mom, g, lr, wd, mo, wd_lh, rescale, clip):
    g = _clip(g, rescale, clip)
    mom.mul_(mo).sub_((1 - mo) * (g + wd * w))
    w.mul_(1 - lr * wd_lh).add_(lr * torch.sign(mom))
    return w, mom


@torch.no_grad()
def _signsgd(w, g, lr, wd, rescale, clip):
    g = _clip(g, rescale, clip)
    w.sub_(lr * torch.sign(g + wd * w))
    return w


@torch.no_grad()
def _ftml(w, d, v, z, g, lr, wd, b1, b2, eps, rescale, clip, t):
    """FTML; returns ``(w, d, v, z)`` with ``w = -z / d_t``, ``d = d_t``."""
    g = _clip(g, rescale, clip) + wd * w
    v.mul_(b2).add_((1 - b2) * g.square())
    d_t = (1 - b1 ** t) / lr * ((v / (1 - b2 ** t)).sqrt() + eps)
    sigma = d_t - b1 * d
    z.mul_(b1).add_((1 - b1) * g).sub_(sigma * w)
    w.copy_(-z / d_t)
    d.copy_(d_t)
    return w, d, v, z


@torch.no_grad()
def _sgld(w, key, g, lr, wd, rescale, clip, noise=None):
    """Langevin dynamics: ``w += -0.5 * lr * g + sqrt(lr) * noise``.
    ``key`` is a ``torch.Generator`` state (uint8 tensor) for ``w``'s
    device; the standard-normal ``noise`` is drawn from it and the advanced
    state written back into ``key``, unless ``noise`` is given. Returns
    ``(w, key)``."""
    g = _clip(g, rescale, clip) + wd * w
    if noise is None:
        gen = torch.Generator(device=w.device)
        gen.set_state(key)
        noise = torch.randn(w.shape, generator=gen, device=w.device,
                            dtype=w.dtype)
        key.copy_(gen.get_state())
    w.sub_(0.5 * lr * g).add_(noise * math.sqrt(lr))
    return w, key


@torch.no_grad()
def _lars(w, mom, g, lr, wd, mo, eta, eps, rescale, clip):
    """LARS: the layer's trust ratio ``eta * |w| / (|g| + wd * |w| +
    eps)`` (1 where a norm is 0), norms in float32."""
    g = g * rescale
    w_norm, g_norm = _norm32(w), _norm32(g)
    lratio = torch.where((w_norm > 0) & (g_norm > 0),
                         eta * w_norm / (g_norm + wd * w_norm + eps),
                         torch.ones_like(w_norm))
    g = torch.clamp(g, -clip, clip)
    scaled = lratio * (g + wd * w)
    mom.mul_(mo).add_(scaled)
    w.sub_(lr * (mom * mo + scaled))
    return w, mom


@torch.no_grad()
def _lamb(w, m, v, g, lr, wd, b1, b2, eps, t, lower, upper, bc, rescale,
          clip):
    """LAMB: Adam's direction (bias-corrected when ``bc > 0``) plus
    ``wd * w``, scaled by the trust ratio ``clip(|w|, lower, upper) /
    |direction|`` (1 where a norm is 0), norms in float32."""
    g = _clip(g, rescale, clip)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    mhat = m / (1 - b1 ** t) if bc > 0 else m
    vhat = v / (1 - b2 ** t) if bc > 0 else v
    gnew = mhat / (vhat.sqrt() + eps) + wd * w
    r1 = torch.clamp(_norm32(w), lower, upper)
    r2 = _norm32(gnew)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    w.sub_(lr * ratio * gnew)
    return w, m, v


@torch.no_grad()
def _dcasgd(w, prev_w, mom, g, lr, wd, mo, lamda, rescale, clip):
    """Delay-compensated SGD; returns ``(w, prev_w, mom)`` with ``prev_w``
    the weight before this update."""
    g = _clip(g, rescale, clip) + wd * w
    mom.mul_(mo).sub_(lr * (g + lamda * g * g * (w - prev_w)))
    prev_w.copy_(w)
    w.add_(mom)
    return w, prev_w, mom


def _c(clip):
    return _INF if clip is None else clip


# ---- optimizer classes -----------------------------------------------------

@register
class SGD(Optimizer):
    """SGD with momentum. A row-sparse gradient (a ``RowSparseNDArray``,
    or a sparse COO tensor) with ``lazy_update`` and no momentum updates
    only its rows (``_sgd_rowwise``), as the reference's row-sparse path:
    the other rows take no weight decay. ``weight`` may be an NDArray (its
    tensor is updated in place; a ``RowSparseNDArray``'s dense view, so
    its payload is compressed again when next read)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        clip = _c(self.clip_gradient)
        from ..ndarray.ndarray import NDArray
        from ..ndarray.sparse import RowSparseNDArray
        if isinstance(weight, NDArray):
            weight = weight._data
        if isinstance(grad, RowSparseNDArray) and self.lazy_update \
                and state is None:
            values, idx = grad._payload()
            _sgd_rowwise(weight, values.to(weight.dtype), idx, lr, wd,
                         self.rescale_grad, clip)
            return
        if isinstance(grad, NDArray):
            grad = grad._data
        if grad.is_sparse and self.lazy_update and state is None:
            grad = grad.coalesce()
            _sgd_rowwise(weight, grad.values().to(weight.dtype),
                         grad.indices()[0], lr, wd, self.rescale_grad, clip)
            return
        if grad.is_sparse:
            grad = grad.to_dense()
        if state is not None:
            _sgd_mom(weight, state, grad, lr, wd, self.momentum,
                     self.rescale_grad, clip)
        else:
            _sgd(weight, grad, lr, wd, self.rescale_grad, clip)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            _signum(weight, state, grad, lr, wd, self.momentum, self.wd_lh,
                    self.rescale_grad, _c(self.clip_gradient))
        else:
            _signsgd(weight, grad, lr, wd, self.rescale_grad,
                     _c(self.clip_gradient))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight) for _ in range(3))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        _ftml(weight, d, v, z, grad, lr, wd, self.beta1, self.beta2,
              self.epsilon, self.rescale_grad, _c(self.clip_gradient), t)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling."""

    def __init__(self, momentum=0.0, lars_eta=0.001, lars_eps=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = lars_eta
        self.eps = lars_eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _lars(weight, state, grad, lr, wd, self.momentum, self.eta, self.eps,
              self.rescale_grad, _c(self.clip_gradient))


@register
class LBSGD(SGD):
    """Large-batch SGD, kept as an SGD alias as in the reference (its
    warm-up arguments are accepted and unused)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        return (weight.detach().clone(), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        prev, mom = state
        _dcasgd(weight, prev, mom, grad, lr, wd, self.momentum, self.lamda,
                self.rescale_grad, _c(self.clip_gradient))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (plain SGD without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            _nag_mom(weight, state, grad, lr, wd, self.momentum,
                     self.rescale_grad, _c(self.clip_gradient))
        else:
            _sgd(weight, grad, lr, wd, self.rescale_grad,
                 _c(self.clip_gradient))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics. Each weight's state is the
    state of its own ``torch.Generator``, seeded from
    :func:`mxnet_tpu_torch.random.next_key` when the state is made."""

    def create_state(self, index, weight):
        s0, s1 = _random.next_key()
        gen = torch.Generator(device=weight.device)
        gen.manual_seed(((s0 << 32) | s1) & (2 ** 63 - 1))
        return gen.get_state()

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _sgld(weight, state, grad, lr, wd, self.rescale_grad,
              _c(self.clip_gradient))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        m, v = state
        _adam(weight, m, v, grad, lr, wd, self.beta1, self.beta2,
              self.epsilon, self.rescale_grad, _c(self.clip_gradient), t)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _adagrad(weight, state, grad, lr, wd, self.float_stable_eps,
                 self.rescale_grad, _c(self.clip_gradient))


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Graves' variant (``_rmsprop_alex``).
    ``clip_weights`` clamps the weight after each update."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(torch.zeros_like(weight) for _ in range(3))
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.centered:
            n, gm, delta = state
            _rmsprop_alex(weight, n, gm, delta, grad, lr, wd, self.gamma1,
                          self.gamma2, self.epsilon, self.rescale_grad,
                          _c(self.clip_gradient))
        else:
            _rmsprop(weight, state, grad, lr, wd, self.gamma1, self.epsilon,
                     self.rescale_grad, _c(self.clip_gradient))
        if self.clip_weights:
            with torch.no_grad():
                weight.clamp_(-self.clip_weights, self.clip_weights)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        _adadelta(weight, acc_g, acc_delta, grad, wd, self.rho, self.epsilon,
                  self.rescale_grad, _c(self.clip_gradient))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        _ftrl(weight, z, n, grad, lr, wd, self.lamda1, self.beta,
              self.rescale_grad, _c(self.clip_gradient))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        m, u = state
        _adamax(weight, m, u, grad, lr, wd, self.beta1, self.beta2,
                self.rescale_grad, _c(self.clip_gradient), t)


@register
class Nadam(Optimizer):
    """Nadam. As in the reference, the momentum schedule ``m_schedule`` is
    one product over every update of every index."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        mu_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_t1 = self.beta1 * (1.0 - 0.5 * 0.96 **
                              ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mu_t
        m_schedule_next = self.m_schedule * mu_t1
        m, v = state
        _nadam(weight, m, v, grad, lr, wd, self.beta1, self.beta2,
               self.epsilon, self.m_schedule, m_schedule_next, mu_t, mu_t1,
               self.rescale_grad, _c(self.clip_gradient), t)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for batch training (MXNet 1.6's LAMB):
    no bounds on the weight norm unless given, bias correction on."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        m, v = state
        _lamb(weight, m, v, grad, lr, wd, self.beta1, self.beta2,
              self.epsilon, t,
              0.0 if self.lower_bound is None else self.lower_bound,
              _INF if self.upper_bound is None else self.upper_bound,
              1.0 if self.bias_correction else 0.0,
              self.rescale_grad, _c(self.clip_gradient))


@register
class Test(Optimizer):
    """``w -= rescale_grad * g`` (for unit tests; counts no update)."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight.sub_(self.rescale_grad * grad)


# the reference registry's aliases
_OPT_REGISTRY["ccsgd"] = SGD
_OPT_REGISTRY["adamw"] = LAMB


class Updater:
    """Applies an optimizer by index, making each index's state at its
    first update (``multi_precision`` included)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = self.sync_state_context(
                self.states[index], weight.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, context):
        """``state`` (a tensor, or a tuple or list of them) on the device
        ``context``: loaded states are on the CPU until their weight's
        first update."""
        if isinstance(state, torch.Tensor):
            return state.to(context)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(s, context)
                               for s in state)
        return state

    def set_states(self, states):
        """Load a ``.states`` file's bytes: this package's or the JAX
        package's (:mod:`.states`)."""
        states = _states.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer) in the JAX package's ``.states``
        format, which both packages read (:mod:`.states`)."""
        return _states.dumps(self.states, self.optimizer
                             if dump_optimizer else None)


def get_updater(optimizer):
    return Updater(optimizer)
