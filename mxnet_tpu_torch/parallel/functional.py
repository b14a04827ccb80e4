"""Optimizers as ``(init_state, update)`` pairs: counterpart of
``functional_optimizer`` in ``mxnet_tpu/parallel/functional.py``.

The reference also turns a Gluon block into a pure function
(``functionalize``); the port needs no such step, since an ``nn.Module``
already holds its parameters and ``torch.func.functional_call`` runs it on
other values.
"""
from __future__ import annotations

import torch

from ..optimizer import optimizer as _opt

__all__ = ["functional_optimizer"]


def functional_optimizer(name, **hyper):
    """``(init_state, update)`` over one tensor for ``"sgd"`` (with or
    without ``momentum``), ``"nag"``, ``"adam"`` or ``"lamb"`` (no bounds on
    the weight norm, bias correction on), with the reference's
    hyper-parameter names and defaults. ``init_state(w)`` returns a tuple of
    state tensors; ``update(w, g, state, t, lr)`` updates ``w`` and
    ``state`` in place (``t`` is the 1-based step) and returns them."""
    name = name.lower()
    wd = hyper.get("wd", 0.0)
    mom = hyper.get("momentum", 0.0)
    rescale = hyper.get("rescale_grad", 1.0)
    clip = hyper.get("clip_gradient", None)
    clip = _opt._INF if clip is None else clip
    b1 = hyper.get("beta1", 0.9)
    b2 = hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-8)

    if name == "sgd":
        if mom:
            def init(w):
                return (torch.zeros_like(w),)

            def update(w, g, state, t, lr):
                w, m = _opt._sgd_mom(w, state[0], g, lr, wd, mom, rescale,
                                     clip)
                return w, (m,)
        else:
            def init(w):
                return ()

            def update(w, g, state, t, lr):
                return _opt._sgd(w, g, lr, wd, rescale, clip), ()
        return init, update
    if name == "nag":
        def init(w):
            return (torch.zeros_like(w),)

        def update(w, g, state, t, lr):
            w, m = _opt._nag_mom(w, state[0], g, lr, wd, mom, rescale, clip)
            return w, (m,)
        return init, update
    if name == "adam":
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, t, lr):
            w, m, v = _opt._adam(w, state[0], state[1], g, lr, wd, b1, b2,
                                 eps, rescale, clip, t)
            return w, (m, v)
        return init, update
    if name == "lamb":
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, t, lr):
            w, m, v = _opt._lamb(w, state[0], state[1], g, lr, wd, b1, b2,
                                 eps, t, 0.0, _opt._INF, 1.0, rescale, clip)
            return w, (m, v)
        return init, update
    raise ValueError("functional optimizer %r not supported (use sgd, nag, "
                     "adam, lamb)" % name)
