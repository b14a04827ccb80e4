"""Blocks as pure functions and optimizers as ``(init_state, update)``
pairs: counterparts of ``functionalize`` and ``functional_optimizer`` in
``mxnet_tpu/parallel/functional.py``.

``shard_params`` turns regex rules into shardings over a mesh.

``functionalize(block, train)`` gives the reference's
``pure(rng_key, param_vals, *inputs) -> (outputs, aux_values)``: the
block runs on the given values in place of its parameters
(``torch.func.functional_call``), and the aux writes (BatchNorm's moving
statistics in training) are returned instead of written.
"""
from __future__ import annotations

import math
import re
import threading

import torch
from torch.func import functional_call

from .. import _tape
from .. import random as _random
from ..optimizer import optimizer as _opt

__all__ = ["functionalize", "functional_optimizer", "shard_params",
           "DeviceStep"]


def functionalize(block, train=True):
    """``(pure, params)``: ``params`` is ``block.collect_params()``'s
    list, and ``pure(rng_key, param_vals, *inputs)`` runs ``block`` in
    training (``train``) or inference mode on ``param_vals`` (tensors in
    ``params``' order) and the input tensors, without recording, and
    returns ``(outputs_tuple, aux_values_tuple)`` (differentiable under
    torch's grad mode). ``pure.aux_handles``
    holds, after a call, the NDArray handles of the parameters each aux
    value belongs to (bound to the block's own tensors; ``pure.aux_index``
    their indices in ``params``), as the reference's trainer folds them
    back. ``rng_key`` (None, an int seed or a ``torch.Generator``) seeds
    the call's random draws (dropout's key words); None draws from this
    thread's generator."""
    from ..ndarray.ndarray import NDArray
    params = list(block.collect_params().values())
    path = {id(t): n for n, t in block.named_parameters()}
    names = [path[id(p.tensor())] for p in params]

    def pure(rng_key, param_vals, *inputs):
        values = dict(zip(names, param_vals))
        where = {id(v): i for i, v in enumerate(param_vals)}
        prev_mode = block.training
        prev_rec = _tape.set_recording(False)
        prev_gen = getattr(_random._state, "generator", None)
        if rng_key is not None:
            _random._state.generator = rng_key if isinstance(
                rng_key, torch.Generator) else \
                torch.Generator().manual_seed(int(rng_key))
        block.train(train)
        sink = _tape.push_aux_sink()
        try:
            out = functional_call(block, values, inputs)
        finally:
            _tape.pop_aux_sink()
            block.train(prev_mode)
            _tape.set_recording(prev_rec)
            if rng_key is not None:
                _random._state.generator = prev_gen
        pure.aux_index = [where[id(h._data)] for h, _ in sink]
        pure.aux_handles = [NDArray._bind(params[i].tensor())
                            for i in pure.aux_index]
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return tuple(outs), tuple(v for _, v in sink)

    pure.aux_handles = []
    pure.aux_index = []
    return pure, params


_tables = {}
_tables_lock = threading.Lock()


def _table(key, fn, device, bound):
    """``fn(1), ..., fn(n)`` (n >= ``bound``, at least 4096) computed on
    the host in float64, on ``device``; cached by ``key`` and device (a
    CUDA device by its index: ``cuda`` is the current one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _tables_lock:
        table = _tables.get((key, device))
        if table is None or table.numel() < bound:
            n = max(4096, int(bound),
                    2 * (0 if table is None else table.numel()))
            table = torch.tensor([fn(k) for k in range(1, n + 1)],
                                 dtype=torch.float64)
            if device.type == "cuda":
                # pinned and non_blocking: no host sync
                table = table.pin_memory().to(device, non_blocking=True)
            _tables[(key, device)] = table
        return table


class DeviceStep:
    """An optimizer step count held in a 0-dim int64 tensor ``t`` on the
    device (a guarded step that is skipped leaves it), with ``bound``, a
    host number it cannot exceed. An update takes it where it takes
    ``t``; :meth:`at` reads a host function of the step without a host
    sync."""

    def __init__(self, t, bound):
        self.t = t
        self.bound = max(1, int(bound))

    def at(self, key, fn):
        """``fn(k)`` (float64, computed on the host) for the step ``k``
        held in ``t``, as a 0-dim float64 tensor gathered on the device."""
        table = _table(key, fn, self.t.device, self.bound)
        return table.index_select(0, (self.t - 1).clamp_min(0).view(1)) \
            .view(())


def _adam_terms(b1, b2):
    return (("adam_sqrt", b2), lambda k: math.sqrt(1 - b2 ** k)), \
        (("adam_denom", b1), lambda k: 1 - b1 ** k)


def functional_optimizer(name, **hyper):
    """``(init_state, update)`` over one tensor for ``"sgd"`` (with or
    without ``momentum``), ``"nag"``, ``"adam"`` or ``"lamb"`` (no bounds on
    the weight norm, bias correction on), with the reference's
    hyper-parameter names and defaults. ``init_state(w)`` returns a tuple of
    state tensors; ``update(w, g, state, t, lr)`` updates ``w`` and
    ``state`` in place (``t`` is the 1-based step) and returns them.
    ``update.device_step`` says whether ``t`` may be a
    :class:`DeviceStep` (every rule here but ``lamb``, whose bias
    corrections divide by host scalars); ``update.prepare(device, bound)``,
    where present, makes the device tables a :class:`DeviceStep` reads
    ahead of the first step."""
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
            update.device_step = True
        else:
            def init(w):
                return ()

            def update(w, g, state, t, lr):
                return _opt._sgd(w, g, lr, wd, rescale, clip), ()
            update.device_step = True
        return init, update
    if name == "nag":
        def init(w):
            return (torch.zeros_like(w),)

        def update(w, g, state, t, lr):
            w, m = _opt._nag_mom(w, state[0], g, lr, wd, mom, rescale, clip)
            return w, (m,)
        update.device_step = True
        return init, update
    if name == "adam":
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, t, lr):
            if isinstance(t, DeviceStep):
                # the host's lr * sqrt(1 - b2^t) / (1 - b1^t), in float64
                # in the same order, rounded once to float32: bitwise
                (ks, fs), (kd, fd) = _adam_terms(b1, b2)
                lr_t = ((t.at(ks, fs) * lr) / t.at(kd, fd)).to(
                    device=w.device, dtype=torch.float32)
                w, m, v = _opt._adam_at(w, state[0], state[1], g, lr_t, wd,
                                        b1, b2, eps, rescale, clip)
            else:
                w, m, v = _opt._adam(w, state[0], state[1], g, lr, wd, b1,
                                     b2, eps, rescale, clip, t)
            return w, (m, v)

        def prepare(device, bound):
            for key, fn in _adam_terms(b1, b2):
                _table(key, fn, device, bound)
        update.device_step = True
        update.prepare = prepare
        return init, update
    if name == "lamb":
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, t, lr):
            w, m, v = _opt._lamb(w, state[0], state[1], g, lr, wd, b1, b2,
                                 eps, t, 0.0, _opt._INF, 1.0, rescale, clip)
            return w, (m, v)
        update.device_step = False
        return init, update
    raise ValueError("functional optimizer %r not supported (use sgd, nag, "
                     "adam, lamb)" % name)


def shard_params(params, mesh, rules=None):
    """A :class:`~.mesh.NamedSharding` per parameter (a name, or anything
    with ``.name``) from ``[(regex, PartitionSpec), ...]`` rules: the first
    rule whose regex ``re.search``-es the name wins; an unmatched parameter
    is replicated (the reference's ``group2ctx`` placement as specs)."""
    from .mesh import NamedSharding, PartitionSpec
    out = []
    for p in params:
        name = p if isinstance(p, str) else p.name
        spec = PartitionSpec()
        for pat, s in rules or ():
            if re.search(pat, name):
                spec = s
                break
        out.append(NamedSharding(mesh, spec))
    return out
