"""Mixture-of-Experts with expert parallelism over an ``ep`` mesh axis;
counterpart of ``mxnet_tpu/parallel/moe.py``.

``moe_ffn`` is the single-device Switch FFN (top-1 routing, static
capacity, over-capacity tokens dropped to the zero vector): the one of
``ops/contrib_misc.py``, which the registry's ``moe_ffn`` op also runs.
:func:`moe_ffn_sharded` runs the same math expert-parallel: tokens and
experts are split over ``axis``, each position routes its own tokens
(capacity from its own token count), and two :func:`~.mesh.all_to_all`
exchanges send each expert's dispatch buffer to the position that holds
the expert and the results back. Its aux loss is the mean of the positions'
load-balancing losses (the per-device Switch formulation), as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..context import default_device
from ..ops.contrib_misc import _route, moe_ffn
from .mesh import NamedSharding, PartitionSpec, ShardedTensor, all_to_all

__all__ = ["moe_ffn", "moe_ffn_sharded", "init_moe_params"]


def init_moe_params(rng, d_model, d_hidden, n_experts, dtype=np.float32,
                    device=None):
    """``(gate_w, w1, w2)`` with fan-in scaling, drawn with numpy as the
    reference draws them (``RandomState(rng + i)``), as tensors on
    ``device`` (CUDA when None)."""
    r1, r2, r3 = (np.random.RandomState(rng + i) for i in range(3))
    gate = (r1.randn(d_model, n_experts) / np.sqrt(d_model)).astype(dtype)
    w1 = (r2.randn(n_experts, d_model, d_hidden) /
          np.sqrt(d_model)).astype(dtype)
    w2 = (r3.randn(n_experts, d_hidden, d_model) /
          np.sqrt(d_hidden)).astype(dtype)
    device = default_device(device)
    return tuple(torch.from_numpy(a).to(device) for a in (gate, w1, w2))


def _expert_ffn(buf, w1, w2):
    """``buf (E, C, d)`` through each expert's two-layer FFN."""
    h = F.gelu(torch.einsum("ecd,edh->ech", buf, w1), approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w2)


def moe_ffn_sharded(x, gate_w, w1, w2, mesh, capacity_factor=1.25,
                    axis="ep"):
    """Expert-parallel Switch FFN over ``mesh``'s ``axis``: ``x (..., d)``
    split over the axis by token rows, ``w1``/``w2`` by expert (``E %
    ep == 0``). Returns ``(output, aux)`` gathered whole."""
    ep = mesh.shape[axis]
    E = gate_w.shape[1]
    if E % ep:
        raise ValueError("n_experts %d not divisible by %s=%d"
                         % (E, axis, ep))
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    rows = NamedSharding(mesh, PartitionSpec(axis))
    xs = ShardedTensor.place(xt, rows)
    w1s = ShardedTensor.place(w1, rows)
    w2s = ShardedTensor.place(w2, rows)
    gate = ShardedTensor.place(gate_w, NamedSharding(mesh, PartitionSpec()))
    routes, bufs = [], []
    for p in range(mesh.size):
        t_local = xs.shards[p].shape[0]
        C = max(1, int(capacity_factor * t_local / E))
        combine, dispatch, aux = _route(xs.shards[p], gate.shards[p], C)
        buf = torch.einsum("tec,td->ecd", dispatch, xs.shards[p])
        routes.append((combine, aux, C))
        bufs.append(buf.reshape(ep, E // ep, C, D))
    # each position sends block j to position j and gets its own experts'
    # tokens from every peer: (ep, E/ep, C, d)
    recv = all_to_all(bufs, mesh, axis)
    outs = [torch.stack([_expert_ffn(recv[p][i], w1s.shards[p],
                                     w2s.shards[p]) for i in range(ep)])
            for p in range(mesh.size)]
    back = all_to_all(outs, mesh, axis)
    ys, auxes = [], []
    for p in range(mesh.size):
        combine, aux, C = routes[p]
        ys.append(torch.einsum("tec,ecd->td", combine,
                               back[p].reshape(E, C, D)))
        auxes.append(aux)
    y = ShardedTensor(ys, rows, xt.shape, xt.dtype).full(x.device)
    out = (y.reshape(x.shape), _mean_over(auxes, mesh, axis, x.device))
    # a lost ep peer would wedge the all-to-all: the collective watchdog
    # bounds the wait (free unless its deadline knob is set)
    from ..resilience.elastic import guard_wait
    return guard_wait(out, op="moe.dispatch")


def _mean_over(values, mesh, axis, device):
    """The mean over ``axis`` of one group's per-position scalars (the
    group of position 0), added in order."""
    group = mesh.groups(axis)[0]
    acc = None
    for p in group:
        v = values[p].to(device)
        acc = v if acc is None else acc + v
    return acc / len(group)
