"""Pipeline parallelism: GPipe-style microbatches over the ``pp`` mesh
axis; counterpart of ``mxnet_tpu/parallel/pipeline.py``.

Uniform stages (the activation keeps its shape, as a transformer layer's
does): each ``pp`` position holds its stage's parameters, and at every
tick each stage applies itself to what it holds, after which the
activations rotate one stage on (:func:`~.mesh.ppermute`). Stage 0 takes
microbatch ``t`` at tick ``t``, the last stage completes microbatch ``t -
(S - 1)``; ``n_micro + S - 1`` ticks in all (bubble ``(S - 1) / (n_micro +
S - 1)``). The last stage's outputs are summed over the axis under a mask,
as the reference's ``psum``, so every position ends with the whole output.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .mesh import all_reduce, ppermute

__all__ = ["pipeline_apply", "pipeline_spmd"]


def pipeline_apply(fn, local_params, batches, n_micro, mesh,
                   axis_name="pp"):
    """``y = stage_{S-1}(... stage_0(x))`` over the ``axis_name`` ring.

    ``local_params[p]`` is position ``p``'s stage parameters and
    ``batches[p]`` its copy of the whole local batch (the same on every
    stage; the port's form of the reference's call inside ``shard_map``);
    ``fn(stage_params, x)`` keeps ``x``'s shape. Returns the per-position
    outputs, each the whole batch's."""
    n_stages = mesh.shape[axis_name]
    idx = [mesh.coords(p)[axis_name] for p in range(mesh.size)]
    B = batches[0].shape[0]
    if B % n_micro:
        raise ValueError("batch of %d not divisible into %d microbatches"
                         % (B, n_micro))
    mb = B // n_micro
    micro = [x.reshape((n_micro, mb) + tuple(x.shape[1:])) for x in batches]
    state = [torch.zeros_like(m[0]) for m in micro]
    outputs = [torch.zeros_like(m) for m in micro]
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_micro + n_stages - 1):
        ys = []
        for p in range(mesh.size):
            x = micro[p][min(t, n_micro - 1)] if idx[p] == 0 else state[p]
            y = fn(local_params[p], x)
            out_t = t - (n_stages - 1)
            if idx[p] == n_stages - 1 and out_t >= 0:
                outputs[p] = outputs[p].index_copy(
                    0, torch.tensor([out_t], device=y.device), y[None])
            ys.append(y)
        state = ppermute(ys, mesh, axis_name, fwd)
    masked = [o if idx[p] == n_stages - 1 else torch.zeros_like(o)
              for p, o in enumerate(outputs)]
    total = all_reduce(masked, mesh, axis_name)
    return [o.reshape((B,) + tuple(batches[0].shape[1:])) for o in total]


def pipeline_spmd(fn, stacked_params, batch, mesh, n_micro, axis_name="pp"):
    """The pipeline over ``mesh``: ``stacked_params`` is a tree (dicts,
    lists, tuples) of tensors with a leading ``n_stages`` axis, each
    position taking its stage's slice; ``fn(stage_params, x)`` is one
    stage. Returns the whole output (the first position's copy)."""
    pos_stage = [mesh.coords(p)[axis_name] for p in range(mesh.size)]
    local = [tree_map(lambda v, s=s, p=p: v[s].to(mesh.device(p),
                                                   copy=True),
                      stacked_params)
             for p, s in enumerate(pos_stage)]
    batches = [batch.to(mesh.device(p), copy=True)
               for p in range(mesh.size)]
    out = pipeline_apply(fn, local, batches, n_micro, mesh, axis_name)[0]
    # a lost stage would wedge the ppermute ring: the collective watchdog
    # bounds the wait (free unless its deadline knob is set)
    from ..resilience.elastic import guard_wait
    return guard_wait(out, op="pipeline.dispatch")
