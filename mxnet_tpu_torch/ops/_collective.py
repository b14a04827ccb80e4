"""Where an op meets the other replicas of a mesh step.

The reference's mesh step is one SPMD program over the global batch: where
an op reduces over the batch (BatchNorm's moments, Switch routing's token
pool), XLA reduces over every device inside the program. The port runs one
replica of the step per data shard (``parallel.replicas``), and the replica
group sets the running replica here, for its thread, for the length of the
step. Ops ask only this module, so the op layer does not depend on the
distribution layer above it. Outside a mesh step (or with one replica)
every function here hands its input back, and the op stays local.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["current", "batch_mean", "batch_gather"]

_tls = threading.local()


def current():
    """The calling thread's mesh-step replica, or None."""
    return getattr(_tls, "replica", None)


def set_current(replica):
    """Make ``replica`` (None: none) the calling thread's replica; the
    replica group calls this around each replica's run."""
    _tls.replica = replica


def batch_mean(xs, axis=None):
    """Each tensor of the tuple ``xs`` (of one shape) averaged over the
    running step's replicas, added in replica order: over all of them, or
    with ``axis`` over those that differ only along that data axis. ``xs``
    itself outside a step, with one replica, or when ``axis`` is not one of
    the step's data axes."""
    rep = current()
    if rep is None or rep.n == 1:
        return xs
    if axis is not None and not rep.has_axis(axis):
        return xs
    return tuple(rep.mean(torch.stack(xs), axis).unbind(0))


def batch_gather(x):
    """``(pool, own)``: every replica's ``x`` concatenated along the
    leading axis in replica order, and the slice of ``pool`` that is this
    replica's ``x``. ``(x, slice(None))`` outside a step or with one
    replica."""
    rep = current()
    if rep is None or rep.n == 1:
        return x, slice(None)
    b = x.shape[0]
    return rep.all_gather(x, 0), slice(rep.index * b, (rep.index + 1) * b)
