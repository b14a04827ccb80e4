"""Data-parallel replicas in one process, run in lock step.

The reference's mesh step is one SPMD program over the global batch: where
an op reduces over the batch (BatchNorm's moments, Switch routing's token
positions), XLA inserts the cross-device reduction. The port runs one
replica of the step per data shard instead, so such an op has to meet its
sibling replicas in the middle of a forward. :class:`ReplicaGroup` makes
that possible without giving up determinism: each replica runs on a thread
of its own, but only one runs at a time, and the turn passes only at a
collective (:meth:`Replica.exchange`) or at the replica's end, in replica
order. So the replicas' ops are issued in the same order on every run, a
collective adds its inputs in replica order, and module state that the
running replica installs (its parameter tensors: ``on_turn``) is never
seen by another one.

The group makes the running replica the thread's
:func:`~mxnet_tpu_torch.ops._collective.current` (None outside a mesh
step), through which ops reduce over the batch (``_collective.batch_mean``,
``batch_gather``); outside a step they stay local. The collectives are
differentiable: a gathered or averaged value keeps the autograd links to
every replica's input, so one backward over the sum of the replicas'
losses takes the gradient through them.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops._collective import current, set_current

__all__ = ["ReplicaGroup", "Replica", "current"]


class _Aborted(Exception):
    """A sibling replica failed; this one stops."""


class Replica:
    """One replica of a mesh step: ``index`` in ``0 .. n - 1`` over the
    data axes ``axes`` of ``mesh``, computing on ``device``."""

    def __init__(self, group, index, device):
        self.group = group
        self.index = index
        self.device = device

    @property
    def n(self):
        return self.group.n

    @property
    def axes(self):
        return self.group.axes

    @property
    def mesh(self):
        return self.group.mesh

    def has_axis(self, axis):
        """Whether the step's data axes include ``axis`` (or all of a
        tuple), with more than one replica over it."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        return all(a in self.axes for a in axes) and \
            self.mesh.axis_size(axes) > 1

    def exchange(self, value):
        """Every replica's ``value``, in replica order (after all have
        given theirs)."""
        return self.group._exchange(self.index, value)

    def all_gather(self, x, dim=0):
        """The replicas' ``x`` concatenated along ``dim``, on this
        replica's device."""
        if self.n == 1:
            return x
        return torch.cat([v.to(x.device) for v in self.exchange(x)], dim)

    def mean(self, x, axis=None):
        """The mean of ``x`` over the replicas (added in replica order);
        with ``axis`` (one of the data axes), over the replicas that
        differ only along it."""
        if self.n == 1:
            return x
        values = self.exchange(x)
        members = range(self.n) if axis is None else \
            self.group.members(self.index, axis)
        acc = None
        for r in members:
            v = values[r].to(x.device)
            acc = v if acc is None else acc + v
        return acc / len(members)


class ReplicaGroup:
    """``n`` replicas over the data axes ``axes`` of ``mesh``; :meth:`run`
    runs one function per replica in lock step."""

    def __init__(self, mesh, axes, devices, on_turn=None):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.devices = list(devices)
        self.n = len(self.devices)
        self._on_turn = on_turn
        self._cond = threading.Condition()
        self._turn = 0
        self._rounds = []
        self._round_of = [0] * self.n
        self._done = [False] * self.n
        self._error = None

    def members(self, r, axis):
        """The replicas that share replica ``r``'s coordinates on every
        data axis but ``axis``."""
        sizes = [self.mesh.axis_size(a) for a in self.axes]
        coords = np.unravel_index(r, sizes)
        keep = [i for i, a in enumerate(self.axes) if a != axis]
        return [q for q in range(self.n)
                if all(np.unravel_index(q, sizes)[i] == coords[i]
                       for i in keep)]

    def run(self, fns, state=None):
        """Run ``fns[r]()`` as replica ``r`` and return their results.
        ``state``: thread-local objects whose attributes each replica
        thread starts from (the caller's context scope, autograd flags)."""
        if self.n == 1:
            return [self._body(0, fns[0])]
        snapshot = [(obj, dict(obj.__dict__)) for obj in state or ()]
        results = [None] * self.n
        threads = [threading.Thread(
            target=self._thread, args=(r, fns[r], snapshot, results),
            name="replica-%d" % r, daemon=True) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return results

    def _body(self, r, fn):
        set_current(Replica(self, r, self.devices[r]))
        try:
            if self._on_turn is not None:
                self._on_turn(r)
            dev = self.devices[r]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fn()
            return fn()
        finally:
            set_current(None)

    def _thread(self, r, fn, snapshot, results):
        for obj, attrs in snapshot:
            for k, v in attrs.items():
                setattr(obj, k, list(v) if isinstance(v, list) else v)
        grad = torch.is_grad_enabled()
        try:
            with self._cond:
                self._wait_turn(r)
            with torch.set_grad_enabled(grad):
                results[r] = self._body(r, fn)
        except _Aborted:
            pass
        except BaseException as exc:   # noqa: BLE001: handed to run()
            with self._cond:
                if self._error is None:
                    self._error = exc
                self._cond.notify_all()
            return
        with self._cond:
            self._done[r] = True
            self._pass(r)

    def _wait_turn(self, r):
        while self._turn != r:
            if self._error is not None:
                raise _Aborted()
            self._cond.wait()
        if self._error is not None:
            raise _Aborted()

    def _pass(self, r):
        """The turn goes to the next replica that has not ended."""
        for i in range(1, self.n + 1):
            nxt = (r + i) % self.n
            if not self._done[nxt]:
                self._turn = nxt
                break
        self._cond.notify_all()

    def _mismatch(self):
        self._error = RuntimeError(
            "replicas of a mesh step reached different collectives")
        self._cond.notify_all()
        return self._error

    def _exchange(self, r, value):
        with self._cond:
            k = self._round_of[r]
            self._round_of[r] += 1
            if k == len(self._rounds):
                self._rounds.append([None] * self.n)
            self._rounds[k][r] = value
            if any(self._done):
                raise self._mismatch()
            self._pass(r)
            self._wait_turn(r)
            values = self._rounds[k]
            if any(v is None for v in values):
                raise self._mismatch()
        if self._on_turn is not None:
            self._on_turn(r)
        return list(values)
