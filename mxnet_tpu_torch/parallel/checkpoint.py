"""Checkpoints of a ``ShardedTrainer``: counterpart of
``mxnet_tpu/parallel/checkpoint.py``.

:func:`save_checkpoint` writes a directory with what the reference's tree
holds (its ``_tree``): the step, the world (mesh positions), the
parameter names, the values, the optimizer states and the plan. The
reference writes it with Orbax; the port keeps formats of its own that
need no package beyond torch:

- ``manifest.json``: step, world, names, shapes, dtypes, the number of
  state tensors of each parameter, the plan (``plan.to_dict()`` or
  null), and a wrapper's own state (``_checkpoint_extra``: a
  ``GuardedStep``'s loss scale, counters and optimizer step) under
  ``extra``;
- ``values.params``: every value whole, in the reference's ``.params``
  binary format (names ``p0000``, ``p0001``, ... by position, as the
  reference keys its tree: auto-generated names differ between otherwise
  equal trainers);
- ``states.states``: the optimizer states whole, in the reference's
  ``.states`` pickle format (index -> tuple of arrays).

The directory is staged as ``path + ".tmp"`` and renamed onto ``path``
only once it is complete, with the ``checkpoint.save`` chaos point
between, as in the reference, so a crash leaves the last good checkpoint.

:func:`restore_checkpoint` places every value and state on the restoring
trainer's own shardings, whatever mesh or plan saved them; a value whose
shape cannot land there raises :class:`~.planner.PlanMismatchError`
naming both placements (a plain ``ValueError`` when neither side has a
plan). A restore onto another world (mesh size) counts in
``resilience.elastic``'s ``resharded_restores``, onto another plan in its
``replans``. Reading the reference's Orbax directories is not ported
(ROADMAP).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..ndarray.serialization import load_ndarrays, save_ndarrays
from ..observability import tracer as _trace
from ..optimizer import states as _states
from ..resilience import chaos as _chaos
from .mesh import ShardedTensor

__all__ = ["save_checkpoint", "restore_checkpoint"]


def _names(trainer):
    return list(trainer._values)


def _key(i):
    return "p%04d" % i


def _whole(v):
    return v.full(torch.device("cpu")) if isinstance(v, ShardedTensor) \
        else v.detach().cpu()


def _world(trainer):
    mesh = trainer.mesh
    return 1 if mesh is None else mesh.size


def save_checkpoint(trainer, path, force=True):
    """Write the trainer's step, values, optimizer states and plan to the
    directory ``path`` (atomically: staged, then renamed)."""
    with _trace.span("checkpoint.save", path=path, step=trainer._t):
        return _save(trainer, path, force)


def _save(trainer, path, force):
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if not os.path.exists(path) and os.path.exists(old):
        # a crash between the two renames below: `old` is the last good one
        os.rename(old, path)
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    if os.path.exists(path) and not force:
        raise FileExistsError("checkpoint %s exists (force=False)" % path)
    os.makedirs(tmp)
    names = _names(trainer)
    values = [_whole(trainer._values[n]) for n in names]
    save_ndarrays(os.path.join(tmp, "values.params"), values,
                  [_key(i) for i in range(len(names))])
    states, n_states = {}, []
    for i, n in enumerate(names):
        st = trainer._states.get(n)
        n_states.append(0 if st is None else len(st))
        if st:
            states[i] = tuple(_whole(s) for s in st)
    with open(os.path.join(tmp, "states.states"), "wb") as f:
        f.write(_states.dumps(states))
    plan = trainer.plan
    manifest = {"format": 1, "step": int(trainer._t),
                "world": _world(trainer), "names": names,
                "shapes": [list(v.shape) for v in values],
                "dtypes": [str(v.dtype).replace("torch.", "")
                           for v in values],
                "n_states": n_states,
                "plan": None if plan is None else plan.to_dict()}
    if hasattr(trainer, "_checkpoint_extra"):
        # a wrapper's own state (GuardedStep: loss scale, counters, the
        # optimizer's step), as exact host numbers
        manifest["extra"] = {k: torch.as_tensor(v).item()
                             for k, v in trainer._checkpoint_extra().items()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _chaos.point("checkpoint.save")
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def restore_checkpoint(trainer, path):
    """Restore :func:`save_checkpoint`'s directory onto the trainer's own
    device or mesh shardings (the saving mesh or plan may differ)."""
    with _trace.span("checkpoint.restore", path=path):
        return _restore(trainer, path)


def _mismatch(trainer, saved_plan, detail):
    cur = trainer.plan
    cur_d = None if cur is None else cur.to_dict()
    if saved_plan is None and cur_d is None:
        return ValueError(detail)
    from .planner import PlanMismatchError
    return PlanMismatchError(saved_plan, cur_d, detail)


def _restore(trainer, path):
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        os.rename(path + ".old", path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = _names(trainer)
    saved_plan = manifest.get("plan")
    if len(manifest["names"]) != len(names):
        raise _mismatch(trainer, saved_plan,
                        "checkpoint holds %d parameters, the trainer %d"
                        % (len(manifest["names"]), len(names)))
    for i, n in enumerate(names):
        want = tuple(trainer._values[n].shape)
        got = tuple(manifest["shapes"][i])
        if want != got:
            raise _mismatch(trainer, saved_plan,
                            "param %s saved with shape %s cannot reshard "
                            "onto current shape %s" % (_key(i), got, want))
    arrays, keys = load_ndarrays(os.path.join(path, "values.params"))
    values = dict(zip(keys, arrays))
    with open(os.path.join(path, "states.states"), "rb") as f:
        states = _states.loads(f.read())
    for i, n in enumerate(names):
        trainer._values[n] = _into(trainer._values[n], values[_key(i)])
        st = trainer._states.get(n)
        if st:
            trainer._states[n] = tuple(
                _into(cur, s) for cur, s in zip(st, states[i]))
    trainer._t = int(manifest["step"])
    if "extra" in manifest and hasattr(trainer, "_restore_extra"):
        trainer._restore_extra(manifest["extra"])
    elif hasattr(trainer, "_restore_plain"):
        trainer._restore_plain()
    from ..resilience import elastic as _elastic
    now_world = _world(trainer)
    if int(manifest["world"]) != now_world:
        # the elastic reshard: state written on one topology landed on
        # another
        _elastic._count("resharded_restores")
        _trace.instant("elastic.reshard", saved_world=manifest["world"],
                       world=now_world, step=trainer._t)
    cur = trainer.plan
    if saved_plan is not None and cur is not None and \
            saved_plan != cur.to_dict():
        # the elastic re-plan: a placement written under one plan landed
        # on another
        _elastic._count("replans")
        _trace.instant("elastic.replan", saved=saved_plan,
                       current=cur.to_dict(), step=trainer._t)
    return trainer


def _into(current, whole):
    """``whole`` (a numpy array or a tensor) in ``current``'s place: its
    sharding (an owned copy per position), or copied into it."""
    if not isinstance(whole, torch.Tensor):
        whole = torch.from_numpy(np.ascontiguousarray(whole))
    whole = whole.to(current.dtype)
    if isinstance(current, ShardedTensor):
        return ShardedTensor.place(whole, current.sharding)
    with torch.no_grad():
        current.copy_(whole)
    return current
