"""Training auto-resume: checkpoint every K steps, restore and replay on a
fault (counterpart of ``mxnet_tpu/resilience/resume.py``).

:func:`resumable_fit` runs ``trainer.step`` over a batch schedule with a
rolling checkpoint (``parallel/checkpoint.py``); when a fault escapes a
step (or a save), it restores the last good checkpoint and replays the
batches from the checkpointed step. The contract: an interrupted and
resumed run ends with the parameters of an uninterrupted run of the same
seed and step count, bit for bit. The checkpoint round-trips the exact
bytes and the port's step runs the same kernels on the same inputs;
models that draw randomness inside the step (dropout) get ``seed=``, and
the loop re-seeds each step from ``seed + absolute_step``.

Counters: ``resilience.resume.{checkpoints,restores,replayed_steps,
completed_runs}`` rows of ``aggregate_rows``.
"""
from __future__ import annotations

import os
import threading

from .chaos import Fault

__all__ = ["resumable_fit", "ResumeGaveUp", "resume_stats"]


class ResumeGaveUp(RuntimeError):
    """``max_restores`` restore-and-replay cycles in a row made no
    progress; ``__cause__`` is the last fault."""


_lock = threading.Lock()
_counters = {"checkpoints": 0, "restores": 0, "replayed_steps": 0,
             "completed_runs": 0}


def _count(key, n=1):
    with _lock:
        _counters[key] += n


def resume_stats():
    with _lock:
        return dict(_counters)


def _loss_float(loss):
    if hasattr(loss, "asnumpy"):
        return float(loss.asnumpy())
    return float(loss)


def resumable_fit(trainer, batches, ckpt_dir, ckpt_every=None,
                  max_restores=8, seed=None, catch=(Fault,),
                  on_restore=None, on_step=None, preemption=None):
    """Run ``trainer.step`` over ``batches`` with checkpoint, restore and
    replay.

    ``trainer``: a ``ShardedTrainer`` (or a ``GuardedStep``), stepped in
    place; its ``_t`` is the resume cursor. ``batches``: the whole epoch as
    an indexable sequence of ``(data, label)``. ``ckpt_dir``: the rolling
    checkpoint's directory. ``ckpt_every``: the cadence in steps
    (``MXNET_RESUME_EVERY``); one checkpoint is always written before the
    first step. ``max_restores``: restore cycles in a row before
    :class:`ResumeGaveUp`. ``seed``: re-seed ``random`` from ``seed +
    absolute_step`` before each step. ``catch``: what restores and
    replays (injected faults; a ``GuardedStep``'s ``AnomalyFault`` is
    one). ``on_restore(step, exc)`` after each restore; ``on_step(step,
    loss)`` after each step (the elastic heartbeat). ``preemption``: a
    :class:`~.elastic.PreemptionHandler` read at every step boundary; a
    notice writes the emergency checkpoint and raises
    :class:`~.elastic.Preempted`, which is never caught here.

    Returns the per-batch losses as floats (a replayed step overwrites the
    lost value). Reading each loss is one host sync a step, as in the
    reference."""
    from ..parallel.checkpoint import restore_checkpoint, save_checkpoint
    from .. import random as _rnd
    from .elastic import CollectiveTimeout, Preempted

    if ckpt_every is None:
        from .. import config as _config
        ckpt_every = _config.get("MXNET_RESUME_EVERY")
    if ckpt_every < 1:
        raise ValueError("ckpt_every must be >= 1")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(os.path.abspath(ckpt_dir), "resume_ckpt")

    t0 = trainer._t
    total = len(batches)
    losses = [None] * total
    for attempt in range(max_restores + 1):
        try:
            save_checkpoint(trainer, ckpt)
            break
        except catch as exc:
            if attempt >= max_restores:
                raise ResumeGaveUp(
                    "initial checkpoint failed %d time(s)" % (attempt + 1)
                ) from exc
    _count("checkpoints")
    restores = 0
    replaying_until = 0

    while trainer._t - t0 < total:
        if preemption is not None and preemption.triggered():
            from .elastic import emergency_checkpoint
            for attempt in range(max_restores + 1):
                try:
                    emergency_checkpoint(trainer, ckpt, preemption)
                except Preempted:
                    raise
                except catch:
                    left = preemption.deadline_left_ms()
                    if attempt >= max_restores or (left is not None
                                                   and left <= 0):
                        raise
        i = trainer._t - t0
        try:
            if seed is not None:
                _rnd.seed(int(seed) + trainer._t + 1)
            x, y = batches[i]
            loss = trainer.step(x, y)
            losses[i] = _loss_float(loss)
            if i < replaying_until:
                _count("replayed_steps")
            if on_step is not None:
                on_step(trainer._t, losses[i])
            done = trainer._t - t0
            if done % ckpt_every == 0 or done == total:
                save_checkpoint(trainer, ckpt)
                _count("checkpoints")
                restores = 0
        except (Preempted, CollectiveTimeout):
            raise
        except catch as exc:
            restores += 1
            if restores > max_restores:
                raise ResumeGaveUp(
                    "no progress after %d restore(s) at step %d"
                    % (restores - 1, trainer._t)) from exc
            restore_checkpoint(trainer, ckpt)
            _count("restores")
            replaying_until = max(replaying_until, i + 1)
            if on_restore is not None:
                on_restore(trainer._t, exc)
    _count("completed_runs")
    return losses


def _rows():
    st = resume_stats()
    return {("resilience.resume.%s" % k): (v, 0.0) for k, v in st.items()}


from ._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_rows)
