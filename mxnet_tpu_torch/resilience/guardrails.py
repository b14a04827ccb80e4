"""In-step training guardrails (counterpart of
``mxnet_tpu/resilience/guardrails.py``).

:class:`GuardedStep` wraps a :class:`~..parallel.ShardedTrainer` (on one
device or over a mesh) and guards its step on the device, with no host
round trip:

- **branchless skip**: one all-finite reduction over the loss and every
  gradient (``torch._foreach_norm`` of order inf: NaN and inf survive a
  max) gives a 0-dim bool ``ok``; the update is applied, then every
  parameter, optimizer-state and BatchNorm-aux tensor it wrote is
  committed with ``torch.where(ok, new, old)``. A skipped step leaves them
  bitwise, and leaves the optimizer's step count too: the guard keeps it
  as a device tensor, and Adam reads its bias correction from a table by
  it (``parallel.functional.DeviceStep``), so the steps after a skip equal
  a run without the poisoned batch, bit for bit (``lamb`` divides by host
  scalars and takes the host step, as the reference does);
- **dynamic loss scaling** as device state: the loss times the scale goes
  backward, the gradients times its reciprocal (powers of two: exact in
  fp32); grow every ``scale_window`` clean steps, halve on a skip, floor
  1.0;
- **global-norm clipping** by ``min(1, clip / norm)``;
- **telemetry** (loss, gradient norm, scale, skips, ok) stacked on the
  device and copied to pinned host memory with ``non_blocking``; a CUDA
  event recorded after the copy says when it may be read (``_is_ready``),
  so the guard adds no blocking host sync. Read telemetry feeds an
  :class:`AnomalyDetector`, whose NaN-storm verdict raises
  :class:`AnomalyFault` (``resumable_fit`` restores and replays).

With the defaults (no clip, static scale 1.0) a clean run equals the
unguarded trainer's bit for bit. A :class:`StepWatchdog` thread flags
steps whose telemetry is not ready within a deadline, without blocking.
The guard's state (scale, clean-step counter, skips, the optimizer's step)
rides in checkpoints through ``_checkpoint_extra``. Counters:
``resilience.guardrails.<name>.*`` rows of ``aggregate_rows``;
:func:`health` is degraded while a stall or a storm is live.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from ..observability import tracer as _trace
from . import chaos as _chaos
from ._stats import Registry, export_rows
from .chaos import Fault

__all__ = ["GuardedStep", "AnomalyDetector", "StepWatchdog", "AnomalyFault",
           "all_finite", "global_norm", "scale_update", "poison_nonfinite",
           "health", "all_stats"]


# pinned telemetry slots: steps the host may run ahead of the card
_RING = 256


class AnomalyFault(Fault):
    """A NaN storm: skipped steps dense enough that waiting for a clean
    batch is hopeless. A :class:`~.chaos.Fault`, so ``resumable_fit``'s
    default ``catch`` restores and replays."""


# ---------------------------------------------------------------------------
# device building blocks
# ---------------------------------------------------------------------------

def all_finite(tensors):
    """One device reduction: a 0-dim bool, True when every element of
    every tensor is finite (the tensors on one device)."""
    tensors = [t if t.dim() else t.reshape(1) for t in tensors]
    if not tensors:
        return torch.tensor(True)
    norms = torch._foreach_norm(tensors, float("inf"))
    return torch.isfinite(torch.stack(norms).amax())


def global_norm(tensors):
    """``sqrt(sum of squared L2 norms)``, accumulated in float32 whatever
    the tensors' dtype."""
    if not tensors:
        return torch.tensor(0.0)
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def scale_update(scale, good_steps, ok, scale_factor, scale_window):
    """The dynamic loss-scale schedule on the device (the reference's
    ``LossScaler.update_scale``): on a skip halve (by ``scale_factor``,
    floor 1.0) and reset the clean-step counter; after ``scale_window``
    clean steps in a row grow by ``scale_factor`` and reset it. Returns
    ``(new_scale, new_good_steps)``."""
    good2 = torch.where(ok, good_steps + 1, torch.zeros_like(good_steps))
    grow = good2 >= scale_window
    scale2 = torch.where(ok, torch.where(grow, scale * scale_factor, scale),
                         torch.clamp_min(scale / scale_factor, 1.0))
    good2 = torch.where(grow, torch.zeros_like(good2), good2)
    return scale2, good2


def _nan_like(x):
    from ..parallel.mesh import ShardedTensor
    if isinstance(x, ShardedTensor):
        return ShardedTensor([torch.full_like(s, float("nan"))
                              for s in x.shards], x.sharding, x.shape,
                             x.dtype)
    return torch.full_like(x, float("nan"))


def _tensor_of(x):
    from ..ndarray.ndarray import NDArray
    from ..parallel.mesh import ShardedTensor
    if isinstance(x, (torch.Tensor, ShardedTensor)):
        return x
    if isinstance(x, NDArray):
        return x._data
    return torch.as_tensor(np.asarray(x))


def poison_nonfinite(xs, y):
    """The ``nan`` chaos kind's payload: every floating model input becomes
    NaN (the label, when no input is floating: a token stream cannot hold
    a NaN, but its loss can)."""
    out, hit = [], False
    for x in xs:
        x = _tensor_of(x)
        if x.dtype.is_floating_point:
            out.append(_nan_like(x))
            hit = True
        else:
            out.append(x)
    y = _tensor_of(y)
    if not hit and y.dtype.is_floating_point:
        y = _nan_like(y)
    return tuple(out), y


def _fetch(host):
    """Every host read of telemetry goes through here (tests patch it to
    prove the no-added-sync contract); ``host`` is pinned or CPU memory
    whose copy has finished."""
    return host.numpy().copy()


def _is_ready(event):
    """The step's telemetry copy is done (no event: a CPU step, done)."""
    return event is None or event.query()


# ---------------------------------------------------------------------------
# host monitors
# ---------------------------------------------------------------------------

class AnomalyDetector:
    """A rolling-window monitor of each step's telemetry.

    - **NaN storm**: at least ``storm_skips`` skipped steps in the last
      ``storm_window`` fed ones latch ``storm_active`` (``on_anomaly(
      "storm", ...)`` once a storm); clean steps that bring the density
      under the threshold end it.
    - **loss spike**: a finite loss above ``spike_factor`` times the
      rolling median of the last ``window`` finite losses (once
      ``min_history`` are in), counted, not fatal.
    """

    def __init__(self, window=50, spike_factor=10.0, min_history=8,
                 storm_window=None, storm_skips=None, on_anomaly=None):
        from .. import config as _config
        if storm_window is None:
            storm_window = _config.get("MXNET_GUARDRAILS_STORM_WINDOW")
        if storm_skips is None:
            storm_skips = _config.get("MXNET_GUARDRAILS_STORM_SKIPS")
        self.storm_window = int(storm_window)
        self.storm_skips = int(storm_skips)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self._losses = deque(maxlen=int(window))
        self._recent_skips = deque(maxlen=self.storm_window)
        self._on_anomaly = on_anomaly
        self.spikes = 0
        self.storms = 0
        self.storm_active = False

    def feed(self, loss, gnorm, scale, skips, ok):
        """One step's telemetry (host floats); returns ``"storm"``,
        ``"spike"`` or None."""
        self._recent_skips.append(0 if ok else 1)
        if not ok:
            if (not self.storm_active
                    and sum(self._recent_skips) >= self.storm_skips):
                self.storm_active = True
                self.storms += 1
                if self._on_anomaly is not None:
                    self._on_anomaly("storm", loss, gnorm)
                return "storm"
            return None
        if self.storm_active and sum(self._recent_skips) < self.storm_skips:
            self.storm_active = False
        verdict = None
        if np.isfinite(loss):
            if len(self._losses) >= self.min_history:
                med = float(np.median(self._losses))
                if loss > self.spike_factor * max(abs(med), 1e-12):
                    self.spikes += 1
                    verdict = "spike"
                    if self._on_anomaly is not None:
                        self._on_anomaly("spike", loss, gnorm)
            self._losses.append(float(loss))
        return verdict

    def reset(self):
        """Forget the windows (after a restore: the replay must not inherit
        the storm that ended its predecessor)."""
        self._losses.clear()
        self._recent_skips.clear()
        self.storm_active = False


class StepWatchdog:
    """A deadline on steps in flight. ``watch(step, ready_fn)`` registers
    the newest step; a daemon thread polls ``ready_fn`` (non-blocking: a
    CUDA event's ``query``) and flags a stall (counter, ``on_stall(step,
    elapsed_s)``) when the deadline passes first; a late result counts as
    recovered. ``clock`` is injectable; tests call :meth:`_scan`."""

    def __init__(self, deadline_ms, poll_ms=50.0, clock=time.monotonic,
                 on_stall=None, name="default"):
        if deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (use no watchdog to "
                             "disable)")
        self.deadline_ms = float(deadline_ms)
        self.poll_ms = float(poll_ms)
        self.name = name
        self._clock = clock
        self._on_stall = on_stall
        self._lock = threading.Lock()
        self._current = None
        self._thread = None
        self._stop = threading.Event()
        self.stalls = 0
        self.recovered = 0
        self.watched = 0

    def watch(self, step, ready_fn):
        with self._lock:
            self._current = (int(step), self._clock(), ready_fn, [False])
            self.watched += 1
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="guardrails-watchdog-%s" % self.name)
            self._thread.start()

    def _scan(self):
        """One poll: ``"stall"``, ``"recovered"``, ``"ok"`` or None."""
        with self._lock:
            cur = self._current
        if cur is None:
            return None
        step, t0, ready_fn, stalled = cur
        if ready_fn():
            with self._lock:
                if self._current is cur:
                    self._current = None
            if stalled[0]:
                self.recovered += 1
                return "recovered"
            return "ok"
        elapsed = self._clock() - t0
        if elapsed * 1e3 > self.deadline_ms and not stalled[0]:
            stalled[0] = True
            self.stalls += 1
            _trace.instant("guardrails.stall", watchdog=self.name,
                           step=step, elapsed_s=elapsed)
            if self._on_stall is not None:
                self._on_stall(step, elapsed)
            return "stall"
        return None

    @property
    def stalled_active(self):
        """A watched step is past its deadline and still not ready."""
        with self._lock:
            cur = self._current
        return bool(cur is not None and cur[3][0] and not cur[2]())

    def _run(self):
        while not self._stop.wait(self.poll_ms / 1e3):
            self._scan()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
        with self._lock:
            self._current = None


# ---------------------------------------------------------------------------
# the guarded step
# ---------------------------------------------------------------------------

class GuardedStep:
    """Numerical guardrails around a ``ShardedTrainer``'s step.

    Stands in for the trainer where ``resumable_fit`` and
    ``parallel.checkpoint`` use it (``step``, ``_t``, ``_values``,
    ``_states``, ``plan``, ``mesh``), so ``resumable_fit(GuardedStep(tr),
    ...)`` skips, scales and restores together. Parameters default from the
    ``MXNET_GUARDRAILS_*`` knobs; ``detector=False`` and ``deadline_ms=0``
    turn the monitors off. ``step`` returns the loss as a 0-dim device
    tensor (non-finite on a skipped step) without reading it."""

    def __init__(self, trainer, clip_norm=None, dynamic_scale=None,
                 init_scale=None, scale_factor=None, scale_window=None,
                 detector=None, raise_on_storm=True, deadline_ms=None,
                 watchdog=None, name="trainer"):
        from .. import config as _config
        self._trainer = trainer
        if clip_norm is None:
            clip_norm = _config.get("MXNET_GUARDRAILS_CLIP_NORM")
        self._clip_norm = float(clip_norm) if clip_norm else None
        if dynamic_scale is None:
            dynamic_scale = bool(_config.get(
                "MXNET_GUARDRAILS_DYNAMIC_SCALE"))
        self._dynamic = bool(dynamic_scale)
        if init_scale is None:
            init_scale = (_config.get("MXNET_GUARDRAILS_INIT_SCALE")
                          if self._dynamic else 1.0)
        if scale_factor is None:
            scale_factor = _config.get("MXNET_GUARDRAILS_SCALE_FACTOR")
        if scale_window is None:
            scale_window = _config.get("MXNET_GUARDRAILS_SCALE_WINDOW")
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        if detector is None:
            detector = AnomalyDetector()
        self._detector = detector or None
        self._raise_on_storm = bool(raise_on_storm)
        if watchdog is None:
            if deadline_ms is None:
                deadline_ms = _config.get("MXNET_GUARDRAILS_DEADLINE_MS")
            if deadline_ms and deadline_ms > 0:
                watchdog = StepWatchdog(deadline_ms, name=name)
        self._watchdog = watchdog or None
        self.name = name
        self._set_state(init_scale, 0, 0, trainer._t)
        # the snapshot buffers of every value and optimizer state, made
        # here: a step allocating them could make the allocator free its
        # cache (a host sync) under memory pressure
        self._buffers = {}
        self._snapshot(self._written(None))
        self._ring = None
        if trainer._device.type == "cuda":
            # made here, not in a step: an allocation of pinned memory or
            # a table copy must not add a host sync to the guarded step
            self._ring = torch.empty((_RING, 5), dtype=torch.float32,
                                     pin_memory=True)
            prepare = getattr(trainer._update, "prepare", None)
            if prepare is not None:
                prepare(trainer._device, trainer._t + 1)
        self._pending = deque()
        self._steps = 0
        self._skips = 0
        self._clipped = 0
        self._last = {"loss": float("nan"), "grad_norm": float("nan"),
                      "loss_scale": float(init_scale), "skips": 0, "ok": True}
        _registry.add(self)

    def _set_state(self, scale, good, skips, opt_t):
        dev = self._trainer._device     # a mesh's lead device
        self._gstate = (torch.tensor(float(scale), dtype=torch.float32,
                                     device=dev),
                        torch.tensor(int(good), dtype=torch.int64,
                                     device=dev),
                        torch.tensor(int(skips), dtype=torch.int64,
                                     device=dev),
                        torch.tensor(int(opt_t), dtype=torch.int64,
                                     device=dev))

    # -- the trainer's surface (checkpoint and resume write through it) ----

    @property
    def trainer(self):
        return self._trainer

    @property
    def mesh(self):
        return self._trainer.mesh

    @property
    def plan(self):
        return self._trainer.plan

    @property
    def _plan(self):
        return self._trainer._plan

    @property
    def _mesh(self):
        return self._trainer._mesh

    @property
    def values(self):
        return self._trainer.values

    @property
    def states(self):
        return self._trainer.states

    @property
    def _values(self):
        return self._trainer._values

    @property
    def _states(self):
        return self._trainer._states

    @property
    def _t(self):
        return self._trainer._t

    @_t.setter
    def _t(self, t):
        self._trainer._t = t

    @property
    def learning_rate(self):
        return self._trainer.learning_rate

    def set_learning_rate(self, lr):
        self._trainer.set_learning_rate(lr)

    def sync_back(self):
        self._trainer.sync_back()

    def forward(self, data):
        return self._trainer.forward(data)

    @property
    def opt_step(self):
        """The optimizer's step count (device tensor): the committed
        steps, a skipped one not counted."""
        return self._gstate[3]

    # -- checkpoint hook ------------------------------------------------------

    def _checkpoint_extra(self):
        return {"guard_scale": self._gstate[0],
                "guard_good": self._gstate[1],
                "guard_skips": self._gstate[2],
                "guard_opt_t": self._gstate[3]}

    def _restore_extra(self, extra):
        opt_t = extra.get("guard_opt_t", self._trainer._t)
        self._set_state(extra["guard_scale"], extra["guard_good"],
                        extra["guard_skips"], opt_t)
        self._buffers.clear()      # a restore may have replaced tensors
        self._snapshot(self._written(None))
        self._skips = int(extra["guard_skips"])
        self._last["loss_scale"] = float(extra["guard_scale"])
        self._last["skips"] = self._skips
        self._pending.clear()
        if self._detector is not None:
            self._detector.reset()

    def _restore_plain(self):
        """A checkpoint without guard state (a bare trainer's): the scale
        and the counters stay, the optimizer's step becomes the restored
        step."""
        scale, good, skips, opt_t = self._gstate
        self._gstate = (scale, good, skips,
                        torch.full_like(opt_t, int(self._trainer._t)))
        self._buffers.clear()
        self._snapshot(self._written(None))
        self._pending.clear()
        if self._detector is not None:
            self._detector.reset()

    # -- the step -------------------------------------------------------------

    def step(self, data, label, lr=None):
        """``ShardedTrainer.step`` with the guards: the same staging, the
        ``trainer.step`` chaos point before any state changes and the
        ``trainer.grads`` poison point on the staged batch."""
        tr = self._trainer
        if isinstance(data, list):
            raise TypeError(
                "GuardedStep.step: pass a TUPLE for multi-input models or a "
                "single stacked array; a list is ambiguous")
        _chaos.point("trainer.step")
        xs, y = tr._stage(data, label, _chaos.poisoned("trainer.grads"))
        if tr._mesh is None and tr._preprocess is not None:
            xs = tuple(tr._preprocess(x) for x in xs)
        scale, good, skips, opt_t = self._gstate
        loss, grads, aux = tr._grads(xs, y,
                                     scale if self._dynamic else None)
        names = list(grads)
        glist = [grads[n] for n in names]
        with torch.no_grad():
            if self._dynamic and glist:
                torch._foreach_mul_(glist, torch.reciprocal(scale))
            ok = all_finite([loss] + glist)
            gnorm = global_norm(glist).to(ok.device)
            if self._clip_norm is not None and glist:
                factor = torch.clamp_max(
                    self._clip_norm / (gnorm + 1e-12), 1.0)
                torch._foreach_mul_(glist, factor)
            written = self._written(aux)
            old = self._snapshot(written)
            t = opt_t + 1
            from ..parallel.functional import DeviceStep
            step_t = DeviceStep(t, tr._t) \
                if getattr(tr._update, "device_step", False) else tr._t
            tr._commit(grads, lr, step_t, aux)
            for w, o in zip(written, old):
                torch.where(ok.to(w.device), w, o, out=w)
            if self._dynamic:
                scale2, good2 = scale_update(scale, good, ok,
                                             self._scale_factor,
                                             self._scale_window)
            else:
                scale2, good2 = scale, good
            skips2 = skips + (~ok).to(torch.int64)
            opt_t2 = torch.where(ok, t, opt_t)
            self._gstate = (scale2, good2, skips2, opt_t2)
            telem = torch.stack([loss.float().to(ok.device), gnorm,
                                 scale2, skips2.float(), ok.float()])
            host, event = self._to_host(telem)
        tr._await_plan((loss, tr._values, tr._states))
        self._steps += 1
        self._pending.append((tr._t, host, event))
        if self._watchdog is not None:
            self._watchdog.watch(tr._t, (lambda: True) if event is None
                                 else event.query)
        self._drain(block=False)
        return loss

    def _written(self, aux):
        """Every tensor a commit writes: each trainable value and its
        optimizer state (every shard over a mesh), and the aux targets
        (``aux`` None: the values and states alone)."""
        from ..parallel.mesh import ShardedTensor
        tr = self._trainer
        out = []
        names = list(tr._states) if tr._mesh is None else tr._trainable
        aux_names = []
        if aux is None:
            pass
        elif tr._mesh is None:
            aux_names = [tr._name_of[id(h._data)] for h, _ in aux]
        elif aux[0]:
            name_of = {id(v): n for n, v in aux[1].items()}
            aux_names = [name_of[id(h._data)] for h, _ in aux[0]]
        for n in list(names) + aux_names:
            for t in (tr._values[n],) + tuple(tr._states.get(n, ())):
                out.extend(t.shards if isinstance(t, ShardedTensor) else [t])
        if aux is not None:
            out.extend(tr._aux_targets(aux))
        return out

    def _buffer(self, t):
        """The snapshot buffer kept for ``t`` (made when first needed)."""
        b = self._buffers.get(id(t))
        if b is None or b.shape != t.shape or b.dtype != t.dtype or \
                b.device != t.device:
            b = self._buffers[id(t)] = torch.empty_like(t)
        return b

    def _snapshot(self, tensors):
        """Copies of ``tensors`` in the kept buffers (one multi-tensor copy
        a device and dtype)."""
        old = [self._buffer(t) for t in tensors]
        groups = {}
        for o, t in zip(old, tensors):
            o_list, t_list = groups.setdefault((t.device, t.dtype), ([], []))
            o_list.append(o)
            t_list.append(t)
        for o_list, t_list in groups.values():
            torch._foreach_copy_(o_list, t_list)
        return old

    def _to_host(self, telem):
        """The telemetry in host memory and the event after its copy: a
        ``non_blocking`` copy into a slot of the pinned ring (read once the
        event is done), the tensor itself on the CPU."""
        if telem.device.type != "cuda":
            return telem, None
        if len(self._pending) >= _RING:
            # the host ran a ring ahead of the card: wait for the oldest
            self._drain(block=True)
        host = self._ring[self._steps % _RING]
        host.copy_(telem, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(telem.device))
        return host, event

    def _drain(self, block=False):
        """Feed ready telemetry to the detector and the host mirrors. With
        ``block=False`` the first entry not ready ends the drain (no added
        host sync); ``block=True`` (:meth:`flush`) waits each out."""
        storm = None
        while self._pending:
            step_no, host, event = self._pending[0]
            if not block and not _is_ready(event):
                break
            if block and event is not None:
                event.synchronize()
            vals = _fetch(host)
            self._pending.popleft()
            loss, gnorm, scale, skips, okf = (float(v) for v in vals)
            ok = okf >= 0.5
            self._last = {"loss": loss, "grad_norm": gnorm,
                          "loss_scale": scale, "skips": int(skips),
                          "ok": ok}
            if not ok:
                _trace.instant("guardrails.skip", guarded=self.name,
                               step=step_no, loss=loss, loss_scale=scale)
            self._skips = int(skips)
            if (ok and self._clip_norm is not None
                    and np.isfinite(gnorm) and gnorm > self._clip_norm):
                self._clipped += 1
            if self._detector is not None:
                verdict = self._detector.feed(loss, gnorm, scale,
                                              int(skips), ok)
                if verdict == "storm":
                    storm = (step_no, loss)
        if storm is not None and self._raise_on_storm:
            self._detector.reset()
            _trace.instant("guardrails.anomaly", guarded=self.name,
                           step=storm[0], loss=storm[1], kind="nan_storm")
            raise AnomalyFault(
                "NaN storm: >= %d skipped steps in the last %d (at step %d): "
                "restore-and-replay" % (self._detector.storm_skips,
                                        self._detector.storm_window,
                                        storm[0]))

    def flush(self):
        """Wait out and read every pending telemetry entry."""
        self._drain(block=True)

    def telemetry(self):
        """The latest read step's ``{loss, grad_norm, loss_scale, skips,
        ok}`` (host floats)."""
        self._drain(block=False)
        return dict(self._last)

    @property
    def loss_scale(self):
        """The loss scale as last read from telemetry."""
        return self._last["loss_scale"]

    @property
    def skipped_steps(self):
        return self._skips

    def stats(self):
        rows = {"steps": self._steps, "skips": self._skips,
                "clipped": self._clipped,
                "loss_scale": int(self._last["loss_scale"])}
        if self._detector is not None:
            rows["spikes"] = self._detector.spikes
            rows["storms"] = self._detector.storms
        if self._watchdog is not None:
            rows["watchdog_stalls"] = self._watchdog.stalls
        return rows

    def health(self):
        """``ok``, or ``degraded`` with reasons (a live stall, a storm)."""
        reasons = []
        if self._watchdog is not None and self._watchdog.stalled_active:
            reasons.append("watchdog: step %s ms deadline exceeded"
                           % int(self._watchdog.deadline_ms))
        if self._detector is not None and self._detector.storm_active:
            reasons.append("nan_storm")
        if reasons:
            return {"status": "degraded", "reasons": reasons,
                    "skips": self._skips}
        return {"status": "ok"}

    def close(self):
        """Stop the watchdog (clearing a live stall) and leave the
        registry."""
        if self._watchdog is not None:
            self._watchdog.close()
        _registry.discard(self)


# ---------------------------------------------------------------------------
# registry and process-wide views
# ---------------------------------------------------------------------------

_registry = Registry()


def all_stats():
    """``{name: stats}`` of the registered :class:`GuardedStep` s."""
    return _registry.map(lambda g: g.stats())


def health():
    """``degraded`` while any registered guarded step has a live stall or
    NaN storm."""
    bad = {name: h for name, h in
           _registry.map(lambda g: g.health()).items()
           if h["status"] != "ok"}
    if bad:
        return {"status": "degraded", "guarded": bad}
    return {"status": "ok"}


def _rows():
    rows = {}
    for name, st in all_stats().items():
        for k, v in st.items():
            rows["resilience.guardrails.%s.%s" % (name, k)] = (v, 0.0)
    return rows


export_rows(_rows)
