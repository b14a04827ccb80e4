"""Elastic, preemption-tolerant training of several processes (counterpart
of ``mxnet_tpu/resilience/elastic.py``).

``resilience.resume`` makes a fault inside one process survivable
(restore-and-replay); this module makes the process itself expendable:

- **Rendezvous and membership**: :class:`ElasticMember` (worker side) and
  :class:`ElasticCoordinator` (supervisor side) share a file rendezvous
  directory. Each worker publishes an atomic heartbeat record carrying its
  step; the supervisor declares a host dead after a missed-beat deadline.
  Files, not sockets: the protocol survives supervisor restarts and runs
  from tests with injected clocks.
- **Preemption**: :class:`PreemptionHandler` turns SIGTERM/SIGUSR1 into a
  flag the training loop reads at step boundaries;
  :func:`emergency_checkpoint` publishes the trainer's state through the
  atomic staging and rename of ``parallel/checkpoint.py`` inside the grace
  window and raises :class:`Preempted` (not a
  :class:`~.chaos.Fault`: a clean preemption never counts toward
  ``ResumeGaveUp``'s restore budget).
- **Elastic resume**: :func:`elastic_fit` restores an existing rolling
  checkpoint onto the trainer's current device or mesh and replays from
  the restored step, so a run that started on N processes continues on
  N-1. ``python -m mxnet_tpu_torch.tools.launch --supervise`` is the other
  half: restart with backoff, evict, re-form at the surviving world size.
- **Collective watchdog**: :class:`CollectiveWatchdog` bounds operations
  that wedge when a peer dies mid-collective (a hung all-reduce blocks,
  it does not fail): past the deadline it counts, emits a tracer instant
  and raises :class:`CollectiveTimeout`. :func:`guard_collective` wraps
  the kvstore's all-reduce and barrier, :func:`guard_wait` the dispatch
  of ring attention, the MoE FFN, the pipeline and a multi-axis trainer
  step (it waits on a CUDA event recorded after the work, or on a
  collective's work handle). Both are off unless
  ``MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS`` is set.

Counters: :func:`elastic_stats` (``resilience.elastic.*`` rows of
``aggregate_rows``); tracer instants ``elastic.preempt``,
``elastic.emergency_checkpoint``, ``elastic.resume``, ``elastic.reshard``,
``elastic.replan``, ``elastic.collective_timeout``, ``elastic.register``,
``elastic.leave``, ``elastic.dead``; :func:`health` and
:func:`membership_gauge` for ``/healthz`` and ``/metrics``.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import weakref

from ..observability import tracer as _trace
from .chaos import EXIT_HOST_LOSS

__all__ = ["Preempted", "CollectiveTimeout", "PreemptionHandler",
           "ElasticMember", "ElasticCoordinator", "CollectiveWatchdog",
           "elastic_fit", "emergency_checkpoint", "guard_collective",
           "guard_wait", "collective_alarm", "clear_collective_alarm",
           "install_preemption_handler", "current_handler",
           "preemption_pending", "membership_gauge", "health",
           "elastic_stats", "current_rank", "dead_in_job", "EXIT_PREEMPTED",
           "EXIT_HOST_LOSS"]

# a preempted worker's exit code after a successful emergency checkpoint
# (EX_TEMPFAIL: the supervise loop reads it as an eviction, not a crash)
EXIT_PREEMPTED = 75


class Preempted(Exception):
    """The host is being evicted and the emergency checkpoint is on disk.

    Raised at a step boundary, with the trainer's state the published
    checkpoint's. Not a :class:`~.chaos.Fault`: ``resumable_fit`` lets it
    escape instead of spending a restore on it."""

    def __init__(self, step, ckpt=None, grace_left_ms=None, signum=None):
        msg = "preempted at step %s" % step
        if grace_left_ms is not None:
            msg += " (%.0f ms of grace left)" % grace_left_ms
        super().__init__(msg)
        self.step = step
        self.ckpt = ckpt
        self.grace_left_ms = grace_left_ms
        self.signum = signum


class CollectiveTimeout(RuntimeError):
    """A guarded collective ran past its deadline and the watchdog aborted
    the wait. Not a :class:`~.chaos.Fault`: a retry or a replay would
    block in the same dead collective, so neither ``RetryPolicy`` nor
    ``resumable_fit``'s default ``catch`` absorbs it; it escapes to the
    process boundary, where the supervisor re-forms the world."""


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_counters = {"preemptions": 0, "emergency_checkpoints": 0,
             "grace_overruns": 0, "elastic_resumes": 0,
             "resharded_restores": 0, "replans": 0, "heartbeats": 0,
             "registrations": 0, "leaves": 0, "dead_declared": 0,
             "collective_timeouts": 0, "guarded_collectives": 0}


def _count(key, n=1):
    with _lock:
        _counters[key] += n


def elastic_stats():
    with _lock:
        return dict(_counters)


# the /healthz collective alarm: a watchdog timeout latches it; a later
# guarded collective that completes clears it
_alarm_lock = threading.Lock()
_collective_alarm = None


def _set_collective_alarm(op, deadline_ms):
    global _collective_alarm
    with _alarm_lock:
        _collective_alarm = {"op": op, "deadline_ms": float(deadline_ms)}


def collective_alarm():
    """The pending hung-collective alarm, or ``None``."""
    with _alarm_lock:
        return dict(_collective_alarm) if _collective_alarm else None


def clear_collective_alarm():
    global _collective_alarm
    with _alarm_lock:
        _collective_alarm = None


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

_handler_lock = threading.Lock()
_current_handler = None


class PreemptionHandler:
    """Grace-window preemption flag: SIGTERM/SIGUSR1 set it, the training
    loop reads it at step boundaries.

    The signal handler makes plain attribute writes only (the interrupted
    code may hold any lock); the counter and the tracer instant wait for
    the first :meth:`triggered` read on a normal thread, and the emergency
    checkpoint happens on the training thread, where the trainer's state
    is consistent. ``clock`` is injectable; tests call :meth:`trigger`.
    Use as a context manager or through :meth:`install`/:meth:`uninstall`
    (the main thread only: signal dispositions are process-wide)."""

    def __init__(self, grace_ms=None, signals=None, clock=time.monotonic):
        if grace_ms is None:
            from .. import config as _config
            grace_ms = _config.get("MXNET_ELASTIC_GRACE_MS")
        self.grace_ms = float(grace_ms)
        self.signals = tuple(signals) if signals is not None \
            else (signal.SIGTERM, signal.SIGUSR1)
        self._clock = clock
        self._flag = False
        self._t0 = None
        self.signum = None
        self._noticed = False
        self._note_lock = threading.Lock()
        self._old = {}

    def install(self):
        global _current_handler
        for s in self.signals:
            self._old[s] = signal.signal(s, self._on_signal)
        with _handler_lock:
            _current_handler = self
        return self

    def uninstall(self):
        global _current_handler
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        with _handler_lock:
            if _current_handler is self:
                _current_handler = None

    def _on_signal(self, signum, frame):
        if self._t0 is None:
            self._t0 = self._clock()
            self.signum = signum
        self._flag = True

    def trigger(self, signum=signal.SIGTERM):
        """Record the eviction notice from a normal thread. The grace clock
        starts at the first notice; later ones do not extend it."""
        self._on_signal(signum, None)
        self._note()

    def _note(self):
        if self._noticed or self._t0 is None:
            return
        with self._note_lock:
            if self._noticed:
                return
            self._noticed = True
        _count("preemptions")
        _trace.instant("elastic.preempt", signum=int(self.signum),
                       grace_ms=self.grace_ms)

    def triggered(self):
        if self._flag:
            self._note()
            return True
        return False

    def deadline_left_ms(self):
        """Grace left, or ``None`` before any notice."""
        t0 = self._t0
        if t0 is None:
            return None
        return self.grace_ms - (self._clock() - t0) * 1e3

    def reset(self):
        """Forget a delivered notice."""
        self._flag = False
        self._t0 = None
        self.signum = None
        self._noticed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()


def install_preemption_handler(grace_ms=None, signals=None):
    """Install and return a process-wide :class:`PreemptionHandler`."""
    return PreemptionHandler(grace_ms=grace_ms, signals=signals).install()


def current_handler():
    with _handler_lock:
        return _current_handler


def preemption_pending():
    """True when the installed handler holds an eviction notice."""
    h = current_handler()
    return h is not None and h.triggered()


# ---------------------------------------------------------------------------
# file rendezvous: membership and heartbeats
# ---------------------------------------------------------------------------

def _write_json_atomic(path, payload):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _member_path(rdzv_dir, rank):
    return os.path.join(rdzv_dir, "member-%05d.json" % int(rank))


_gauge_lock = threading.Lock()
_gauge_member = None
_gauge_coordinator = None


class ElasticMember:
    """Worker-side membership: heartbeat records in the rendezvous
    directory, ``{rank, pid, status, step, start, beat, time, world,
    gen}``. ``status`` goes from ``up`` to one of ``done``, ``preempted``
    or ``failed`` (:meth:`leave`); a host that dies leaves a stale ``up``
    record, which the coordinator's missed-beat deadline catches.

    Beats come from :meth:`heartbeat` at each step; :meth:`start` runs a
    background beater for phases without steps (restore, the first
    step's warm-up)."""

    def __init__(self, rdzv_dir, rank, world_size=None, heartbeat_ms=None,
                 clock=time.time, generation=None):
        if heartbeat_ms is None:
            from .. import config as _config
            heartbeat_ms = _config.get("MXNET_ELASTIC_HEARTBEAT_MS")
        if generation is None:
            # the supervisor stamps each generation into MXTPU_GENERATION
            # and its coordinator reads only that generation's records
            generation = int(os.environ.get("MXTPU_GENERATION", "0"))
        os.makedirs(rdzv_dir, exist_ok=True)
        self.rdzv_dir = os.path.abspath(rdzv_dir)
        self.rank = int(rank)
        self.world_size = None if world_size is None else int(world_size)
        self.heartbeat_ms = float(heartbeat_ms)
        self.generation = int(generation)
        self._clock = clock
        self._beats = 0
        self._step = 0
        self._start = 0
        self._status = "up"
        self._thread = None
        self._stop = threading.Event()
        self._write_lock = threading.Lock()
        global _gauge_member
        with _gauge_lock:
            _gauge_member = weakref.ref(self)

    def _write(self, status, step):
        with self._write_lock:
            self._beats += 1
            self._status = status
            self._step = int(step)
            _write_json_atomic(_member_path(self.rdzv_dir, self.rank), {
                "rank": self.rank, "pid": os.getpid(), "status": status,
                "step": int(step), "start": self._start,
                "beat": self._beats, "time": float(self._clock()),
                "world": self.world_size, "gen": self.generation})

    def register(self, step=0):
        """The first record (beat 1). ``step``, the checkpoint step this
        incarnation resumed from, is kept as ``start`` in every record:
        the supervisor's crash accounting reads durable progress from
        it."""
        self._start = int(step)
        self._write("up", step)
        _count("registrations")
        _trace.instant("elastic.register", rank=self.rank, step=int(step))
        return self

    def heartbeat(self, step=None, status="up"):
        self._write(status, self._step if step is None else step)
        _count("heartbeats")

    def start(self):
        """Background beats at ``heartbeat_ms`` for a phase with no step
        cadence; a wedged training thread is invisible while it runs
        (``elastic_fit`` stops it at the first step's beat)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="elastic-member-%d" % self.rank)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.heartbeat_ms / 1e3):
            try:
                self.heartbeat()
            except OSError:
                continue

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def leave(self, status="done", step=None):
        """The terminal record: a departure the coordinator never declares
        dead."""
        self.stop()
        self._write(status, self._step if step is None else step)
        _count("leaves")
        _trace.instant("elastic.leave", rank=self.rank, status=status,
                       step=self._step)

    def __enter__(self):
        return self.register()

    def __exit__(self, *exc):
        if self._status == "up":
            self.leave("failed" if exc and exc[0] is not None else "done")
        else:
            self.stop()


class ElasticCoordinator:
    """Supervisor-side view of the rendezvous directory. A record is alive
    while its status is ``up`` and its ``time`` is within ``deadline_ms``
    of this coordinator's clock (wall clocks: members are other
    processes); terminal statuses are never dead. ``generation`` scopes
    every view to that generation's records; ``gauge=False`` keeps this
    view out of :func:`health` and :func:`membership_gauge`."""

    def __init__(self, rdzv_dir, world_size=None, deadline_ms=None,
                 clock=time.time, generation=None, gauge=True):
        if deadline_ms is None:
            from .. import config as _config
            deadline_ms = _config.get("MXNET_ELASTIC_DEADLINE_MS")
        os.makedirs(rdzv_dir, exist_ok=True)
        self.rdzv_dir = os.path.abspath(rdzv_dir)
        self.world_size = None if world_size is None else int(world_size)
        self.deadline_ms = float(deadline_ms)
        self.generation = None if generation is None else int(generation)
        self._clock = clock
        self._declared_dead = set()
        if gauge:
            global _gauge_coordinator
            with _gauge_lock:
                _gauge_coordinator = weakref.ref(self)

    def members(self):
        """The raw records, ``{rank: record}``."""
        out = {}
        try:
            names = os.listdir(self.rdzv_dir)
        except OSError:
            return out
        for n in sorted(names):
            if not (n.startswith("member-") and n.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.rdzv_dir, n)) as f:
                    rec = json.load(f)
                if self.generation is not None \
                        and rec.get("gen") != self.generation:
                    continue
                out[int(rec["rank"])] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def snapshot(self):
        """``{rank: record + age_ms, alive}``."""
        now = self._clock()
        snap = {}
        for rank, rec in self.members().items():
            age_ms = (now - float(rec.get("time", 0.0))) * 1e3
            alive = rec.get("status") == "up" and age_ms <= self.deadline_ms
            snap[rank] = dict(rec, age_ms=age_ms, alive=alive)
        return snap

    def dead(self, snapshot=None):
        """Ranks whose last record says ``up`` past the deadline; each
        counts once per incident in ``dead_declared``."""
        snap = self.snapshot() if snapshot is None else snapshot
        out = _lost_ranks(snap)
        for rank in out:
            if rank not in self._declared_dead:
                self._declared_dead.add(rank)
                _count("dead_declared")
                _trace.instant("elastic.dead", rank=rank,
                               age_ms=snap[rank]["age_ms"])
        for rank in list(self._declared_dead):
            if rank not in out and snap.get(rank, {}).get("alive"):
                self._declared_dead.discard(rank)
        return out

    def world(self, snapshot=None):
        """The number of live members."""
        snap = self.snapshot() if snapshot is None else snapshot
        return sum(1 for r in snap.values() if r["alive"])

    def clear(self):
        """Remove every member record (a new generation starts clean)."""
        self._declared_dead.clear()
        for n in os.listdir(self.rdzv_dir):
            if n.startswith("member-"):
                try:
                    os.remove(os.path.join(self.rdzv_dir, n))
                except OSError:
                    pass


def _lost_ranks(snapshot):
    """Ranks lost silently: ``up`` records past the deadline. The
    supervisor's kill decision, the gauge and ``/healthz`` share it."""
    return sorted(r for r, v in snapshot.items()
                  if v.get("status") == "up" and not v["alive"])


_snap_cache = {}


def _gauge_snapshot(coord, ttl_s=0.5):
    """A snapshot for ``/healthz`` and ``/metrics``, cached ``ttl_s`` on
    the coordinator's own clock."""
    now = coord._clock()
    hit = _snap_cache.get(id(coord))
    if hit is not None and 0 <= now - hit[0] < ttl_s:
        return hit[1]
    snap = coord.snapshot()
    _snap_cache.clear()
    _snap_cache[id(coord)] = (now, snap)
    return snap


def current_rank():
    """This process's elastic rank: the live :class:`ElasticMember`'s, else
    the launcher's ``MXTPU_PROCESS_ID``, else None."""
    with _gauge_lock:
        m = _gauge_member() if _gauge_member is not None else None
    if m is not None:
        return m.rank
    try:
        return int(os.environ.get("MXTPU_PROCESS_ID", ""))
    except ValueError:
        return None


def membership_gauge():
    """The ``/metrics`` view: the coordinator's snapshot, the member's last
    beat, a pending preemption, the counters."""
    out = {"counters": elastic_stats(),
           "preemption_pending": preemption_pending()}
    with _gauge_lock:
        m = _gauge_member() if _gauge_member is not None else None
        c = _gauge_coordinator() if _gauge_coordinator is not None else None
    if m is not None:
        out["member"] = {"rank": m.rank, "status": m._status,
                         "step": m._step, "beats": m._beats,
                         "gen": m.generation}
    if c is not None:
        snap = _gauge_snapshot(c)
        out["membership"] = {
            "expected": c.world_size, "records": len(snap),
            "alive": sum(1 for r in snap.values() if r["alive"]),
            "dead": _lost_ranks(snap)}
    return out


def health():
    """Degraded while this process holds an unserved eviction notice, saw a
    collective wedge that no later collective cleared, or its coordinator
    sees members lost."""
    if preemption_pending():
        return {"status": "degraded", "reason": "preemption_pending"}
    alarm = collective_alarm()
    if alarm:
        return {"status": "degraded", "reason": "collective_timeout",
                "op": alarm["op"]}
    with _gauge_lock:
        c = _gauge_coordinator() if _gauge_coordinator is not None else None
    if c is not None:
        lost = _lost_ranks(_gauge_snapshot(c))
        if lost:
            return {"status": "degraded", "reason": "members_lost",
                    "dead": lost}
    return {"status": "ok"}


def dead_in_job():
    """The lost ranks of this process's supervised generation (the
    launcher's ``MXTPU_RDZV_DIR``), or ``[]`` outside one."""
    rdzv = os.environ.get("MXTPU_RDZV_DIR")
    if not rdzv or not os.path.isdir(rdzv):
        return []
    view = ElasticCoordinator(
        rdzv, generation=int(os.environ.get("MXTPU_GENERATION", "0")),
        gauge=False)
    return _lost_ranks(view.snapshot())


# ---------------------------------------------------------------------------
# emergency checkpoint and elastic fit
# ---------------------------------------------------------------------------

def emergency_checkpoint(trainer, ckpt_path, preemption=None):
    """Publish the trainer's state now (the same rolling slot
    ``resumable_fit`` keeps) and raise :class:`Preempted`. A save that
    ends after the grace window counts in ``grace_overruns`` (the atomic
    rename keeps a kill in mid-publish safe)."""
    from ..parallel.checkpoint import save_checkpoint

    with _trace.span("elastic.emergency_checkpoint", path=ckpt_path,
                     step=trainer._t):
        save_checkpoint(trainer, ckpt_path)
    _count("emergency_checkpoints")
    left = preemption.deadline_left_ms() if preemption is not None else None
    if left is not None and left <= 0:
        _count("grace_overruns")
    _trace.instant("elastic.emergency_checkpoint", step=trainer._t,
                   grace_left_ms=left)
    raise Preempted(step=trainer._t, ckpt=ckpt_path, grace_left_ms=left,
                    signum=getattr(preemption, "signum", None))


def elastic_fit(trainer, batches, ckpt_dir, member=None, preemption=None,
                ckpt_every=None, max_restores=8, seed=None, catch=None,
                on_restore=None):
    """Worker-side elastic training over ``resumable_fit``.

    ``batches`` is the whole run from absolute step 0, the same in every
    restart. An existing rolling checkpoint is restored onto the trainer's
    current device or mesh and only the remaining batches run. Membership
    beats ride ``resumable_fit``'s ``on_step``; an eviction notice becomes
    an emergency checkpoint, a ``preempted`` leave and :class:`Preempted`
    (exit with :data:`EXIT_PREEMPTED`). Returns ``(start_step, losses)``."""
    from ..parallel.checkpoint import restore_checkpoint
    from .resume import resumable_fit

    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(os.path.abspath(ckpt_dir), "resume_ckpt")
    if member is not None:
        # registered before the restore, so the whole start-up is beaten;
        # the background beater covers it until the first step's beat
        member.register(step=int(trainer._t))
        member.start()
    if os.path.exists(ckpt) or os.path.exists(ckpt + ".old"):
        restore_checkpoint(trainer, ckpt)
        _count("elastic_resumes")
        _trace.instant("elastic.resume", step=trainer._t)
    start = int(trainer._t)
    if start > len(batches):
        raise ValueError(
            "checkpoint step %d is beyond the %d-batch run: a restarted "
            "worker must make the same batch schedule" % (start,
                                                           len(batches)))
    if member is not None:
        member.register(step=start)
    on_step = None
    if member is not None:
        def on_step(step, loss):
            member.stop()
            try:
                member.heartbeat(step)
            except OSError:
                pass

    def _leave(status):
        if member is not None:
            try:
                member.leave(status, step=trainer._t)
            except OSError:
                pass

    kwargs = {}
    if catch is not None:
        kwargs["catch"] = catch
    try:
        losses = resumable_fit(trainer, batches[start:], ckpt_dir,
                               ckpt_every=ckpt_every,
                               max_restores=max_restores, seed=seed,
                               on_restore=on_restore, on_step=on_step,
                               preemption=preemption, **kwargs)
    except Preempted:
        _leave("preempted")
        raise
    except BaseException:
        _leave("failed")
        raise
    _leave("done")
    return start, losses


# ---------------------------------------------------------------------------
# collective watchdog
# ---------------------------------------------------------------------------

class CollectiveWatchdog:
    """A deadline on operations that wedge instead of failing.

    :meth:`run` runs the operation on a helper thread and bounds the
    caller's wait: past the deadline it counts, emits an
    ``elastic.collective_timeout`` instant, calls ``on_abort`` and raises
    :class:`CollectiveTimeout`. The abandoned helper stays parked in the
    hung call (a daemon): the process is about to exit and re-form."""

    def __init__(self, deadline_ms=None, name="collective", on_abort=None):
        if deadline_ms is None:
            from .. import config as _config
            deadline_ms = _config.get("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS")
        self.deadline_ms = float(deadline_ms)
        self.name = name
        self._on_abort = on_abort
        self.guarded = 0
        self.timeouts = 0

    def run(self, fn, *args, op=None, **kwargs):
        """``fn(*args, **kwargs)`` under the deadline; transparent when it
        ends in time or when the watchdog is off (``deadline_ms <= 0``)."""
        if self.deadline_ms <= 0:
            return fn(*args, **kwargs)
        op = op or self.name
        self.guarded += 1
        _count("guarded_collectives")
        box = {}
        done = threading.Event()

        def _worker():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - relayed below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=_worker, daemon=True,
                             name="collective-watchdog-%s" % op)
        t.start()
        if not done.wait(self.deadline_ms / 1e3):
            self.timeouts += 1
            _count("collective_timeouts")
            _set_collective_alarm(op, self.deadline_ms)
            _trace.instant("elastic.collective_timeout", op=op,
                           deadline_ms=self.deadline_ms)
            if self._on_abort is not None:
                self._on_abort(op, self.deadline_ms)
            raise CollectiveTimeout(
                "collective %r still not done after %.0f ms (peer lost?): "
                "aborting instead of wedging" % (op, self.deadline_ms))
        clear_collective_alarm()
        if "error" in box:
            raise box["error"]
        return box.get("result")


def _deadline():
    from .. import config as _config
    d = _config.get("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS")
    return d if d and d > 0 else 0


def guard_collective(fn, *args, op="collective", **kwargs):
    """``fn`` under ``MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS`` (0: called
    directly on the caller's thread)."""
    deadline = _deadline()
    if not deadline:
        return fn(*args, **kwargs)
    return CollectiveWatchdog(deadline_ms=deadline, name=op).run(
        fn, *args, op=op, **kwargs)


def _ready_probe(outputs):
    """What to wait on for ``outputs``: a ``torch.distributed`` work
    handle's ``wait``, else a CUDA event recorded now on the current
    stream of each CUDA device the outputs live on (None on the CPU,
    where the work is already done)."""
    import torch
    if hasattr(outputs, "wait") and hasattr(outputs, "is_completed"):
        return outputs.wait
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif hasattr(x, "shards"):
            visit(list(x.shards))
    visit(outputs)
    if not devices:
        return None
    events = []
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)

    def wait():
        for ev in events:
            ev.synchronize()
    return wait


def guard_wait(outputs, op="collective"):
    """Bound the wait for work whose collectives can wedge (ring attention,
    the MoE dispatch, the pipeline, a multi-axis planned step): fires the
    chaos point ``op`` (a ``stall`` drill models the hang), then waits for
    ``outputs`` (a CUDA event recorded after them, or a collective's work
    handle) under the deadline, raising :class:`CollectiveTimeout` past
    it. With ``MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS`` unset this neither
    waits nor starts a thread (the chaos point still fires)."""
    from . import chaos as _chaos

    deadline = _deadline()
    if not deadline:
        _chaos.point(op)
        return outputs
    probe = _ready_probe(outputs)

    def _wait():
        _chaos.point(op)
        if probe is not None:
            probe()
        return outputs

    return CollectiveWatchdog(deadline_ms=deadline, name=op).run(
        _wait, op=op)


def _rows():
    st = elastic_stats()
    return {("resilience.elastic.%s" % k): (v, 0.0) for k, v in st.items()}


from ._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_rows)
