"""Fault injection: named chaos points armed from tests or the environment.

A copy of ``mxnet_tpu/resilience/chaos.py``. Production code declares
*named points* (``chaos.point("generation.step")``) that are free when
disarmed, and tests arm them with deterministic triggers, so every retry
and breaker behaviour is exercisable without real hardware faults.

Injection points wired in this package:

========================  ==================================================
``generation.step``       GenerationScheduler decode step or speculative
                          round (per attempt; fails every live sequence
                          when it escapes the retry policy)
``trainer.step``          ShardedTrainer.step / step_many entry, once a
                          chunk in step_stream
``trainer.grads``         training-step input staging (``nan`` kind poisons
                          the batch so loss and gradients go non-finite)
``trainer.dispatch``      watchdog-guarded wait of a multi-axis planned
                          training step (``stall`` models a hung stage)
``pipeline.dispatch``     guarded dispatch of ``pipeline_spmd``
``moe.dispatch``          guarded dispatch of ``moe_ffn_sharded``
``ring.dispatch``         guarded dispatch of ``ring_attention_sharded``
``kvstore.push``          KVStore.push entry (per attempt)
``kvstore.pull``          KVStore.pull entry (per attempt)
``checkpoint.save``       between the staging directory's write and the
                          atomic publish
========================  ==================================================

Arming — programmatic::

    chaos.arm("serving.execute", "transient", first=2)   # first 2 calls
    chaos.arm("trainer.step", "fatal", at=5)             # exactly call #5
    chaos.arm("kvstore.push", "transient", every=3)      # calls 3, 6, 9...
    chaos.arm("serving.execute", "transient", p=0.05, seed=0)  # seeded coin
    chaos.arm("serving.execute", "slow", delay_ms=20, every=2)
    chaos.arm("trainer.grads", "nan", every=3)           # poison the batch
    chaos.clear()

or via the environment (picked up at import and by :func:`arm_from_env`)::

    MXNET_CHAOS_SPEC="serving.execute:transient:first=2;trainer.step:fatal:at=5"

Grammar: ``point:kind[:trigger]`` rules joined by ``;``. ``kind`` is
``transient`` | ``fatal`` | ``slow(<delay_ms>)`` | ``stall[(<cap_ms>)]``
| ``nan`` | ``host_loss`` | ``preempt``. ``trigger`` is one of
``first=K`` (default ``first=1``),
``every=N``, ``at=K``, or ``p=R,seed=S`` (deterministic seeded Bernoulli).
``transient``/``fatal`` raise :class:`TransientFault`/:class:`FatalFault`;
``slow`` injects latency (sleeps, then returns normally); ``stall``
BLOCKS at the point until :func:`release_stalls` (or the cap, default
30 s — a safety net so an unreleased drill cannot wedge a suite
forever): the deterministic "hung collective" that drives the
``CollectiveWatchdog`` tests without racing a fixed sleep against the
deadline; ``nan`` raises
nothing — the point *returns* ``"nan"`` (see :func:`poisoned`) and
data-path callers corrupt their in-flight values with non-finite numbers,
which is how numerical faults reach the compiled training step (a raise
could never model a bad batch that the hardware happily computes on).

Two process-level kinds model the fleet faults ``resilience.elastic``
exists for — neither raises, because the failure modes they model cannot
be caught:

- ``host_loss`` — the host vanishes NOW: ``os._exit(EXIT_HOST_LOSS)``,
  no cleanup, no atexit, no emergency checkpoint (a preempted VM that got
  no grace, a kernel panic, a yanked cable);
- ``preempt`` — the cloud provider's eviction notice: SIGTERM to the own
  process, which an installed
  installed :class:`~.elastic.PreemptionHandler` turns into an emergency
  checkpoint inside the grace window.

Fire/call counters per point are exported to ``_stats.aggregate_rows``
(rows ``chaos.<point>.calls`` / ``chaos.<point>.fires``).
"""
from __future__ import annotations

import os as _os
import random as _random
import re
import signal as _signal
import sys as _sys
import threading
import time

__all__ = ["Fault", "TransientFault", "FatalFault", "SlowFault",
           "point", "poisoned", "arm", "arm_from_env", "clear", "stats",
           "active", "release_stalls", "EXIT_HOST_LOSS"]

# what an abruptly lost host reports to its supervisor (128 + SIGKILL —
# the rc a kernel-killed worker would produce); resilience.elastic
# re-exports it for the supervise loop's eviction policy
EXIT_HOST_LOSS = 137


def _host_loss_action(msg):
    """Kill the process the way a lost host dies: immediately, with no
    cleanup and no chance to checkpoint. Module-level so tests can
    monkeypatch the action instead of dying."""
    _sys.stderr.write("chaos: %s\n" % msg)
    _sys.stderr.flush()
    _os._exit(EXIT_HOST_LOSS)


def _preempt_action(msg):
    """Deliver the eviction notice: SIGTERM to self. With a
    resilience.elastic.PreemptionHandler installed this starts the
    grace-window emergency-checkpoint path; without one the process dies
    with the default SIGTERM disposition — exactly the real contract."""
    _sys.stderr.write("chaos: %s\n" % msg)
    _sys.stderr.flush()
    _os.kill(_os.getpid(), _signal.SIGTERM)


class Fault(Exception):
    """Base class for injected faults."""


class TransientFault(Fault):
    """Injected failure that a retry is expected to absorb."""


class FatalFault(Fault):
    """Injected failure that models a crash: not retryable; recovery is
    restore-and-replay (``resilience.resume``) or breaker fast-fail."""


class SlowFault(Fault):
    """Injected latency. Carried in specs/arm() as the ``slow`` kind; the
    chaos point *sleeps* ``delay_ms`` instead of raising."""

    def __init__(self, delay_ms=10.0):
        super().__init__("injected slowness: %.1f ms" % delay_ms)
        self.delay_ms = float(delay_ms)


_KINDS = ("transient", "fatal", "slow", "stall", "nan", "host_loss",
          "preempt")

# stall release: parked points wait on a generation counter under one
# condition, so release_stalls() (and clear()) wakes every stalled
# thread at once while stalls armed AFTERWARDS block again
_stall_cond = threading.Condition()
_stall_gen = 0


def _stall_wait(cap_ms, gen=None):
    """Park until the stall generation moves past ``gen`` or everything
    is disarmed. ``gen`` is captured by :func:`point` BEFORE the fire
    decision: a release/clear landing between that decision and this
    wait must still unpark the thread, not strand it until the cap."""
    with _stall_cond:
        base = _stall_gen if gen is None else gen
        _stall_cond.wait_for(lambda: _stall_gen != base or not _armed,
                             timeout=cap_ms / 1e3)


def release_stalls():
    """Unpark every thread currently blocked in a ``stall``-kind point
    (the drill's release valve; :func:`clear` calls it too)."""
    global _stall_gen
    with _stall_cond:
        _stall_gen += 1
        _stall_cond.notify_all()


class _Rule:
    """One armed injection rule: a fault kind plus a deterministic trigger
    over this rule's own call counter."""

    __slots__ = ("point", "kind", "delay_ms", "first", "every", "at",
                 "p", "seed", "_rng", "calls", "fires", "message")

    def __init__(self, point, kind, delay_ms=None, first=None, every=None,
                 at=None, p=None, seed=0, message=None):
        if kind not in _KINDS:
            raise ValueError("unknown fault kind %r (want one of %s)"
                             % (kind, "/".join(_KINDS)))
        if delay_ms is None:
            # slow: a latency blip; stall: the safety cap on a wedge the
            # test forgot to release — generous, never the mechanism
            delay_ms = 30000.0 if kind == "stall" else 10.0
        n_triggers = sum(x is not None for x in (first, every, at, p))
        if n_triggers > 1:
            raise ValueError("pick ONE trigger: first=/every=/at=/p=")
        if n_triggers == 0:
            first = 1
        # reject triggers that silently never fire: an armed rule that
        # injects nothing is the false confidence this framework exists
        # to prevent
        for label, v in (("first", first), ("every", every), ("at", at)):
            if v is not None and int(v) < 1:
                raise ValueError("%s=%s never fires (want >= 1)"
                                 % (label, v))
        if p is not None and not 0.0 < float(p) <= 1.0:
            raise ValueError("p=%s never fires (want 0 < p <= 1)" % (p,))
        self.point = point
        self.kind = kind
        self.delay_ms = float(delay_ms)
        self.first = int(first) if first is not None else None
        self.every = int(every) if every is not None else None
        self.at = int(at) if at is not None else None
        self.p = float(p) if p is not None else None
        self.seed = int(seed)
        self._rng = _random.Random(self.seed) if self.p is not None else None
        self.calls = 0
        self.fires = 0
        self.message = message

    def should_fire(self):
        """Advance this rule's call counter and decide. Deterministic:
        counters are per-rule and the Bernoulli stream is seeded."""
        self.calls += 1
        if self.first is not None:
            return self.calls <= self.first
        if self.every is not None:
            return self.every > 0 and self.calls % self.every == 0
        if self.at is not None:
            return self.calls == self.at
        return self._rng.random() < self.p

    def fire(self, stall_gen=None):
        # self.fires was already counted under the module lock in point()
        msg = self.message or ("chaos[%s] injected %s (call #%d)"
                               % (self.point, self.kind, self.calls))
        if self.kind == "transient":
            raise TransientFault(msg)
        if self.kind == "fatal":
            raise FatalFault(msg)
        if self.kind == "slow":
            time.sleep(self.delay_ms / 1e3)  # slow: latency, not an error
        if self.kind == "stall":
            # blocks until released (or the cap); gen was captured at
            # the fire decision so a concurrent release cannot strand us
            _stall_wait(self.delay_ms, stall_gen)
        if self.kind == "host_loss":
            _host_loss_action(msg)
        if self.kind == "preempt":
            _preempt_action(msg)
        # "nan" raises nothing: point() reports it via its return value and
        # the caller poisons its own in-flight data


_lock = threading.Lock()
_rules = {}          # point name -> list[_Rule]
_armed = False       # fast-path flag: point() is a dict-miss when False
_totals = {}         # point name -> [calls, fires], survives clear()


def point(name):
    """Declare an injection point. No-op (one attribute read) unless a rule
    is armed for ``name``; otherwise may raise a :class:`Fault`, sleep, or
    return ``"nan"`` when a ``nan``-kind rule fired (data-path callers
    poison their in-flight values — see :func:`poisoned`)."""
    if not _armed:
        return None
    stall_gen = _stall_gen  # pre-decision snapshot (see _stall_wait)
    with _lock:
        rules = _rules.get(name)
        if not rules:
            return None
        to_fire = [r for r in rules if r.should_fire()]
        for r in to_fire:
            r.fires += 1  # counted here, under the lock
        tot = _totals.setdefault(name, [0, 0])
        tot[0] += 1
        tot[1] += len(to_fire)
    out = None
    for r in to_fire:
        if r.kind == "nan":
            out = "nan"
        else:
            r.fire(stall_gen)
    return out


def poisoned(name):
    """True when an armed ``nan`` rule fires at ``name`` this call. Raising
    kinds armed on the same point still raise (a transient beats a poison:
    the step never runs at all)."""
    return point(name) == "nan"


def arm(name, kind="transient", **kwargs):
    """Arm one rule at injection point ``name``. Trigger kwargs: exactly one
    of ``first=K`` / ``every=N`` / ``at=K`` / ``p=R[, seed=S]`` (default
    ``first=1``); ``slow`` takes ``delay_ms``. Returns the rule (its
    ``calls``/``fires`` counters are live)."""
    global _armed
    rule = _Rule(name, kind, **kwargs)
    with _lock:
        _rules.setdefault(name, []).append(rule)
        _armed = True
    return rule


_SPEC_RE = re.compile(
    r"^(?P<point>[\w.\-]+):(?P<kind>transient|fatal|nan|host_loss|preempt|"
    r"(?:slow|stall)(\((?P<delay>[0-9.]+)\))?)(:(?P<trig>[\w=.,\-]+))?$")


def arm_from_env(spec=None):
    """Parse ``MXNET_CHAOS_SPEC`` (or an explicit ``spec`` string) and arm
    every rule in it. Returns the list of armed rules."""
    if spec is None:
        from .. import config as _config
        spec = _config.get("MXNET_CHAOS_SPEC") or ""
    rules = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        m = _SPEC_RE.match(part)
        if m is None:
            raise ValueError(
                "bad MXNET_CHAOS_SPEC rule %r: want "
                "'point:kind[:trigger]' with kind transient|fatal|nan|"
                "host_loss|preempt|slow(<delay_ms>)|stall(<cap_ms>) and "
                "trigger first=K|every=N|at=K|p=R,seed=S" % part)
        kind = m.group("kind")
        kwargs = {}
        if kind.startswith(("slow", "stall")):
            if m.group("delay") is not None:
                kwargs["delay_ms"] = float(m.group("delay"))
            kind = "stall" if kind.startswith("stall") else "slow"
        trig = m.group("trig")
        if trig:
            for kv in trig.split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k not in ("first", "every", "at", "p", "seed"):
                    raise ValueError(
                        "bad MXNET_CHAOS_SPEC trigger %r in rule %r"
                        % (kv, part))
                kwargs[k] = float(v) if k == "p" else int(v)
        rules.append(arm(m.group("point"), kind, **kwargs))
    return rules


def clear():
    """Disarm everything (lifetime fire totals are kept for the
    aggregate rows) and unpark any thread a ``stall`` rule left blocked."""
    global _armed
    with _lock:
        _rules.clear()
        _armed = False
    release_stalls()


def active():
    """Currently armed rules as ``{point: [rule, ...]}`` (live objects)."""
    with _lock:
        return {k: list(v) for k, v in _rules.items()}


def stats(lifetime=False):
    """Per-point counters. Armed rules by default; ``lifetime=True`` returns
    the totals that survive :func:`clear` (what the aggregate rows export).
    With several rules armed on one point, armed-mode ``calls`` is the
    point's invocation count since the OLDEST rule armed (every invocation
    advances every rule, so that is ``max`` over rules — summing would
    multiply-count one invocation); ``fires`` sums, each rule fires
    separately."""
    with _lock:
        if lifetime:
            return {k: {"calls": v[0], "fires": v[1]}
                    for k, v in _totals.items()}
        out = {}
        for name, rules in _rules.items():
            out[name] = {"calls": max(r.calls for r in rules),
                         "fires": sum(r.fires for r in rules)}
        return out


def _profiler_rows():
    rows = {}
    for name, c in stats(lifetime=True).items():
        rows["chaos.%s.calls" % name] = (c["calls"], 0.0)
        rows["chaos.%s.fires" % name] = (c["fires"], 0.0)
    return rows


from ._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_profiler_rows)
# spawned workers inherit MXNET_CHAOS_SPEC: arm at import so chaos reaches
# code paths that never call arm() explicitly (a malformed spec raises —
# that is a user error, not something to swallow)
arm_from_env()
