"""Circuit breaker: closed → open → half-open, for graceful degradation.

A copy of ``mxnet_tpu/resilience/breaker.py``. In-process, so the
``ModelServer`` itself sheds load the moment the model goes bad:
fast-failing ``/generate`` with 503 + ``Retry-After`` instead of queueing
doomed work, and reporting ``degraded`` on ``/healthz`` so balancers drain
the instance.

State machine (driven by the caller's ``record_success``/``record_failure``,
time injected via ``clock`` for fake-clock tests):

- **closed**: normal service. Opens when ``failure_threshold`` consecutive
  failures occur, or — when ``error_rate_threshold`` is set — when the
  error rate over the last ``window`` calls crosses it (with at least
  ``window`` calls observed).
- **open**: ``allow()`` is False; callers fast-fail (:class:`CircuitOpen`
  carries ``retry_after_s``). After ``recovery_ms`` the next ``allow()``
  admits probes and the breaker is **half-open**.
- **half-open**: up to ``half_open_probes`` concurrent probes pass. Any
  probe failure re-opens (fresh recovery timer); ``half_open_probes``
  successes close the circuit and reset counters.

Transition counters reach ``_stats.aggregate_rows`` as
``breaker.<name>.{opened,closed,half_open,fast_fails}``.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..observability import tracer as _trace

__all__ = ["CircuitBreaker", "CircuitOpen"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpen(RuntimeError):
    """Raised (by :meth:`CircuitBreaker.call`) or mapped to HTTP 503 when
    the circuit is open; ``retry_after_s`` feeds the Retry-After header."""

    def __init__(self, message, retry_after_s=1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class _Admission:
    """Truthy ticket returned by :meth:`CircuitBreaker.allow`. Carries
    whether this call was admitted as a half-open *probe* and under which
    state generation, so a slow call admitted while CLOSED cannot later be
    miscounted as a probe outcome (or free a probe slot it never held)."""

    __slots__ = ("probe", "gen")

    def __init__(self, probe, gen):
        self.probe = probe
        self.gen = gen

    def __bool__(self):
        return True


class CircuitBreaker:
    def __init__(self, failure_threshold=5, recovery_ms=1000.0,
                 half_open_probes=1, error_rate_threshold=None, window=32,
                 clock=time.monotonic, name="breaker", register=True):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_ms) / 1e3
        self.half_open_probes = int(half_open_probes)
        self.error_rate_threshold = error_rate_threshold
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._gen = 0  # bumped on every state transition
        self._consecutive_failures = 0
        self._window = deque(maxlen=int(window))  # 1 = failure, 0 = success
        self._opened_at = None
        self._probes_in_flight = 0
        self._probe_successes = 0
        self._c = {"opened": 0, "closed": 0, "half_open": 0,
                   "fast_fails": 0, "successes": 0, "failures": 0}
        if register:
            _register(self)

    # ---- state ------------------------------------------------------------
    @property
    def state(self):
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_event(self, state):
        # timeline instant per state change (tracer append is lock-free,
        # safe under self._lock) — an open/half-open/closed sequence lines
        # up against the request spans that drove it
        _trace.instant("breaker.state", breaker=self.name, state=state)

    def _maybe_half_open_locked(self):
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.recovery_s:
            self._state = HALF_OPEN
            self._gen += 1
            self._probes_in_flight = 0
            self._probe_successes = 0
            self._c["half_open"] += 1
            self._transition_event(HALF_OPEN)

    def _open_locked(self):
        self._state = OPEN
        self._gen += 1
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._window.clear()
        self._probes_in_flight = 0
        self._probe_successes = 0
        self._c["opened"] += 1
        self._transition_event(OPEN)

    def _close_locked(self):
        self._state = CLOSED
        self._gen += 1
        self._consecutive_failures = 0
        self._window.clear()
        self._probes_in_flight = 0
        self._probe_successes = 0
        self._c["closed"] += 1
        self._transition_event(CLOSED)

    def _is_probe_locked(self, admission):
        """Does ``admission`` denote the probe of the CURRENT half-open
        round? ``None`` (legacy callers without a ticket) is attributed to
        the current state, preserving the single-threaded protocol."""
        if admission is None:
            return True
        return admission.probe and admission.gen == self._gen

    # ---- caller protocol --------------------------------------------------
    def allow(self):
        """May this call proceed? Open→half-open transition happens here
        once the recovery timer elapses; in half-open, admits at most
        ``half_open_probes`` in-flight probes. Returns a truthy
        :class:`_Admission` ticket (pass it back to ``record_success`` /
        ``record_failure`` / ``release`` so concurrent slow calls admitted
        before a state change are not miscounted as probe outcomes), or
        False when the call must fast-fail."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return _Admission(False, self._gen)
            if self._state == HALF_OPEN:
                if self._probes_in_flight < self.half_open_probes:
                    self._probes_in_flight += 1
                    return _Admission(True, self._gen)
            self._c["fast_fails"] += 1
            return False

    def retry_after_s(self):
        """Seconds until the next probe would be admitted (0 when not
        open) — the value for an HTTP ``Retry-After`` header."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.recovery_s
                       - (self._clock() - self._opened_at))

    def record_success(self, admission=None):
        with self._lock:
            self._c["successes"] += 1
            if self._state == HALF_OPEN:
                if not self._is_probe_locked(admission):
                    return  # stale result from before the transition
                self._probe_successes += 1
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                if self._probe_successes >= self.half_open_probes:
                    self._close_locked()
                return
            if self._state == OPEN:
                return  # stale result; the recovery timer decides
            self._consecutive_failures = 0
            self._window.append(0)

    def release(self, admission=None):
        """The call admitted by :meth:`allow` ended with no model verdict
        (load-shed, cancelled, deadline in queue): free the half-open probe
        slot it may hold, so probes can't leak and wedge the breaker."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_in_flight > 0 \
                    and self._is_probe_locked(admission):
                self._probes_in_flight -= 1

    def record_failure(self, admission=None):
        with self._lock:
            self._c["failures"] += 1
            if self._state == HALF_OPEN:
                if not self._is_probe_locked(admission):
                    return  # stale failure: let the live probe decide
                self._open_locked()  # probe failed: back to open, new timer
                return
            if self._state == OPEN:
                return
            self._consecutive_failures += 1
            self._window.append(1)
            trip = self._consecutive_failures >= self.failure_threshold
            if not trip and self.error_rate_threshold is not None and \
                    len(self._window) >= self._window.maxlen:
                rate = sum(self._window) / float(len(self._window))
                trip = rate >= self.error_rate_threshold
            if trip:
                self._open_locked()

    def trip(self):
        """Force the circuit OPEN immediately, bypassing failure
        accounting — the fleet's canary rollback (and any admin
        kill-switch) must stop traffic NOW, not after ``threshold`` more
        doomed calls. Already-open circuits restart their recovery
        timer."""
        with self._lock:
            if self._state != OPEN:
                self._open_locked()
            else:
                self._opened_at = self._clock()

    def deregister(self):
        """Drop this breaker from the exported stats registry (no-op if a
        newer same-name instance superseded it). Retired fleet lanes call
        this so a closed version stops exporting ``breaker.*`` rows."""
        _registry.discard(self)

    def call(self, fn, *args, **kwargs):
        """Convenience wrapper: fast-fail with :class:`CircuitOpen` when the
        circuit is open, otherwise run ``fn`` and record the outcome."""
        admission = self.allow()
        if not admission:
            raise CircuitOpen(
                "%s: circuit open (%d consecutive failures threshold)"
                % (self.name, self.failure_threshold),
                retry_after_s=self.retry_after_s())
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure(admission)
            raise
        self.record_success(admission)
        return out

    # ---- observability ----------------------------------------------------
    def snapshot(self):
        with self._lock:
            self._maybe_half_open_locked()
            return {
                "name": self.name,
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "recovery_ms": self.recovery_s * 1e3,
                **dict(self._c),
            }


# ---- registry + stats-row export -------------------------------------------

from ._stats import Registry as _Registry  # noqa: E402

_registry = _Registry()  # every register=True breaker, by name
_register = _registry.add


def all_snapshots():
    """``{breaker_name: snapshot_dict}`` for every registered breaker."""
    return _registry.map(lambda b: b.snapshot())


def _profiler_rows():
    rows = {}
    for name, snap in all_snapshots().items():
        for key in ("opened", "closed", "half_open", "fast_fails"):
            rows["breaker.%s.%s" % (name, key)] = (snap[key], 0.0)
    return rows


from ._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_profiler_rows)
