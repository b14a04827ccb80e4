"""Retry policy engine: bounded attempts, exponential backoff with jitter.

A copy of ``mxnet_tpu/resilience/retry.py``. Transient faults (a flaky
device call, an injected :class:`~.chaos.TransientFault`) are absorbed
close to the failure, with bounded time cost and visible counters.

A :class:`RetryPolicy` is deliberately dependency-injectable — ``sleep``
and ``clock`` default to real time but tests pass fakes, so the backoff
*schedule* is asserted without ever sleeping. The seeded jitter RNG makes
the schedule reproducible: ``policy.schedule()`` returns exactly the delays
``call`` will use.

Applied in this package to the generation scheduler's decode step and
speculative round (``named_policy("retry.generation")``). Per-policy
counters reach ``_stats.aggregate_rows`` as
``retry.<name>.{calls,retries,giveups}``.
"""
from __future__ import annotations

import functools
import random as _random
import threading
import time

from ..observability import tracer as _trace
from .chaos import TransientFault

__all__ = ["RetryPolicy", "RetryExhausted", "retryable", "named_policy",
           "default_policy", "all_stats"]


class RetryExhausted(RuntimeError):
    """Every attempt failed (or the deadline ran out). ``__cause__`` is the
    last underlying error; ``attempts`` says how many were made."""

    def __init__(self, message, attempts):
        super().__init__(message)
        self.attempts = attempts


class RetryPolicy:
    """Retry ``retryable`` exceptions with exponential backoff + jitter.

    Parameters
    ----------
    max_attempts : int
        Total tries (first call included). 1 = no retry.
    base_delay_ms / max_delay_ms / multiplier : float
        Attempt k (1-based) sleeps ``min(base * multiplier**(k-1), max)``
        milliseconds before jitter.
    jitter : float in [0, 1]
        Each delay is scaled by a factor drawn uniformly from
        ``[1 - jitter, 1]`` (decorrelates retry storms); 0 = deterministic.
    deadline_ms : float, optional
        Wall-clock budget across all attempts, measured with ``clock``. A
        retry whose backoff would land past the deadline is not taken.
    retryable : tuple of exception types
        What to absorb; anything else propagates immediately.
    seed : int
        Seeds the jitter RNG — the schedule is reproducible per policy.
    sleep / clock : callables
        Injected time (tests pass fakes; no real sleeping needed).
    """

    def __init__(self, max_attempts=3, base_delay_ms=10.0,
                 max_delay_ms=1000.0, multiplier=2.0, jitter=0.1,
                 deadline_ms=None, retryable=(TransientFault,),
                 seed=0, name="retry", sleep=time.sleep,
                 clock=time.monotonic, register=True):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_ms = float(base_delay_ms)
        self.max_delay_ms = float(max_delay_ms)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline_ms = deadline_ms
        self.retryable = tuple(retryable)
        self.seed = int(seed)
        self.name = name
        self._sleep = sleep
        self._clock = clock
        self._rng = _random.Random(self.seed)
        self._lock = threading.Lock()
        self._c = {"calls": 0, "attempts": 0, "retries": 0,
                   "successes": 0, "giveups": 0}
        self._backoff_total_s = 0.0
        if register:
            _register(self)

    # ---- schedule ---------------------------------------------------------
    def backoff_ms(self, attempt, rng=None):
        """Delay after failed attempt ``attempt`` (1-based), jitter applied
        from ``rng`` (defaults to the policy's seeded stream)."""
        raw = min(self.base_delay_ms * self.multiplier ** (attempt - 1),
                  self.max_delay_ms)
        rng = rng if rng is not None else self._rng
        if self.jitter > 0:
            raw *= 1.0 - self.jitter * rng.random()
        return raw

    def schedule(self):
        """The deterministic delay sequence (ms) a fresh policy with this
        seed would sleep — one entry per possible retry."""
        rng = _random.Random(self.seed)
        return [self.backoff_ms(k, rng=rng)
                for k in range(1, self.max_attempts)]

    # ---- execution --------------------------------------------------------
    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy."""
        with self._lock:
            self._c["calls"] += 1
        t0 = self._clock()
        last = None
        for attempt in range(1, self.max_attempts + 1):
            with self._lock:
                self._c["attempts"] += 1
            try:
                out = fn(*args, **kwargs)
            except self.retryable as exc:
                last = exc
                if attempt >= self.max_attempts:
                    break
                with self._lock:
                    delay_ms = self.backoff_ms(attempt)
                if self.deadline_ms is not None:
                    elapsed_ms = (self._clock() - t0) * 1e3
                    if elapsed_ms + delay_ms > self.deadline_ms:
                        break
                with self._lock:
                    self._c["retries"] += 1
                    self._backoff_total_s += delay_ms / 1e3
                # attempts become timeline instants: a retried request's
                # extra latency is attributable on the trace, not just a
                # counter bump
                _trace.instant("retry.attempt", policy=self.name,
                               attempt=attempt,
                               delay_ms=round(delay_ms, 3),
                               error=type(exc).__name__)
                self._sleep(delay_ms / 1e3)
            else:
                with self._lock:
                    self._c["successes"] += 1
                return out
        with self._lock:
            self._c["giveups"] += 1
        _trace.instant("retry.giveup", policy=self.name, attempts=attempt,
                       error=type(last).__name__)
        raise RetryExhausted(
            "%s: gave up after %d attempt(s): %s: %s"
            % (self.name, attempt, type(last).__name__, last),
            attempts=attempt) from last

    def wrap(self, fn):
        """Decorator form: ``fn`` runs under this policy."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapper.retry_policy = self
        return wrapper

    __call__ = wrap

    # ---- stats ------------------------------------------------------------
    def stats(self):
        with self._lock:
            out = dict(self._c)
            out["backoff_total_ms"] = self._backoff_total_s * 1e3
        return out

    def reset_stats(self):
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._backoff_total_s = 0.0


def retryable(policy=None, **kwargs):
    """``@retryable()`` / ``@retryable(policy)`` / ``@retryable(max_attempts=5)``
    — decorate a function to run under a policy (a fresh one built from
    ``kwargs`` when not given)."""
    if callable(policy) and not isinstance(policy, RetryPolicy):
        # bare @retryable usage
        return default_policy().wrap(policy)
    pol = policy if isinstance(policy, RetryPolicy) \
        else RetryPolicy(**kwargs)
    return pol.wrap


# ---- registry + stats-row export -------------------------------------------

from ._stats import Registry as _Registry  # noqa: E402

_registry = _Registry()  # every register=True policy, by name
_register = _registry.add

_named = {}
_named_lock = threading.Lock()


def all_stats():
    """``{policy_name: stats_dict}`` for every registered policy."""
    return _registry.map(lambda p: p.stats())


def named_policy(name):
    """Per-subsystem singleton policy configured from the env knobs
    (``MXNET_RETRY_MAX_ATTEMPTS`` / ``_BASE_DELAY_MS`` / ``_MAX_DELAY_MS``
    / ``_DEADLINE_MS``; see the package's ``config``). One policy per name —
    separate names keep hot-path counter locks uncontended across
    subsystems and make the exported ``retry.<name>.*`` rows attributable.
    Built lazily so tests that tweak the env see their values."""
    with _named_lock:
        pol = _named.get(name)
        if pol is None:
            from .. import config as _config
            deadline = _config.get("MXNET_RETRY_DEADLINE_MS")
            pol = _named[name] = RetryPolicy(
                max_attempts=_config.get("MXNET_RETRY_MAX_ATTEMPTS"),
                base_delay_ms=_config.get("MXNET_RETRY_BASE_DELAY_MS"),
                max_delay_ms=_config.get("MXNET_RETRY_MAX_DELAY_MS"),
                deadline_ms=deadline if deadline else None,
                name=name)
        return pol


def default_policy():
    """The shared env-configured policy (used by bare ``@retryable``)."""
    return named_policy("retry.default")


def _reset_default_policy():
    """Test hook: drop the cached env-built policies."""
    with _named_lock:
        _named.clear()


def _profiler_rows():
    rows = {}
    for name, st in all_stats().items():
        rows["retry.%s.calls" % name] = (st["calls"], 0.0)
        rows["retry.%s.retries" % name] = (st["retries"],
                                           st["backoff_total_ms"] / 1e3)
        rows["retry.%s.giveups" % name] = (st["giveups"], 0.0)
    return rows


from ._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_profiler_rows)
