"""Host-side span tracer: bounded ring buffer, thread-aware, Dapper-linked.

A copy of ``mxnet_tpu/observability/tracer.py``; its knobs are read from
the port's ``config``. Role parity: the reference profiler's
``ProfileTask``/``ProfileEvent`` objects recorded begin/end pairs into per-thread ``DeviceStats`` lanes
(`src/profiler/profiler.h`); here every completed span is one record in a
process-wide bounded deque (append is a single GIL-atomic op, and a full
buffer drops the *oldest* record — tracing a long run can never grow
memory without bound). Span/trace IDs follow the Dapper model (Sigelman
et al., 2010): a span opened with no parent starts a new trace; children
inherit the trace id and point at their parent span, across threads via
explicit :class:`SpanContext` handoff (:meth:`Tracer.attach`, or the
``parent=`` argument) — which is how one HTTP request's id survives the
hop from the handler thread into the batcher worker.

Cost model: when disabled (the default), ``span()`` is one attribute load
and a compare returning a shared no-op context manager — the serving and
training hot paths stay within noise. When enabled, a span costs two
clock reads, an id, and a deque append; there is no lock on the record path (the only lock guards
the per-phase aggregate histogram, taken once per completed span).

Knobs: ``MXNET_TRACE_ENABLE`` (record from import), ``MXNET_TRACE_BUFFER``
(ring capacity in events, default 65536).
"""
from __future__ import annotations

import bisect
import itertools
import os
import threading
import time
import warnings
from collections import deque

__all__ = ["Tracer", "SpanContext", "tracer", "span", "instant", "counter",
           "complete", "attach", "current", "enable", "disable", "enabled",
           "clear", "events", "event_count", "now", "phase_stats",
           "reset_phase_stats", "summary_gauge", "phase_exemplars",
           "dropped_spans", "set_sampler", "get_sampler"]

now = time.monotonic  # the one clock every trace timestamp uses

# per-phase histogram bucket upper bounds (milliseconds); the last bucket
# is open-ended
_BOUNDS_MS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_BUCKET_LABELS = tuple("<=%dms" % b for b in _BOUNDS_MS) + \
    (">%dms" % _BOUNDS_MS[-1],)

DEFAULT_BUFFER = 65536


class SpanContext:
    """Immutable (trace_id, span_id) pair — the propagation token. Pass it
    to another thread and open spans there with ``parent=ctx`` (or under
    ``tracer.attach(ctx)``) to keep the causal chain linked."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return "SpanContext(trace=%d, span=%d)" % (self.trace_id,
                                                   self.span_id)


class _NullSpan:
    """Shared no-op returned by ``span()`` while tracing is disabled —
    the disabled fast path allocates nothing."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def cancel(self):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span context manager. ``__enter__`` resolves the parent
    (explicit ``parent=`` > enclosing span on this thread > attached
    ambient context), allocates ids, and pushes itself on the thread's
    span stack; ``__exit__`` records one "X" event."""

    __slots__ = ("_tr", "name", "_attrs", "_parent", "_t0", "ctx",
                 "_pushed", "_cancelled")

    def __init__(self, tr, name, parent, attrs):
        self._tr = tr
        self.name = name
        self._attrs = attrs
        self._parent = parent
        self._t0 = None
        self.ctx = None
        self._pushed = False
        self._cancelled = False

    def set(self, **attrs):
        """Attach attributes after entry (e.g. a count known only later)."""
        self._attrs.update(attrs)
        return self

    def cancel(self):
        """Exit without recording (e.g. a chunk span opened before
        discovering the feed was already dry)."""
        self._cancelled = True
        return self

    def __enter__(self):
        tr = self._tr
        stack = tr._stack()
        parent = self._parent
        if parent is None:
            parent = stack[-1] if stack else getattr(tr._tls, "ambient",
                                                     None)
            self._parent = parent
        sid = next(tr._ids)
        self.ctx = SpanContext(parent.trace_id if parent is not None
                               else sid, sid)
        stack.append(self.ctx)
        self._pushed = True
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        tr = self._tr
        if self._pushed:
            stack = tr._stack()
            if stack and stack[-1] is self.ctx:
                stack.pop()
            else:  # exits raced out of order (shouldn't happen; be safe)
                try:
                    stack.remove(self.ctx)
                except ValueError:
                    pass
            self._pushed = False
        if self._cancelled or not tr._enabled:
            return False
        parent = self._parent
        th = threading.current_thread()
        dur = t1 - self._t0
        tr._append(("X", self.name, self._t0, dur,
                    threading.get_ident(), th.name, self.ctx.span_id,
                    parent.span_id if parent is not None else 0,
                    self.ctx.trace_id, self._attrs or None))
        kept = tr._observe(self.name, dur, self.ctx.trace_id,
                           parent is None, self._attrs)
        tr._phase_add(self.name, dur, trace_id=self.ctx.trace_id, kept=kept)
        return False


class _Attach:
    __slots__ = ("_tls", "_ctx", "_prev")

    def __init__(self, tls, ctx):
        self._tls = tls
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(self._tls, "ambient", None)
        self._tls.ambient = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        self._tls.ambient = self._prev
        return False


class Tracer:
    """Span recorder over a bounded drop-oldest ring buffer.

    Event records are tuples ``(ph, name, ts, dur, tid, tname, span_id,
    parent_id, trace_id, args)`` with ``ts``/``dur`` in seconds on the
    ``time.monotonic`` clock and ``ph`` one of ``"X"`` (duration span),
    ``"i"`` (instant), ``"C"`` (counter sample) — deliberately the Chrome
    Trace Event phases, so export is a straight mapping.
    """

    def __init__(self, capacity=DEFAULT_BUFFER):
        self._enabled = False
        self._buf = deque(maxlen=max(1, int(capacity)))
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._stat_lock = threading.Lock()
        self._phase = {}  # name -> [count, total_s, max_s, [bucket counts]]
        # name -> {bucket index: (trace_id, value_ms, kept)} — one exemplar
        # per histogram bucket, preferring traces the tail sampler KEPT so
        # the Prometheus exposition links a bad bucket to a readable trace
        self._exemplars = {}
        self._dropped = 0        # spans evicted by a full ring
        self._drop_warned = False
        self._sampler = None     # optional TailSampler (telemetry.py)
        self.pid = os.getpid()

    def _append(self, rec):
        """Ring append that accounts for overflow: a full buffer evicts
        the oldest record — silently losing history is fine (bounded
        memory is the contract) but UNREPORTED loss is not, so the first
        drop warns and every drop is counted (``dropped_spans``). The
        check-and-append runs under ``_stat_lock``: recorders are
        many-threaded (every HTTP handler records spans) and an unlocked
        read-modify-write would undercount exactly the loss this counter
        exists to report."""
        buf = self._buf
        warn = False
        with self._stat_lock:
            if len(buf) == buf.maxlen:
                self._dropped += 1
                if not self._drop_warned:
                    self._drop_warned = True
                    warn = True
            buf.append(rec)
        if warn:
            warnings.warn(
                "trace ring buffer full (capacity=%d): oldest spans are "
                "being dropped — raise MXNET_TRACE_BUFFER or dump more "
                "often; drops are counted in trace.dropped_spans "
                "(warning once)" % buf.maxlen,
                RuntimeWarning, stacklevel=3)

    def _observe(self, name, dur_s, trace_id, is_root, attrs):
        """Feed a completed span to the tail sampler (when attached);
        returns True when the span's trace is kept — the exemplar
        preference signal."""
        sampler = self._sampler
        if sampler is None:
            return False
        try:
            return bool(sampler.observe(name, dur_s, trace_id, is_root,
                                        attrs))
        except Exception:  # a broken sampler must never break tracing
            return False

    def set_sampler(self, sampler):
        """Attach a tail sampler (``observe(name, dur_s, trace_id,
        is_root, attrs) -> kept``); ``None`` detaches. The sampler sees
        every completed span while tracing is enabled."""
        self._sampler = sampler
        return self

    def get_sampler(self):
        return self._sampler

    def dropped_spans(self):
        """Spans evicted from the ring since the last :meth:`clear`."""
        return self._dropped

    # ---- lifecycle --------------------------------------------------------
    def enabled(self):
        return self._enabled

    @property
    def capacity(self):
        return self._buf.maxlen

    def set_capacity(self, capacity):
        """Rebound the ring (keeps the newest events that still fit)."""
        capacity = max(1, int(capacity))
        if capacity != self._buf.maxlen:
            self._buf = deque(self._buf, maxlen=capacity)

    def enable(self, capacity=None):
        """Start recording. The buffer is NOT cleared — pause/resume over
        one logical session is enable/disable around the same ring."""
        if capacity is not None:
            self.set_capacity(capacity)
        self._enabled = True
        return self

    def disable(self):
        """Stop recording; buffered events stay readable/exportable."""
        self._enabled = False
        return self

    def clear(self):
        with self._stat_lock:
            self._buf.clear()
            # fresh session restarts drop accounting (and may warn anew)
            self._dropped = 0
            self._drop_warned = False

    # ---- recording --------------------------------------------------------
    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self):
        """The innermost open span's :class:`SpanContext` on this thread
        (or the attached ambient context), else None."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1]
        return getattr(self._tls, "ambient", None)

    def attach(self, ctx):
        """Context manager: make ``ctx`` the ambient parent for spans
        opened on this thread (cross-thread propagation)."""
        return _Attach(self._tls, ctx)

    def span(self, name, parent=None, **attrs):
        """Open a duration span (use as a context manager). ``parent``
        overrides the thread-inherited parent — pass a
        :class:`SpanContext` carried from another thread."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, parent, attrs)

    def complete(self, name, t0, t1, parent=None, tid=None, tname=None,
                 **attrs):
        """Record an already-elapsed span from explicit ``time.monotonic``
        timestamps — for waits measured after the fact (queue wait observed
        by the worker that popped the request). Returns the new span's
        context, or None when disabled."""
        if not self._enabled:
            return None
        sid = next(self._ids)
        trace_id = parent.trace_id if parent is not None else sid
        if tid is None:
            th = threading.current_thread()
            tid, tname = threading.get_ident(), th.name
        dur = max(0.0, t1 - t0)
        self._append(("X", name, t0, dur, tid, tname or "", sid,
                      parent.span_id if parent is not None else 0,
                      trace_id, attrs or None))
        kept = self._observe(name, dur, trace_id, parent is None, attrs)
        self._phase_add(name, dur, trace_id=trace_id, kept=kept)
        return SpanContext(trace_id, sid)

    def instant(self, name, parent=None, **attrs):
        """Record a point-in-time event (guardrail skip, breaker flip,
        retry attempt)."""
        if not self._enabled:
            return
        parent = parent if parent is not None else self.current()
        sid = next(self._ids)
        th = threading.current_thread()
        self._append(("i", name, now(), 0.0, threading.get_ident(),
                      th.name, sid,
                      parent.span_id if parent is not None else 0,
                      parent.trace_id if parent is not None else sid,
                      attrs or None))

    def counter(self, name, **values):
        """Record a counter sample (numeric kwargs become the tracked
        series — Perfetto renders them as a stacked counter track)."""
        if not self._enabled:
            return
        th = threading.current_thread()
        self._append(("C", name, now(), 0.0, threading.get_ident(),
                      th.name, next(self._ids), 0, 0, values or None))

    # ---- reading ----------------------------------------------------------
    def events(self):
        """Snapshot of buffered event tuples, oldest first."""
        return list(self._buf)

    def event_count(self):
        return len(self._buf)

    # ---- per-phase aggregate (the /metrics histogram surface) -------------
    def _phase_add(self, name, dur_s, trace_id=None, kept=False):
        with self._stat_lock:
            ent = self._phase.get(name)
            if ent is None:
                ent = self._phase[name] = [0, 0.0, 0.0,
                                           [0] * (len(_BOUNDS_MS) + 1)]
            ent[0] += 1
            ent[1] += dur_s
            if dur_s > ent[2]:
                ent[2] = dur_s
            idx = bisect.bisect_left(_BOUNDS_MS, dur_s * 1e3)
            ent[3][idx] += 1
            if trace_id is not None:
                # one exemplar per bucket: a KEPT trace always wins (the
                # whole point is that the linked trace is retrievable); an
                # unkept one only fills an empty slot
                ex = self._exemplars.get(name)
                if ex is None:
                    ex = self._exemplars[name] = {}
                if kept or idx not in ex:
                    ex[idx] = (trace_id, dur_s * 1e3, kept)

    def phase_exemplars(self):
        """Per-phase histogram exemplars:
        ``{name: {bucket_label: {"trace_id", "value_ms", "kept"}}}`` —
        the trace-id handles the Prometheus exposition attaches to
        histogram buckets (OpenMetrics exemplar syntax)."""
        with self._stat_lock:
            items = {k: dict(v) for k, v in self._exemplars.items()}
        out = {}
        for name, ex in items.items():
            out[name] = {
                _BUCKET_LABELS[idx]: {"trace_id": "%x" % tid,
                                      "value_ms": val, "kept": kept}
                for idx, (tid, val, kept) in ex.items()}
        return out

    def phase_stats(self):
        """Per-span-name latency aggregates derived from the trace stream:
        ``{name: {count, total_ms, mean_ms, max_ms, buckets_ms}}`` —
        maintained incrementally as spans complete, so it reflects every
        span ever recorded (not just those still in the ring)."""
        with self._stat_lock:
            items = {k: (v[0], v[1], v[2], list(v[3]))
                     for k, v in self._phase.items()}
        out = {}
        for name, (count, total_s, max_s, buckets) in items.items():
            out[name] = {
                "count": count,
                "total_ms": total_s * 1e3,
                "mean_ms": (total_s / count * 1e3) if count else 0.0,
                "max_ms": max_s * 1e3,
                "buckets_ms": dict(zip(_BUCKET_LABELS, buckets)),
            }
        return out

    def reset_phase_stats(self):
        with self._stat_lock:
            self._phase.clear()
            self._exemplars.clear()


# ---------------------------------------------------------------------------
# module-level default tracer + delegating helpers (the API every
# instrumented subsystem imports)
# ---------------------------------------------------------------------------

tracer = Tracer()


def span(name, parent=None, **attrs):
    t = tracer
    if not t._enabled:
        return _NULL_SPAN
    return _Span(t, name, parent, attrs)


def instant(name, parent=None, **attrs):
    if tracer._enabled:
        tracer.instant(name, parent=parent, **attrs)


def counter(name, **values):
    if tracer._enabled:
        tracer.counter(name, **values)


def complete(name, t0, t1, parent=None, **attrs):
    return tracer.complete(name, t0, t1, parent=parent, **attrs)


def attach(ctx):
    return tracer.attach(ctx)


def current():
    return tracer.current()


def enabled():
    return tracer._enabled


def enable(capacity=None):
    return tracer.enable(capacity=capacity)


def disable():
    return tracer.disable()


def clear():
    tracer.clear()


def events():
    return tracer.events()


def event_count():
    return tracer.event_count()


def phase_stats():
    return tracer.phase_stats()


def reset_phase_stats():
    tracer.reset_phase_stats()


def phase_exemplars():
    return tracer.phase_exemplars()


def dropped_spans():
    return tracer.dropped_spans()


def set_sampler(sampler):
    return tracer.set_sampler(sampler)


def get_sampler():
    return tracer.get_sampler()


def summary_gauge():
    """One JSON-able gauge for the serving ``/metrics`` endpoint: tracer
    state + the trace-derived per-phase latency histograms."""
    out = {"enabled": tracer.enabled(),
           "buffered_events": tracer.event_count(),
           "buffer_capacity": tracer.capacity,
           "dropped_spans": tracer.dropped_spans(),
           "phases": tracer.phase_stats()}
    sampler = tracer.get_sampler()
    if sampler is not None:
        try:
            out["sampler"] = sampler.stats()
        except Exception:
            pass
    return out


def _configure_from_env():
    from .. import config as _config
    cap = _config.get("MXNET_TRACE_BUFFER")
    try:
        cap = int(cap)
    except (TypeError, ValueError):
        cap = DEFAULT_BUFFER
    if cap > 0:
        tracer.set_capacity(cap)
    if int(_config.get("MXNET_TRACE_ENABLE") or 0):
        tracer.enable()


_configure_from_env()
