"""Continuous batching: iteration-level scheduling over the slot arena.

Counterpart of ``mxnet_tpu/serving/generation/scheduler.py`` (the
``"mixed"`` lane). One worker thread runs iterations; at each boundary it

1. expires queued requests whose deadline passed (``DeadlineExceeded``),
2. admits waiting requests into free KV-cache slots (one prefill each,
   streaming the request's first token: the TTFT moment),
3. runs one decode step for every live slot, and
4. retires finished sequences (EOS / token budget / ``max_seq``) at once,
   handing their slots to the queue.

Tokens stream to consumers through each :class:`GenerationRequest`. The
queue is bounded (``ServerBusy``); ``close(drain=True)`` finishes the
backlog and ``drain=False`` fails it; a worker fault fails every open
request instead of leaving it blocked. Retry, fault injection, lane
policies and speculative decoding are not ported yet.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque

import numpy as np

from ... import config as _config
from ..batcher import (DeadlineExceeded, ServerBusy, ServerClosed,
                       ServingError)
from ..metrics import GenerationMetrics

__all__ = ["GenerationScheduler", "GenerationRequest"]


class GenerationRequest:
    """One streaming generation: consumers iterate :meth:`tokens` (or call
    :meth:`result`) while the scheduler produces into it."""

    def __init__(self, prompt, max_new_tokens, temperature, eos_id,
                 timeout_ms, request_id=None):
        self.prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.request_id = request_id
        self.enqueue_t = time.monotonic()
        self.deadline = (self.enqueue_t + timeout_ms / 1e3
                         if timeout_ms else None)
        self.tokens_out = []
        self.finish_reason = None
        self.slot = None
        self.first_token_t = None
        self.done_t = None
        self._pending = None          # last sampled, not yet cache-written
        self._q = _queue.Queue()
        self._done = threading.Event()
        self._error = None
        self._cancelled = False

    # ---- consumer side ----------------------------------------------------
    def tokens(self, timeout=None):
        """Yield token ids as they are produced; return on completion,
        raise the failure otherwise. ``timeout`` bounds each wait."""
        while True:
            kind, val = self._q.get(timeout=timeout)
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise val

    def next_event(self, timeout=None):
        """The next stream event: ``("token", id)``, ``("done", reason)``
        or ``("error", exc)``."""
        return self._q.get(timeout=timeout)

    def result(self, timeout=None):
        """Block until done; the full token list (raises on failure)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still running")
        if self._error is not None:
            raise self._error
        return list(self.tokens_out)

    @property
    def done(self):
        return self._done.is_set()

    def cancel(self):
        """Consumer gone: retire this sequence at the next iteration
        boundary. Idempotent; safe from any thread."""
        self._cancelled = True

    # ---- scheduler side ---------------------------------------------------
    def _emit(self, tok):
        if self._done.is_set():
            return
        self.tokens_out.append(int(tok))
        if self.first_token_t is None:
            self.first_token_t = time.monotonic()
        self._pending = int(tok)
        self._q.put(("token", int(tok)))

    def _finish(self, reason):
        """Clean completion; False when the request already finished."""
        if self._done.is_set():
            return False
        self.finish_reason = reason
        self.done_t = time.monotonic()
        self._q.put(("done", reason))
        self._done.set()
        return True

    def _fail(self, exc):
        if self._done.is_set():
            return
        self.finish_reason = "error"
        self.done_t = time.monotonic()
        self._error = exc
        self._q.put(("error", exc))
        self._done.set()


class GenerationScheduler:
    """Admit / step / retire loop over a ``DecodeEngine``.

    ``max_queue_size`` bounds waiting requests (``MXNET_GEN_QUEUE_SIZE``);
    ``default_timeout_ms`` is the queue-wait deadline of requests that do
    not pass one (None = wait forever); ``default_max_new_tokens`` the
    token budget (``MXNET_GEN_MAX_NEW_TOKENS``); ``metrics`` a
    :class:`GenerationMetrics` (None builds one, False disables).
    """

    # deadline-less requests order as if due this far out, so they age
    # past fresh deadline-bearing arrivals instead of starving
    _NO_DEADLINE_HORIZON_S = 600.0

    def __init__(self, engine, max_queue_size=None, default_timeout_ms=None,
                 default_max_new_tokens=None, metrics=None, speculative=None,
                 draft_model=None, lane_policy=None, name="generation"):
        if speculative is not None or draft_model is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet")
        if lane_policy not in (None, "mixed"):
            raise NotImplementedError(
                "lane policy %r is not ported yet (only 'mixed')"
                % (lane_policy,))
        self.engine = engine
        self.name = name
        self._max_queue = int(max_queue_size or
                              _config.get("MXNET_GEN_QUEUE_SIZE"))
        self._default_timeout_ms = default_timeout_ms
        self._default_max_new = int(default_max_new_tokens or
                                    _config.get("MXNET_GEN_MAX_NEW_TOKENS"))
        if metrics is None:
            metrics = GenerationMetrics(name=name)
        self.metrics = metrics or None
        if self.metrics is not None:
            self.metrics.set_engine(engine)
            self.metrics.set_queue_depth_fn(lambda: self.queue_depth)
        self._queue = deque()
        self._live = {}               # slot -> GenerationRequest
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closing = False
        self._drain = True
        self._c = {"submitted": 0, "completed": 0, "failed": 0,
                   "cancelled": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name + "-scheduler")
        self._worker.start()

    # ---- client side ------------------------------------------------------
    @property
    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               eos_id=None, timeout_ms=None, request_id=None):
        """Enqueue one generation; returns a :class:`GenerationRequest` at
        once. Raises :class:`ServerBusy` (queue full),
        :class:`ServerClosed`, or :class:`ServingError` /
        ``PromptTooLong`` (bad prompt)."""
        prompt = np.asarray(prompt, dtype=np.int64)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ServingError("prompt must be a non-empty 1-D token list")
        self.engine.validate_prompt(int(prompt.size))
        if max_new_tokens is None:
            max_new_tokens = self._default_max_new
        if int(max_new_tokens) < 1:
            raise ServingError("max_new_tokens must be >= 1")
        if timeout_ms is None:
            timeout_ms = self._default_timeout_ms
        req = GenerationRequest(prompt, max_new_tokens, temperature, eos_id,
                                timeout_ms, request_id=request_id)
        with self._lock:
            if self._closing:
                raise ServerClosed("generation scheduler is shut down")
            if len(self._queue) >= self._max_queue:
                if self.metrics is not None:
                    self.metrics.record_rejected()
                raise ServerBusy("generation queue full (%d waiting)"
                                 % len(self._queue))
            self._queue.append(req)
            self._c["submitted"] += 1
            self._not_empty.notify()
        return req

    def generate(self, prompt, **kwargs):
        """Blocking convenience: submit + ``result()``."""
        return self.submit(prompt, **kwargs).result()

    def close(self, drain=True, timeout=None):
        """Stop intake. ``drain=True`` finishes the backlog (bounded by
        each request's budget); ``drain=False`` fails queued and live
        requests with :class:`ServerClosed`. ``timeout`` bounds the drain;
        stragglers are failed. Returns False when it timed out.
        Idempotent."""
        with self._lock:
            self._closing = True
            self._drain = drain
            self._not_empty.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            with self._lock:
                stranded = list(self._queue) + list(self._live.values())
                self._queue.clear()
            for req in stranded:
                req._fail(ServerClosed(
                    "drain timed out with generation unfinished"))
            return False
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self):
        with self._lock:
            out = dict(self._c)
            out["queue_depth"] = len(self._queue)
            out["live_slots"] = len(self._live)
            out["closing"] = self._closing
        out["engine"] = self.engine.stats()
        return out

    # ---- worker side ------------------------------------------------------
    def _run(self):
        # the only producer of every open request stream: it must not die
        # silently
        try:
            while self._iterate():
                pass
        except BaseException as exc:
            self._abort(exc)

    def _iterate(self):
        """One scheduling iteration; False when the worker should exit."""
        admits, expired, cancelled = [], [], []
        with self._not_empty:
            self._drop_expired_locked(expired, cancelled)
            if self._closing and not self._drain:
                to_fail = list(self._queue) + list(self._live.values())
                self._queue.clear()
                self._live.clear()
            else:
                to_fail = []
                admits = self._select_admits_locked(
                    self.engine.cache.free_slots)
            idle = not (admits or expired or cancelled or to_fail
                        or self._live)
            if idle:
                if self._closing:
                    return False
                self._not_empty.wait(0.05)
                return True
        for req in expired:
            if self.metrics is not None:
                self.metrics.record_expired()
            req._fail(DeadlineExceeded(
                "generation request expired after queueing %.1f ms"
                % ((time.monotonic() - req.enqueue_t) * 1e3)))
        for req in cancelled:
            self._count("cancelled")
            if self.metrics is not None:
                self.metrics.record_error()
            req._fail(ServerClosed("cancelled by consumer while queued"))
        for req in to_fail:
            if req.slot is not None:
                self.engine.cache.release(req.slot)
            self._count_done(ok=False)
            req._fail(ServerClosed("scheduler shut down before completion"))
        for req in admits:
            self._admit(req)
        with self._lock:
            has_live = bool(self._live)
        if has_live:
            self._step()
        return True

    def _select_admits_locked(self, free):
        """Up to ``free`` queued requests by earliest effective deadline
        (the real one, or enqueue time + the horizon)."""
        if not self._queue or free <= 0:
            return []

        def eff(req):
            if req.deadline is not None:
                return req.deadline
            return req.enqueue_t + self._NO_DEADLINE_HORIZON_S

        order = sorted(range(len(self._queue)),
                       key=lambda i: (eff(self._queue[i]),
                                      self._queue[i].enqueue_t, i))
        take = set(order[:free])
        admits = [self._queue[i] for i in order[:free]]
        self._queue = deque(req for i, req in enumerate(self._queue)
                            if i not in take)
        return admits

    def _drop_expired_locked(self, expired, cancelled):
        now = time.monotonic()
        kept = deque()
        while self._queue:
            req = self._queue.popleft()
            if req._cancelled:
                cancelled.append(req)
            elif req.deadline is not None and now > req.deadline:
                expired.append(req)
            else:
                kept.append(req)
        self._queue.extend(kept)

    def _count(self, key):
        with self._lock:
            self._c[key] += 1

    def _count_done(self, ok):
        self._count("completed" if ok else "failed")
        if not ok and self.metrics is not None:
            self.metrics.record_error()

    def _admit(self, req):
        """Prefill one request into a free slot and stream its first token.
        A prefill failure fails only this request."""
        if req._cancelled:
            self._count("cancelled")
            if self.metrics is not None:
                self.metrics.record_error()
            req._fail(ServerClosed("cancelled by consumer while queued"))
            return
        try:
            slot = self.engine.cache.acquire()
        except ServingError:       # free_slots went stale: retry later
            with self._lock:
                self._queue.appendleft(req)
            return
        req.slot = slot
        t0 = time.monotonic()
        try:
            tok = self.engine.prefill(slot, req.prompt,
                                      temperature=req.temperature)
        except Exception as exc:  # noqa: BLE001 — this request only
            self.engine.cache.release(slot)
            req.slot = None
            self._count_done(ok=False)
            req._fail(exc)
            return
        if self.metrics is not None:
            self.metrics.record_prefill(time.monotonic() - t0)
        req._emit(tok)
        if self.metrics is not None:
            self.metrics.record_ttft(req.first_token_t - req.enqueue_t)
        with self._lock:
            self._live[slot] = req
        self._retire_if_finished(req)

    def _retire_abandoned(self, live):
        """Release cancelled (or externally failed) sequences before a
        decode step is spent on them."""
        for slot, req in list(live.items()):
            if not (req._cancelled or req.done):
                continue
            with self._lock:
                self._live.pop(slot, None)
            live.pop(slot)
            self.engine.cache.release(slot)
            req.slot = None
            if req.done:
                continue
            self._count("cancelled")
            if self.metrics is not None:
                self.metrics.record_error()
            req._fail(ServerClosed("cancelled by consumer"))

    def _step(self):
        """One decode step for all live slots; emit + retire."""
        with self._lock:
            live = dict(self._live)
        self._retire_abandoned(live)
        if not live:
            return
        n_slots = self.engine.num_slots
        tokens = np.zeros(n_slots, dtype=np.int64)
        temps = np.zeros(n_slots, dtype=np.float32)
        for slot, req in live.items():
            tokens[slot] = req._pending
            temps[slot] = req.temperature
        t0 = time.monotonic()
        try:
            next_toks = self.engine.decode_step(tokens, temps)
        except Exception as exc:  # noqa: BLE001 — fail the whole iteration
            if self.metrics is not None:
                self.metrics.record_step_failure()
            with self._lock:
                for slot in live:
                    self._live.pop(slot, None)
            for slot, req in live.items():
                self.engine.cache.release(slot)
                self._count_done(ok=False)
                req._fail(exc)
            return
        self.engine.cache.advance(list(live.keys()))
        if self.metrics is not None:
            self.metrics.record_step(len(live), time.monotonic() - t0)
        for slot, req in live.items():
            req._emit(int(next_toks[slot]))
            self._retire_if_finished(req)

    def _retire_if_finished(self, req):
        """EOS / token budget / arena edge: finish and free the slot now."""
        reason = None
        if req.eos_id is not None and req._pending == req.eos_id:
            reason = "eos"
        elif len(req.tokens_out) >= req.max_new_tokens:
            reason = "length"
        elif int(self.engine.cache.lengths[req.slot]) >= self.engine.max_seq:
            reason = "max_seq"
        if reason is None:
            return
        with self._lock:
            self._live.pop(req.slot, None)
        self.engine.cache.release(req.slot)
        if not req._finish(reason):
            return
        if self.metrics is not None:
            self.metrics.record_done(len(req.tokens_out), reason,
                                     max(req.done_t - req.first_token_t,
                                         1e-9))
        self._count_done(ok=True)

    def _abort(self, exc):
        """Unexpected worker failure: close intake and fail every reachable
        request."""
        with self._lock:
            self._closing = True
            stranded = list(self._queue) + list(self._live.values())
            self._queue.clear()
            self._live.clear()
        err = ServerClosed("generation scheduler worker died: %s: %s"
                           % (type(exc).__name__, exc))
        err.__cause__ = exc
        for req in stranded:
            if req.slot is not None:
                try:
                    self.engine.cache.release(req.slot)
                except ValueError:
                    pass
            self._count_done(ok=False)
            req._fail(err)
