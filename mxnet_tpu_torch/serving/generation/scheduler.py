"""Continuous batching: iteration-level scheduling over the slot arena.

Counterpart of ``mxnet_tpu/serving/generation/scheduler.py``. One worker
thread runs iterations; at each boundary it

1. expires queued requests whose deadline passed (``DeadlineExceeded``),
2. admits waiting requests into free KV-cache slots: a prefix-cache hit
   copies the cached prefix in, then the rest is prefilled in one call,
   or, when it is longer than the chunk, in chunks that later iterations
   advance one at a time (``_advance_prefills``); the first token streams
   at the end of the prefill (the TTFT moment) and the prompt's K/V is
   published to the prefix cache,
3. runs one decode step for every live slot, or, with a
   :class:`~.speculative.SpeculativeDecoder` and an all-greedy batch, one
   draft-then-verify round, and
4. retires finished sequences (EOS / token budget / ``max_seq``) at once,
   handing their slots to the queue.

The step runs under a :class:`~mxnet_tpu_torch.resilience.RetryPolicy`
with the ``generation.step`` chaos point inside the retried callable, so
transient faults are absorbed per attempt. A scheduler is a ``mixed``,
``prefill`` or ``decode`` lane (``MXNET_GEN_LANE``): a prefill lane
retires each request after its first token, once the prompt's K/V is on
its way to the prefix cache a decode lane admits from. The queue is
bounded (``ServerBusy``); ``close(drain=True)`` finishes the backlog and
``drain=False`` fails it; a worker fault fails every open request instead
of leaving it blocked.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque

import numpy as np

from ... import config as _config
from ...observability import tracer as _trace
from ...resilience import chaos as _chaos
from ...resilience import retry as _retry
from ...resilience._stats import Registry
from ..batcher import (DeadlineExceeded, ServerBusy, ServerClosed,
                       ServingError)
from ..metrics import GenerationMetrics

__all__ = ["GenerationScheduler", "GenerationRequest", "scheduler_stats"]

_registry = Registry(weak=True)
_LANES = ("mixed", "prefill", "decode")


def _lane(lane):
    lane = str(lane).lower()
    if lane not in _LANES:
        raise ServingError("lane_policy must be mixed|prefill|decode, "
                           "got %r" % lane)
    return lane


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
        self.ctx = _trace.current()
        self.tokens_out = []
        self.finish_reason = None
        self.slot = None
        self.admitted_t = None
        self.first_token_t = None
        self.done_t = None
        self.prefix_skipped = 0       # prompt tokens served from the cache
        self._pending = None          # last sampled, not yet cache-written
        self._prefill_pos = 0         # chunked-prefill progress (tokens)
        self._prefill_t0 = None
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
    ``retry_policy`` wraps every step (None = the env-configured
    ``retry.generation`` policy, False = none). ``speculative`` attaches a
    :class:`~.speculative.SpeculativeDecoder`, or ``draft_model`` builds
    one (owned, closed with the scheduler): iterations whose live batch is
    all greedy and has arena headroom then emit up to ``k + 1`` tokens per
    sequence, token-exact against the plain path. ``lane_policy`` is
    ``"mixed"`` (``MXNET_GEN_LANE``), ``"prefill"`` (requests retire after
    their first token with reason ``"prefill"``, their prompt K/V published
    to the prefix cache) or ``"decode"`` (admits are expected to hit the
    prefix cache; misses are counted as ``decode_lane_misses`` and
    prefilled here).
    """

    # deadline-less requests order as if due this far out, so they age
    # past fresh deadline-bearing arrivals instead of starving
    _NO_DEADLINE_HORIZON_S = 600.0

    def __init__(self, engine, max_queue_size=None, default_timeout_ms=None,
                 default_max_new_tokens=None, metrics=None,
                 retry_policy=None, speculative=None, draft_model=None,
                 lane_policy=None, name="generation"):
        self._lane = _lane(lane_policy if lane_policy is not None
                           else _config.get("MXNET_GEN_LANE"))
        self.engine = engine
        self.name = name
        if retry_policy is None:
            retry_policy = _retry.named_policy("retry.generation")
        self._retry = retry_policy or None
        self._owns_spec = False
        if speculative is None and draft_model is not None:
            from .speculative import SpeculativeDecoder
            speculative = SpeculativeDecoder(engine, draft_model)
            self._owns_spec = True
        self._spec = speculative or None
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
        self._live = {}               # slot -> GenerationRequest (decoding)
        self._prefilling = {}         # slot -> GenerationRequest (chunking)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closing = False
        self._drain = True
        self._c = {"submitted": 0, "completed": 0, "failed": 0,
                   "cancelled": 0, "prefix_hits": 0,
                   "prefix_tokens_saved": 0, "decode_lane_misses": 0,
                   "publish_failures": 0}
        _registry.add(self)
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
        Idempotent. An owned speculative decoder is closed too."""
        with self._lock:
            self._closing = True
            self._drain = drain
            self._not_empty.notify_all()
        self._worker.join(timeout)
        _registry.discard(self)
        if self._worker.is_alive():
            with self._lock:
                stranded = (list(self._queue) + list(self._live.values())
                            + list(self._prefilling.values()))
                self._queue.clear()
            for req in stranded:
                req._fail(ServerClosed(
                    "drain timed out with generation unfinished"))
            return False
        if self._spec is not None and self._owns_spec:
            self._spec.close()
            self._owns_spec = False
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- lane policy ------------------------------------------------------
    @property
    def lane_policy(self):
        return self._lane

    def set_lane_policy(self, lane):
        """Declare this scheduler a ``mixed``/``prefill``/``decode`` lane;
        returns self."""
        self._lane = _lane(lane)
        return self

    def program_bound(self):
        """The programs this scheduler's lane can hold: the engine's, and
        with speculative decoding the draft engine's and the verify."""
        n = self.engine.program_bound()
        if self._spec is not None:
            n += self._spec.draft.program_bound() + 1
        return n

    def stats(self):
        with self._lock:
            out = dict(self._c)
            out["queue_depth"] = len(self._queue)
            out["live_slots"] = len(self._live)
            out["prefilling_slots"] = len(self._prefilling)
            out["closing"] = self._closing
        out["lane"] = self._lane
        out["engine"] = self.engine.stats()
        out["compile"] = self.engine.compile_stats()
        if self.engine.prefix is not None:
            out["prefix"] = self.engine.prefix.stats()
        if self._spec is not None:
            out["speculative"] = self._spec.stats()
            out["spec_rounds"] = out["speculative"]["rounds"]
        else:
            out["spec_rounds"] = 0
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
                to_fail = (list(self._queue) + list(self._live.values())
                           + list(self._prefilling.values()))
                self._queue.clear()
                self._live.clear()
                self._prefilling.clear()
            else:
                to_fail = []
                admits = self._select_admits_locked(
                    self.engine.cache.free_slots)
            idle = not (admits or expired or cancelled or to_fail
                        or self._live or self._prefilling)
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
        self._advance_prefills()
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

    def _count(self, key, n=1):
        with self._lock:
            self._c[key] += n

    def _count_done(self, ok):
        self._count("completed" if ok else "failed")
        if not ok and self.metrics is not None:
            self.metrics.record_error()

    def _admit(self, req):
        """Claim a slot, copy in a cached prefix, and prefill the rest (or
        queue its chunks). A prefill failure fails only this request."""
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
        req.admitted_t = time.monotonic()
        try:
            with _trace.attach(req.ctx):
                req._prefill_t0 = time.monotonic()
                n = int(req.prompt.size)
                skipped = self.engine.prefix_admit(slot, req.prompt)
                if skipped:
                    req.prefix_skipped = skipped
                    self._count("prefix_hits")
                    self._count("prefix_tokens_saved", skipped)
                elif self._lane == "decode" and self.engine.prefix \
                        is not None and n > self.engine.prefix.block:
                    # a routing signal, not an error: the remainder is
                    # prefilled here
                    self._count("decode_lane_misses")
                chunk = self.engine.chunk
                if chunk and n - skipped > chunk:
                    # long prompt: its chunks interleave with the decode
                    # iterations (_advance_prefills)
                    req._prefill_pos = skipped
                    with self._lock:
                        self._prefilling[slot] = req
                    return
                if skipped or chunk:
                    _, tok = self.engine.prefill_chunks(
                        slot, req.prompt, skipped,
                        temperature=req.temperature)
                else:
                    tok = self.engine.prefill(slot, req.prompt,
                                              temperature=req.temperature)
        except Exception as exc:  # noqa: BLE001 — this request only
            self.engine.cache.release(slot)
            req.slot = None
            self._count_done(ok=False)
            req._fail(exc)
            return
        self._finish_prefill(req, tok)

    def _advance_prefills(self):
        """One chunk per prefilling slot per iteration, so a long prompt's
        prefill runs between decode steps instead of in front of every
        live stream's next token."""
        with self._lock:
            prefilling = dict(self._prefilling)
        for slot, req in prefilling.items():
            if req._cancelled or req.done:
                with self._lock:
                    self._prefilling.pop(slot, None)
                self._retire_cancelled(req, slot)
                continue
            try:
                with _trace.attach(req.ctx):
                    pos, tok = self.engine.prefill_chunks(
                        slot, req.prompt, req._prefill_pos,
                        temperature=req.temperature, max_chunks=1)
                req._prefill_pos = pos
                if self.metrics is not None:
                    self.metrics.record_prefill_chunk()
            except Exception as exc:  # noqa: BLE001 — this request only
                with self._lock:
                    self._prefilling.pop(slot, None)
                self.engine.cache.release(slot)
                req.slot = None
                self._count_done(ok=False)
                req._fail(exc)
                continue
            if tok is not None:
                with self._lock:
                    self._prefilling.pop(slot, None)
                self._finish_prefill(req, tok)

    def _finish_prefill(self, req, tok):
        """The prompt is in the arena: stream the first token, then queue
        the prompt's K/V for the prefix cache (the device copy is taken
        here, before the slot's next write), then join the decode batch or,
        on a prefill lane, retire."""
        if self.metrics is not None:
            self.metrics.record_prefill(time.monotonic() - req._prefill_t0)
        req._emit(tok)
        if self.metrics is not None:
            self.metrics.record_ttft(req.first_token_t - req.enqueue_t)
        try:
            self.engine.prefix_store_async(req.slot, req.prompt)
        except Exception:  # noqa: BLE001 — publishing is best effort
            self._count("publish_failures")
        if self._lane == "prefill":
            self.engine.cache.release(req.slot)
            req.slot = None
            if not req._finish("prefill"):
                return
            if self.metrics is not None:
                self.metrics.record_done(1, "prefill", 1e-9)
            self._count_done(ok=True)
            _trace.instant("generation.retire", request_id=req.request_id,
                           reason="prefill", tokens=1)
            return
        with self._lock:
            self._live[req.slot] = req
        self._retire_if_finished(req)

    def _retire_cancelled(self, req, slot):
        """Release and fail one consumer-cancelled (or externally failed)
        sequence; an already-failed one was counted where it failed."""
        self.engine.cache.release(slot)
        req.slot = None
        if req.done:
            return
        self._count("cancelled")
        if self.metrics is not None:
            self.metrics.record_error()
        _trace.instant("generation.retire", request_id=req.request_id,
                       reason="cancelled", tokens=len(req.tokens_out))
        req._fail(ServerClosed("cancelled by consumer"))

    def _sweep_abandoned(self, live):
        """Release cancelled (or externally failed) sequences before a
        step is spent on them."""
        for slot, req in list(live.items()):
            if not (req._cancelled or req.done):
                continue
            with self._lock:
                self._live.pop(slot, None)
            live.pop(slot)
            self._retire_cancelled(req, slot)

    def _fail_iteration(self, live, exc):
        """One step faulted past its retries: fail every live sequence
        (the plain and speculative paths share this)."""
        if self.metrics is not None:
            self.metrics.record_step_failure()
        with self._lock:
            for slot in live:
                self._live.pop(slot, None)
        for slot, req in live.items():
            self.engine.cache.release(slot)
            self._count_done(ok=False)
            req._fail(exc)

    def _run_step(self, fn):
        """``fn()`` behind the ``generation.step`` chaos point, under the
        retry policy (the point fires once per attempt)."""
        def attempt():
            _chaos.point("generation.step")
            return fn()

        if self._retry is not None:
            return self._retry.call(attempt)
        return attempt()

    def _step(self):
        """One decode step (or speculative round) for all live slots;
        emit + retire."""
        with self._lock:
            live = dict(self._live)
        self._sweep_abandoned(live)
        if not live:
            return
        if (self._spec is not None
                and all(r.temperature == 0.0 for r in live.values())
                and self._spec.can_step(list(live))):
            self._step_spec(live)
            return
        n_slots = self.engine.num_slots
        tokens = np.zeros(n_slots, dtype=np.int64)
        temps = np.zeros(n_slots, dtype=np.float32)
        for slot, req in live.items():
            tokens[slot] = req._pending
            temps[slot] = req.temperature
        t0 = time.monotonic()
        try:
            next_toks = self._run_step(
                lambda: self.engine.decode_step(tokens, temps))
        except Exception as exc:  # noqa: BLE001 — fail the whole iteration
            self._fail_iteration(live, exc)
            return
        self.engine.cache.advance(list(live.keys()))
        if self.metrics is not None:
            self.metrics.record_step(len(live), time.monotonic() - t0)
        for slot, req in live.items():
            req._emit(int(next_toks[slot]))
            self._retire_if_finished(req)

    def _step_spec(self, live):
        """One draft-then-verify round: up to ``k + 1`` tokens per live
        sequence, trimmed to budget and to the first EOS before the kept
        count is committed."""
        slots = list(live)
        pending = {s: live[s]._pending for s in slots}

        def history(slot):
            req = live[slot]
            return np.concatenate([
                req.prompt, np.asarray(req.tokens_out[:-1], dtype=np.int64)])

        t0 = time.monotonic()
        try:
            result = self._run_step(
                lambda: self._spec.round(slots, pending, history))
        except Exception as exc:  # noqa: BLE001 — fail the whole iteration
            self._fail_iteration(live, exc)
            return
        elapsed = time.monotonic() - t0
        emitted = 0
        for slot, req in live.items():
            toks = result[slot]
            n_allow = min(len(toks),
                          req.max_new_tokens - len(req.tokens_out))
            if req.eos_id is not None:
                for j in range(n_allow):
                    if toks[j] == req.eos_id:
                        n_allow = j + 1
                        break
            self._spec.commit(slot, n_allow)
            emitted += n_allow
            for tok in toks[:n_allow]:
                req._emit(tok)
            self._retire_if_finished(req)
        if self.metrics is not None:
            self.metrics.record_spec_round(
                len(live), self._spec.k * len(live), emitted, elapsed)

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
        _trace.instant("generation.retire", request_id=req.request_id,
                       reason=reason, tokens=len(req.tokens_out))

    def _abort(self, exc):
        """Unexpected worker failure: close intake and fail every reachable
        request."""
        with self._lock:
            self._closing = True
            stranded = (list(self._queue) + list(self._live.values())
                        + list(self._prefilling.values()))
            self._queue.clear()
            self._live.clear()
            self._prefilling.clear()
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


def scheduler_stats():
    """``{name: stats}`` over all live schedulers."""
    return _registry.map(lambda s: s.stats())
