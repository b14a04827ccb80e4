"""DynamicBatcher: adaptive micro-batching with backpressure, and the
typed serving failures.

Counterpart of ``mxnet_tpu/serving/batcher.py``. Concurrent
single-sample ``submit`` calls are coalesced by a background worker into
one model execution of up to ``max_batch_size`` rows, flushing early after
``max_latency_ms`` so that a lone request never waits for peers. Requests
are grouped by signature (their inputs' shapes and dtypes): the head run
of compatible requests forms the batch, and the rest wait for the next.

- **Bounded queue**: with ``max_queue_size`` requests waiting, ``submit``
  raises :class:`ServerBusy` (HTTP 503) instead of growing a backlog.
- **Deadlines**: a request that waits past its ``timeout_ms`` fails with
  :class:`DeadlineExceeded` (HTTP 504) before it costs device time.
- **Drain on shutdown**: ``close()`` stops intake and lets the worker
  finish what is queued; ``close(drain=False)`` fails it with
  :class:`ServerClosed`.
- **Retry under faults**: the ``serving.execute`` chaos point sits inside
  the retried call, so a transient fault re-runs the whole batch under a
  ``RetryPolicy`` before any waiter sees an error.
- **Model errors** fail every request of their batch; an unexpected
  exception in the worker fails what is queued and in flight with
  ``ServerClosed`` and closes intake, so no ``submit`` caller waits on a
  dead thread.

Results come back as the request's row of each output, as numpy arrays:
the batcher is the device-to-host boundary of ``/predict``.
``ModelServer`` maps the failures to HTTP codes (``ServerBusy`` and
``ServerClosed`` 503, ``DeadlineExceeded`` 504).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as _np

from ..observability import tracer as _trace
from ..resilience import chaos as _chaos
from ..resilience import retry as _retry

__all__ = ["DynamicBatcher", "ServingError", "ServerBusy",
           "DeadlineExceeded", "ServerClosed"]


class ServingError(RuntimeError):
    """Base class for typed serving failures."""


class ServerBusy(ServingError):
    """Bounded request queue is full: shed load (HTTP 503)."""


class DeadlineExceeded(ServingError):
    """Request expired in queue before execution (HTTP 504)."""


class ServerClosed(ServingError):
    """The server is shut down and no longer accepts work."""


class _Request:
    __slots__ = ("inputs", "future", "enqueue_t", "deadline", "sig",
                 "ctx", "request_id")

    def __init__(self, inputs, timeout_ms, request_id=None):
        self.inputs = inputs
        self.future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline = (self.enqueue_t + timeout_ms / 1e3
                         if timeout_ms else None)
        self.sig = tuple((a.shape, str(a.dtype)) for a in inputs)
        self.request_id = request_id
        self.ctx = _trace.current()


def _host(o):
    """An output as a numpy array (an NDArray through ``asnumpy``)."""
    return _np.asarray(o.asnumpy() if hasattr(o, "asnumpy") else o)


class DynamicBatcher:
    """Coalesce concurrent single-sample predictions into batched calls.

    ``fn(*batched_inputs)`` takes each input with a leading batch axis and
    returns an output (or a list/tuple) of the same rows; an
    ``InferenceEngine`` fits. ``max_latency_ms`` is how long the worker
    holds a batch open after its oldest request arrived. ``metrics`` (a
    ``ServingMetrics``) records latency, occupancy, rejections and
    expiries and reads the queue depth. ``retry_policy`` wraps each
    batch's execution (None: the env-configured ``retry.batcher`` policy;
    False: none)."""

    def __init__(self, fn, max_batch_size=32, max_latency_ms=5.0,
                 max_queue_size=128, default_timeout_ms=None, metrics=None,
                 retry_policy=None, name="dynamic_batcher"):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue_size < 1:
            raise ValueError("max_queue_size must be >= 1")
        self._fn = fn
        if retry_policy is None:
            retry_policy = _retry.named_policy("retry.batcher")
        self._retry = retry_policy or None
        self._max_batch = int(max_batch_size)
        self._max_latency_s = max_latency_ms / 1e3
        self._max_queue = int(max_queue_size)
        self._default_timeout_ms = default_timeout_ms
        self._metrics = metrics
        self._queue = deque()
        self._inflight = ()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closing = False
        if metrics is not None:
            metrics.set_queue_depth_fn(lambda: self.queue_depth)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name + "-worker")
        self._worker.start()

    # ---- client side ------------------------------------------------------
    @property
    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def submit(self, *inputs, timeout_ms=None, request_id=None):
        """Enqueue one sample (each input without the batch axis); returns
        a ``Future`` of its output row (numpy), or a tuple of rows for a
        model with several outputs. Raises :class:`ServerBusy` or
        :class:`ServerClosed` at once."""
        if timeout_ms is None:
            timeout_ms = self._default_timeout_ms
        req = _Request(tuple(_np.asarray(x) for x in inputs), timeout_ms,
                       request_id=request_id)
        with self._lock:
            if self._closing:
                raise ServerClosed("batcher is shut down")
            if len(self._queue) >= self._max_queue:
                if self._metrics is not None:
                    self._metrics.record_rejected()
                raise ServerBusy(
                    "request queue full (%d waiting)" % len(self._queue))
            self._queue.append(req)
            self._not_empty.notify()
        return req.future

    def predict(self, *inputs, timeout_ms=None, request_id=None):
        """Blocking single-sample prediction through the shared batch."""
        return self.submit(*inputs, timeout_ms=timeout_ms,
                           request_id=request_id).result()

    def close(self, drain=True, timeout=None):
        """Stop intake; with ``drain`` the worker finishes the backlog,
        otherwise queued requests fail with :class:`ServerClosed`. When
        ``timeout`` expires with work unfinished, that work fails with
        :class:`ServerClosed`. True when the worker exited. Idempotent."""
        with self._lock:
            self._closing = True
            if not drain:
                while self._queue:
                    self._resolve(self._queue.popleft().future,
                                  exc=ServerClosed(
                                      "batcher shut down before execution"))
            self._not_empty.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            with self._lock:
                stranded = list(self._queue) + list(self._inflight)
                self._queue.clear()
            for req in stranded:
                self._resolve(req.future, exc=ServerClosed(
                    "drain timed out after %.1fs with request unfinished"
                    % (timeout,)))
            return False
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker side ------------------------------------------------------
    def _take_batch(self):
        """Wait for work, hold the batch window open, then pop up to
        ``max_batch`` requests of the head's signature. Returns
        ``(requests, expired)``, or ``(None, expired)`` at shutdown."""
        expired = []
        with self._not_empty:
            while True:
                self._drop_expired_locked(expired)
                if expired and not self._queue:
                    return [], expired
                if self._queue:
                    break
                if self._closing:
                    return None, expired
                self._not_empty.wait(0.05)
            flush_at = self._queue[0].enqueue_t + self._max_latency_s
            while not self._closing and len(self._queue) < self._max_batch:
                rem = flush_at - time.monotonic()
                if rem <= 0:
                    break
                self._not_empty.wait(min(rem, 0.05))
                self._drop_expired_locked(expired)
                if not self._queue:
                    return [], expired
            sig = self._queue[0].sig
            batch, leftover = [], deque()
            while self._queue and len(batch) < self._max_batch:
                req = self._queue.popleft()
                (batch if req.sig == sig else leftover).append(req)
            leftover.extend(self._queue)
            self._queue.clear()
            self._queue.extend(leftover)
            # under the lock that popped them: close() always finds these
            # requests queued or in flight
            self._inflight = tuple(batch)
            return batch, expired

    def _drop_expired_locked(self, expired):
        now = time.monotonic()
        kept = deque()
        while self._queue:
            req = self._queue.popleft()
            if req.deadline is not None and now > req.deadline:
                expired.append(req)
            else:
                kept.append(req)
        self._queue.extend(kept)

    @staticmethod
    def _resolve(future, result=None, exc=None):
        """Set a future's outcome; one already settled (its waiter
        cancelled it, or a timed-out ``close`` failed it) is left as it
        is."""
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except InvalidStateError:
            pass

    def _run(self):
        # the only executor of every waiting submit(): nothing may end this
        # thread without resolving every reachable future
        try:
            while True:
                batch, expired = self._take_batch()
                for req in expired:
                    if self._metrics is not None:
                        self._metrics.record_expired()
                    self._resolve(req.future, exc=DeadlineExceeded(
                        "request expired after queueing %.1f ms"
                        % ((time.monotonic() - req.enqueue_t) * 1e3)))
                if batch is None:
                    return
                if not batch:
                    continue
                try:
                    self._execute(batch)
                finally:
                    with self._lock:
                        self._inflight = ()
        except BaseException as exc:  # noqa: BLE001 - closes, never strands
            self._abort(exc)
            if not isinstance(exc, Exception):
                raise

    def _abort(self, exc):
        """Unexpected worker failure: close intake and fail everything
        queued or in flight."""
        with self._lock:
            self._closing = True
            stranded = list(self._queue) + list(self._inflight)
            self._queue.clear()
            self._inflight = ()
        if self._metrics is not None:
            self._metrics.record_worker_error()
        err = ServerClosed("batcher worker died: %s: %s"
                           % (type(exc).__name__, exc))
        err.__cause__ = exc
        for req in stranded:
            if not req.future.done():
                self._resolve(req.future, exc=err)

    def _execute(self, batch):
        with _trace.span("serving.batch_execute", rows=len(batch),
                         parent=batch[0].ctx):
            self._execute_inner(batch)

    def _execute_inner(self, batch):
        n_inputs = len(batch[0].inputs)
        stacked = [_np.stack([r.inputs[i] for r in batch], axis=0)
                   for i in range(n_inputs)]

        def run_model():
            # inside the retried call: each attempt meets the chaos point
            _chaos.point("serving.execute")
            out = self._fn(*stacked)
            multi = isinstance(out, (list, tuple))
            return [_host(o) for o in (out if multi else [out])], multi

        try:
            outs, multi = (self._retry.call(run_model)
                           if self._retry is not None else run_model())
            for o in outs:
                if o.shape[0] != len(batch):
                    raise ValueError(
                        "model output axis 0 (%d) != batch rows (%d); "
                        "outputs must carry the batch on axis 0"
                        % (o.shape[0], len(batch)))
        except Exception as exc:  # noqa: BLE001 - fails its whole batch
            done_t = time.monotonic()
            for req in batch:
                if self._metrics is not None:
                    self._metrics.record_request(done_t - req.enqueue_t,
                                                 ok=False)
                self._resolve(req.future, exc=exc)
            return
        if self._metrics is not None:
            self._metrics.record_batch(len(batch), self._max_batch)
        done_t = time.monotonic()
        for i, req in enumerate(batch):
            if self._metrics is not None:
                self._metrics.record_request(done_t - req.enqueue_t, ok=True)
            self._resolve(req.future, result=tuple(o[i] for o in outs)
                          if multi else outs[0][i])
