"""Serving metrics: counterpart of ``mxnet_tpu/serving/metrics.py``.

:class:`ServingMetrics` counts the ``/predict`` lane: requests, errors,
rejections, expiries, batches and their occupancy, latency percentiles
and QPS over a sliding window, the batcher's queue depth, and the
``executor_cache`` gauge (the engine's ``stats()``: the ``CachedOp``'s
hits, misses, evictions and captured graphs). :meth:`snapshot` is
``ModelServer``'s ``/metrics``.

:class:`GenerationMetrics` counts a generation lane: time to first
token (submit -> first streamed token: queue wait + prefill), prefill
time, decode step time and emitted tokens, chunked-prefill calls,
speculative rounds with their drafted and accepted tokens, and the
admit/step/retire ledger; its :meth:`snapshot` is the ``/metrics``
``"generation"`` section of ``ModelServer``. Percentiles are nearest-rank
over a sliding window of recent requests.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

__all__ = ["ServingMetrics", "GenerationMetrics"]


def _percentiles(values, qs=(50, 95, 99), scale=1e3):
    """Nearest-rank percentiles (seconds -> ms by default); zeros when
    empty."""
    vals = sorted(values)
    if not vals:
        return {("p%d" % q): 0.0 for q in qs}
    out = {}
    for q in qs:
        idx = min(len(vals) - 1, max(0, math.ceil(q / 100.0 * len(vals)) - 1))
        out["p%d" % q] = vals[idx] * scale
    return out


class ServingMetrics:
    """Thread-safe ``/predict`` counters shared by the engine, the batcher
    and the server. ``window`` bounds the ring of recent requests behind
    the latency percentiles and QPS. Gauges owned by other components
    (queue depth, executor cache, breaker, retry) are pulled through
    callbacks at snapshot time."""

    def __init__(self, window=2048, name="serving"):
        self.name = name
        self._lock = threading.Lock()
        self._window = deque(maxlen=window)     # (done_t, latency_s)
        self._c = {"requests": 0, "ok": 0, "errors": 0, "rejected": 0,
                   "expired": 0, "batches": 0, "batched_rows": 0,
                   "worker_errors": 0}
        self._latency_total = 0.0
        self._occupancy_total = 0.0
        self._t0 = time.time()
        self._queue_depth_fn = None
        self._cache_stats_fn = None
        self._gauge_fns = {}

    # ---- recording (hot path) ---------------------------------------------
    def record_request(self, latency_s, ok=True):
        with self._lock:
            self._c["requests"] += 1
            self._c["ok" if ok else "errors"] += 1
            self._latency_total += latency_s
            self._window.append((time.time(), latency_s))

    def record_rejected(self):
        with self._lock:
            self._c["rejected"] += 1

    def record_expired(self):
        with self._lock:
            self._c["expired"] += 1

    def record_worker_error(self):
        with self._lock:
            self._c["worker_errors"] += 1

    def record_batch(self, rows, capacity):
        """One coalesced execution of ``rows`` requests out of
        ``capacity`` (``max_batch_size``)."""
        with self._lock:
            self._c["batches"] += 1
            self._c["batched_rows"] += rows
            self._occupancy_total += rows / float(max(capacity, 1))

    # ---- gauge hookups ----------------------------------------------------
    def set_queue_depth_fn(self, fn):
        self._queue_depth_fn = fn

    def set_cache_stats_fn(self, fn):
        """``fn()`` -> the executor-cache dict (``InferenceEngine.stats``)."""
        self._cache_stats_fn = fn

    def set_gauge_fn(self, name, fn):
        """A named gauge (``fn()`` -> a JSON-able value) read at snapshot
        time."""
        self._gauge_fns[name] = fn

    # ---- reading ----------------------------------------------------------
    def percentiles(self, qs=(50, 95, 99)):
        """Latency percentiles (ms) over the window; nearest-rank."""
        with self._lock:
            lats = [lat for _, lat in self._window]
        return _percentiles(lats, qs)

    def snapshot(self):
        """Every counter and derived gauge as one JSON-able dict."""
        with self._lock:
            c = dict(self._c)
            latency_total = self._latency_total
            occupancy_total = self._occupancy_total
            window = list(self._window)
        now = time.time()
        if len(window) >= 2:
            qps = (len(window) - 1) / max(window[-1][0] - window[0][0], 1e-9)
        elif c["requests"]:
            qps = c["requests"] / max(now - self._t0, 1e-9)
        else:
            qps = 0.0
        lat = self.percentiles()
        lat["mean"] = (latency_total / c["requests"] * 1e3
                       if c["requests"] else 0.0)
        out = {"name": self.name, "uptime_s": now - self._t0, "qps": qps,
               "latency_ms": lat,
               "batch_occupancy": (occupancy_total / c["batches"]
                                   if c["batches"] else 0.0),
               "avg_batch_size": (c["batched_rows"] / c["batches"]
                                  if c["batches"] else 0.0)}
        out.update(c)
        for key, fn in (("queue_depth", self._queue_depth_fn),
                        ("executor_cache", self._cache_stats_fn)):
            if fn is not None:
                out[key] = fn()
        for gname, fn in self._gauge_fns.items():
            out[gname] = fn()
        return out


class GenerationMetrics:
    """TTFT and per-slot decode-rate percentiles, prefill and step times,
    and the request/token counters of one generation lane."""

    def __init__(self, window=2048, name="generation"):
        self.name = name
        self._lock = threading.Lock()
        self._ttft = deque(maxlen=window)       # seconds
        self._tps = deque(maxlen=window)        # per-request tokens/s
        self._c = {"requests": 0, "ok": 0, "errors": 0, "rejected": 0,
                   "expired": 0, "prefills": 0, "prefill_chunks": 0,
                   "steps": 0, "step_failures": 0, "tokens_out": 0,
                   "retired_eos": 0, "retired_length": 0,
                   "retired_max_seq": 0, "retired_prefill": 0,
                   "spec_rounds": 0, "spec_drafted": 0, "spec_accepted": 0}
        self._ttft_total = 0.0
        self._step_time = 0.0
        self._prefill_time = 0.0
        self._step_slots = 0
        self._queue_depth_fn = None
        self._engine = None

    # ---- recording (scheduler hot path) -----------------------------------
    def record_rejected(self):
        with self._lock:
            self._c["rejected"] += 1

    def record_expired(self):
        with self._lock:
            self._c["expired"] += 1

    def record_ttft(self, seconds):
        with self._lock:
            self._ttft.append(seconds)
            self._ttft_total += seconds

    def record_prefill(self, seconds):
        with self._lock:
            self._c["prefills"] += 1
            self._prefill_time += seconds

    def record_prefill_chunk(self):
        """One chunked-prefill call (a slice of a long prompt between two
        decode iterations)."""
        with self._lock:
            self._c["prefill_chunks"] += 1

    def record_step(self, live_slots, seconds):
        """One decode iteration over ``live_slots`` sequences."""
        with self._lock:
            self._c["steps"] += 1
            self._c["tokens_out"] += live_slots
            self._step_slots += live_slots
            self._step_time += seconds

    def record_spec_round(self, live_slots, drafted, emitted, seconds):
        """One speculative iteration: ``drafted`` proposals went into the
        verify, ``emitted`` tokens came out across ``live_slots``
        sequences (``emitted - live_slots`` of them accepted drafts, the
        rest each sequence's bonus token)."""
        with self._lock:
            self._c["steps"] += 1
            self._c["spec_rounds"] += 1
            self._c["spec_drafted"] += drafted
            self._c["spec_accepted"] += max(0, emitted - live_slots)
            self._c["tokens_out"] += emitted
            self._step_slots += live_slots
            self._step_time += seconds

    def record_step_failure(self):
        with self._lock:
            self._c["step_failures"] += 1

    def record_done(self, n_tokens, reason, gen_seconds):
        """A sequence retired cleanly after ``n_tokens`` in ``gen_seconds``
        (first token -> done); its rate counts the ``n_tokens - 1`` decode
        intervals, so a 1-token sequence records none."""
        with self._lock:
            self._c["requests"] += 1
            self._c["ok"] += 1
            key = "retired_%s" % reason
            if key in self._c:
                self._c[key] += 1
            if n_tokens > 1:
                self._tps.append((n_tokens - 1) / max(gen_seconds, 1e-9))

    def record_error(self):
        with self._lock:
            self._c["requests"] += 1
            self._c["errors"] += 1

    # ---- hookups ----------------------------------------------------------
    def set_queue_depth_fn(self, fn):
        self._queue_depth_fn = fn

    def set_engine(self, engine):
        """Wire a ``DecodeEngine`` so snapshots carry its cache occupancy,
        prefill/step counters and compile counters."""
        self._engine = engine

    # ---- reading ----------------------------------------------------------
    def snapshot(self):
        with self._lock:
            c = dict(self._c)
            ttft = list(self._ttft)
            tps = list(self._tps)
            ttft_total = self._ttft_total
            step_time = self._step_time
            prefill_time = self._prefill_time
            step_slots = self._step_slots
        ttft_ms = _percentiles(ttft)
        ttft_ms["mean"] = (ttft_total / len(ttft) * 1e3 if ttft else 0.0)
        out = {
            "name": self.name,
            "ttft_ms": ttft_ms,
            "tokens_s_per_slot": _percentiles(tps, scale=1.0),
            "decode_tokens_s": (c["tokens_out"] / step_time
                                if step_time > 0 else 0.0),
            "prefill_ms_mean": (prefill_time / c["prefills"] * 1e3
                                if c["prefills"] else 0.0),
            "step_ms_mean": (step_time / c["steps"] * 1e3
                             if c["steps"] else 0.0),
            "avg_step_occupancy": (step_slots / c["steps"]
                                   if c["steps"] else 0.0),
            "spec_acceptance_rate": (c["spec_accepted"] /
                                     float(c["spec_drafted"])
                                     if c["spec_drafted"] else 0.0),
        }
        out.update(c)
        if self._queue_depth_fn is not None:
            out["queue_depth"] = self._queue_depth_fn()
        if self._engine is not None:
            out["kvcache"] = self._engine.cache.stats()
            out["engine"] = self._engine.stats()
            out["compile"] = self._engine.compile_stats()
            if self._engine.prefix is not None:
                out["prefix"] = self._engine.prefix.stats()
        return out
