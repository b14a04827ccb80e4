"""InferenceEngine: shape-bucketed model execution with a bounded cache.

Counterpart of ``mxnet_tpu/serving/engine.py``. Every new input signature
is a ``CachedOp`` miss, which on the card captures a CUDA graph, so
traffic with arbitrary batch sizes is padded up a bucket ladder
(``DEFAULT_BUCKETS``): the number of graphs is bounded by the ladder,
whatever the traffic. The engine wraps the model in one ``CachedOp``; its
``cache_stats()`` are the hit/miss/eviction counters that ``/metrics``
shows.

Padding: pad rows are zeros appended on axis 0 and sliced off every
output's axis 0 before anything leaves the engine, so a model's outputs
must carry the batch on axis 0. (A pad row of BERT has ``valid_len`` 0:
the flash kernel gives it zeros where the plain path would average V;
either way it never reaches a reply.)

:meth:`InferenceEngine.load` serves ``HybridBlock.export``'s files
through ``SymbolBlock.imports``. ``export_artifacts``/``load_artifacts``,
``prewarm`` and the warmup manifests (AOT artifacts, ROADMAP Queue A item
12) are not ported.
"""
from __future__ import annotations

import bisect
import threading

import numpy as _np

from .. import config as _config
from ..cached_op import CachedOp
from ..context import current_context
from ..ndarray import ndarray as _nd
from ..observability import tracer as _trace
from ..resilience import retry as _retry

__all__ = ["InferenceEngine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def _as_ndarray(x, ctx, dtype=None):
    if isinstance(x, _nd.NDArray):
        return x.as_in_context(ctx)
    return _nd.array(_np.asarray(x), ctx=ctx, dtype=dtype)


class InferenceEngine:
    """Run ``model`` (NDArrays in; an NDArray or a list/tuple of NDArrays
    out; batch on axis 0) with batch-axis bucketing.

    ``buckets`` is the ladder: a batch pads up to the smallest bucket
    ``>= n``, and one larger than the top bucket runs in top-bucket
    chunks. ``jit=False`` calls the model directly (no CachedOp). Inputs
    go to ``ctx`` (the current context at construction when None: the
    card unless a CPU scope is open), and the model runs in that context's
    scope, whatever thread calls.
    ``metrics`` (a ``ServingMetrics``) gets :meth:`stats` as its
    executor-cache gauge. ``retry_policy`` wraps every bucketed run (None:
    the env-configured ``retry.engine`` policy; False: none)."""

    def __init__(self, model, buckets=DEFAULT_BUCKETS, jit=True,
                 metrics=None, retry_policy=None, name="inference_engine",
                 ctx=None):
        if retry_policy is None:
            retry_policy = _retry.named_policy("retry.engine")
        self._retry = retry_policy or None
        if not buckets:
            raise ValueError("need at least one bucket size")
        self._buckets = sorted(set(int(b) for b in buckets))
        if self._buckets[0] < 1:
            raise ValueError("bucket sizes must be >= 1")
        self._model = model
        self._name = name
        self._ctx = ctx if ctx is not None else current_context()
        self._lock = threading.Lock()
        self._buckets_seen = set()
        self._op = CachedOp(lambda *args: model(*args), name=name) \
            if jit else None
        self._metrics = metrics
        if metrics is not None:
            metrics.set_cache_stats_fn(self.stats)

    @staticmethod
    def load(path, input_names=("data",), epoch=0, ctx=None, **kwargs):
        """An engine over ``path-symbol.json`` and ``path-%04d.params``
        (``HybridBlock.export``'s files, or ``Module.save_checkpoint``'s):
        the graph as a ``SymbolBlock`` whose parameters lie on ``ctx``
        (the current context when None: the card unless a CPU scope is
        open), run there. ``kwargs`` go to the engine."""
        import os
        from ..gluon.block import SymbolBlock
        params_file = "%s-%04d.params" % (path, epoch)
        block = SymbolBlock.imports(
            "%s-symbol.json" % path, list(input_names),
            params_file if os.path.exists(params_file) else None, ctx=ctx)
        return InferenceEngine(block, ctx=ctx, **kwargs)

    @property
    def buckets(self):
        return tuple(self._buckets)

    @property
    def ctx(self):
        return self._ctx

    @property
    def cached_op(self):
        """The engine's ``CachedOp`` (None with ``jit=False``)."""
        return self._op

    def bucket_for(self, n):
        """Smallest bucket ``>= n`` (the top bucket when ``n`` is above
        the ladder: callers chunk first)."""
        i = bisect.bisect_left(self._buckets, n)
        return self._buckets[min(i, len(self._buckets) - 1)]

    def _run_bucketed(self, arrays):
        """Pad ``arrays`` (each ``(n, ...)``) up to the bucket, run, and
        slice the pad rows off every output."""
        n = arrays[0].shape[0]
        bucket = self.bucket_for(n)
        with self._lock:
            self._buckets_seen.add(bucket)
        with _trace.span("serving.engine.execute", bucket=bucket, rows=n):
            padded = []
            for a in arrays:
                if a.shape[0] != n:
                    raise ValueError(
                        "all inputs must share batch size: got %d vs %d"
                        % (a.shape[0], n))
                if n < bucket:
                    fill = _nd.zeros((bucket - n,) + tuple(a.shape[1:]),
                                     ctx=a.ctx, dtype=a._data.dtype)
                    a = _nd.concat(a, fill, dim=0)
                padded.append(a)
            with self._ctx:
                out = self._op(*padded) if self._op is not None \
                    else self._model(*padded)
            multi = isinstance(out, (list, tuple))
            outs = list(out) if multi else [out]
            if n < bucket:
                outs = [o[0:n] for o in outs]
            return outs, multi

    def predict(self, *inputs):
        """Run a batch: each input is ``(n, ...)`` (NDArray or array-like).
        Returns outputs of exactly ``n`` rows; batches above the top
        bucket run in top-bucket chunks and are concatenated."""
        if not inputs:
            raise ValueError("predict() needs at least one input")
        arrays = [_as_ndarray(x, self._ctx) for x in inputs]
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty batch")
        run = (self._run_bucketed if self._retry is None
               else lambda a: self._retry.call(self._run_bucketed, a))
        cap = self._buckets[-1]
        if n <= cap:
            outs, multi = run(arrays)
            return outs if multi else outs[0]
        chunks, multi = [], False
        for start in range(0, n, cap):
            outs, multi = run([a[start:min(start + cap, n)]
                               for a in arrays])
            chunks.append(outs)
        merged = [_nd.concat(*[c[i] for c in chunks], dim=0)
                  for i in range(len(chunks[0]))]
        return merged if multi else merged[0]

    def __call__(self, *inputs):
        return self.predict(*inputs)

    def warmup(self, example, dtype=None, threads=None):
        """Run every bucket once (on the card: capture its graph) so that
        no request pays a capture. ``example`` is one input, or a tuple of
        inputs, whose trailing dims and dtypes are representative (its
        batch size is ignored). Rungs run on a pool ``threads`` wide
        (default ``MXNET_WARMUP_THREADS``; <= 1 is serial); captures
        serialize on the CachedOp's lock. Returns self."""
        examples = example if isinstance(example, (list, tuple)) \
            else (example,)
        arrays = [_as_ndarray(x, self._ctx, dtype=dtype) for x in examples]
        batches = [[_nd.zeros((bucket,) + tuple(a.shape[1:]), ctx=a.ctx,
                              dtype=a._data.dtype) for a in arrays]
                   for bucket in self._buckets]
        if threads is None:
            threads = _config.get("MXNET_WARMUP_THREADS")
        threads = min(int(threads), len(batches))
        if threads <= 1:
            for batch in batches:
                self._run_bucketed(batch)
            return self
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads,
                                thread_name_prefix=self._name + "-warmup") \
                as pool:
            futures = [pool.submit(self._run_bucketed, b) for b in batches]
        for f in futures:
            f.result()
        return self

    def close(self):
        """Drop every cached entry (and its graph); the engine stays
        callable. Idempotent."""
        if self._op is not None:
            self._op.clear()

    def stats(self):
        """``/metrics``' executor cache: the ladder, the buckets hit, and
        the CachedOp's counters (``compiles`` = misses)."""
        with self._lock:
            seen = sorted(self._buckets_seen)
        out = {"buckets": list(self._buckets), "buckets_seen": seen}
        if self._op is not None:
            cs = self._op.cache_stats()
            out.update(cs)
            out["compiles"] = cs["misses"]
        else:
            out.update({"size": len(seen), "capacity": 0, "hits": 0,
                        "misses": len(seen), "evictions": 0,
                        "compiles": len(seen)})
        return out
