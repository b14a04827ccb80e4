"""DataLoader: counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (the
reference's ``python/mxnet/gluon/data/dataloader.py``).

Batches are assembled on the host and come out as NDArrays on the CPU, as
MXNet's do. ``num_workers`` are threads (the reference's choice too: the
decode and augmentation are numpy, which releases the GIL for the heavy
parts). ``pin_memory=True`` stages every batch through a
:class:`~mxnet_tpu_torch.parallel.datafeed.DeviceFeed` (``output="batch"``):
pinned host buffers copied to the card on their own stream ahead of the
consumer, which receives the loader's batch structure with CUDA NDArray
leaves. ``error_policy``/``max_skips`` and :class:`DataLoaderSkipLimit`
are the reference's.
"""
from __future__ import annotations

import itertools
import queue
import threading
import weakref

import numpy as np
import torch

from ...context import cpu, current_context
from ...ndarray import ndarray as _nd
from ...ndarray.ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader", "DataLoaderSkipLimit", "default_batchify_fn"]

# distinct pin_memory stats name per loader (datafeed registry is
# latest-wins per name; train + val loaders must both stay visible)
_pin_seq = itertools.count()


class DataLoaderSkipLimit(RuntimeError):
    """``error_policy="skip"`` hit its bad-sample cap
    (``MXNET_DATALOADER_MAX_SKIPS``): this is data-wide corruption, not a
    few bad records — failing loudly beats silently training on a
    shrinking dataset. ``__cause__`` is the last sample error."""


# process-wide skipped-sample counter, exported to the profiler aggregate
# table (row ``guardrails.dataloader.skipped``) so silent data loss is
# never actually silent
_skip_lock = threading.Lock()
_skipped_total = 0


def _count_skip(n=1):
    global _skipped_total
    with _skip_lock:
        _skipped_total += n


def _profiler_rows():
    with _skip_lock:
        return {"guardrails.dataloader.skipped": (_skipped_total, 0.0)}


from ...resilience._stats import export_rows as _export_rows  # noqa: E402

_export_rows(_profiler_rows)


def default_batchify_fn(data):
    """Stack samples into a batch (NDArrays on the CPU)."""
    if isinstance(data[0], NDArray):
        return _nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)         # a new array: the samples stacked
    return NDArray(data, ctx=cpu(),
                   dtype=data.dtype if data.dtype != np.float64
                   else np.float32)


class DataLoader:
    """Batches of ``dataset``, drawn by a sampler, on worker threads."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 error_policy="raise", max_skips=None):
        """``pin_memory``: batches are staged through a
        :class:`~mxnet_tpu_torch.parallel.datafeed.DeviceFeed` ring (depth
        ``prefetch`` if set, else ``MXNET_DATAFEED_DEPTH``) of pinned host
        buffers copied to the card ``pin_device_id`` ahead of the
        consumer, and come out as CUDA NDArrays; under a CPU context
        (``with mx.cpu():``) they are staged to the CPU. One ring is live per
        loader: a new epoch closes the previous one, so iterate a pinned
        loader from one place at a time.

        ``error_policy``: what to do when a sample's ``__getitem__`` or its
        batchify raises: ``"raise"`` (the error reaches the consumer) or
        ``"skip"`` (the sample is dropped and counted in the
        ``guardrails.dataloader.skipped`` profiler row; the rest of the
        batch is served). ``max_skips`` caps the skipped samples of one
        iteration (default ``MXNET_DATALOADER_MAX_SKIPS``; negative =
        unbounded); past it :class:`DataLoaderSkipLimit` is raised.
        """
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._pin_device_id = int(pin_device_id)
        self._timeout = timeout
        if error_policy not in ("raise", "skip"):
            raise ValueError("error_policy must be 'raise' or 'skip', got "
                             "%r" % (error_policy,))
        self._error_policy = error_policy
        if max_skips is None:
            from ... import config as _config
            max_skips = _config.get("MXNET_DATALOADER_MAX_SKIPS")
        self._max_skips = int(max_skips)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn

    def _load_batch(self, idxs, budget):
        """Fetch + batchify one batch honoring ``error_policy``. Returns
        the batch, or None when every sample in it was skipped."""
        if self._error_policy == "raise":
            return self._batchify_fn([self._dataset[idx] for idx in idxs])
        samples = []
        for idx in idxs:
            try:
                samples.append(self._dataset[idx])
            except Exception as e:  # noqa: BLE001 — the policy's whole point
                budget.spend(1, e)
        if not samples:
            return None
        try:
            return self._batchify_fn(samples)
        except Exception:  # noqa: BLE001 — attribute the failure per sample
            good = []
            for s in samples:
                try:
                    self._batchify_fn([s])
                    good.append(s)
                except Exception as e:  # noqa: BLE001
                    budget.spend(1, e)
            if not good:
                return None
            # a mix that STILL fails jointly (shape-incompatible but each
            # fine alone) is a batchify bug, not a bad sample: propagate
            return self._batchify_fn(good)

    def __iter__(self):
        if self._num_workers == 0:
            def same_process_iter():
                budget = _SkipBudget(self._max_skips)
                for batch in self._batch_sampler:
                    out = self._load_batch(batch, budget)
                    if out is not None:
                        yield out
            base = same_process_iter()
        else:
            base = _MultiWorkerIter(self)
        if not self._pin_memory:
            return base
        from ...parallel.datafeed import DeviceFeed
        depth = self._prefetch if self._prefetch > 0 else None
        # retire the previous epoch's feed (if any): an abandoned mid-epoch
        # ring must not keep its stager thread parked on a full queue
        last_ref = getattr(self, "_pin_feed", None)
        last = last_ref() if last_ref is not None else None
        if last is not None:
            last.close()
        # a stats name per loader: a train and a val loader must not
        # evict each other's rows
        name = getattr(self, "_pin_name", None)
        if name is None:
            name = self._pin_name = "dataloader.%d" % next(_pin_seq)
        ctx = current_context()
        device = torch.device("cuda", self._pin_device_id) \
            if ctx.device_type == "gpu" else ctx.torch_device
        feed = DeviceFeed(base, output="batch", depth=depth,
                          timeout=self._timeout, name=name, device=device)
        # a weak reference: the feed belongs to the epoch's consumer (the
        # stager, whose source reaches the loader, would otherwise keep an
        # abandoned feed alive)
        self._pin_feed = weakref.ref(feed)
        return iter(feed)

    def __len__(self):
        return len(self._batch_sampler)


class _SkipBudget:
    """Per-iteration skip accounting shared across worker threads: counts
    into the process-wide profiler row and enforces the loud-failure cap."""

    def __init__(self, cap):
        self._lock = threading.Lock()
        self._cap = cap
        self.count = 0

    def spend(self, n, err):
        with self._lock:
            self.count += n
            count = self.count
        _count_skip(n)
        if self._cap >= 0 and count > self._cap:
            raise DataLoaderSkipLimit(
                "DataLoader skipped %d samples (cap %d, "
                "MXNET_DATALOADER_MAX_SKIPS) — data-wide corruption?"
                % (count, self._cap)) from err


class _MultiWorkerIter:
    """Thread-pool prefetching iterator (the role of MXNet's fork-based
    ``_MultiWorkerIter``)."""

    def __init__(self, loader):
        self._loader = loader
        self._batches = list(loader._batch_sampler)
        self._n = len(self._batches)
        self._sent = 0
        self._got = 0
        self._results = {}
        self._out_q = queue.Queue()
        self._task_q = queue.Queue()
        self._budget = _SkipBudget(loader._max_skips)
        depth = max(1, loader._prefetch)
        for _ in range(loader._num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
        for _ in range(min(depth, self._n)):
            self._dispatch()

    def _worker(self):
        while True:
            item = self._task_q.get()
            if item is None:
                return
            i, idxs = item
            try:
                batch = self._loader._load_batch(idxs, self._budget)
                self._out_q.put((i, batch, None))
            except Exception as e:  # propagate to consumer
                self._out_q.put((i, None, e))

    def _dispatch(self):
        if self._sent < self._n:
            self._task_q.put((self._sent, self._batches[self._sent]))
            self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._got >= self._n:
                for _ in range(self._loader._num_workers):
                    self._task_q.put(None)
                raise StopIteration
            while self._got not in self._results:
                i, batch, err = self._out_q.get(
                    timeout=self._loader._timeout)
                self._results[i] = (batch, err)
            batch, err = self._results.pop(self._got)
            self._got += 1
            self._dispatch()
            if err is not None:
                raise err
            if batch is None:  # every sample skipped: move to the next one
                continue
            return batch

    next = __next__
