"""Device-fed training: batches copied to the card ahead of the step that
consumes them.

Counterpart of ``mxnet_tpu/parallel/datafeed.py``. :class:`DeviceFeed` is
a depth-K ring of batches already on their way to the device, kept full by
one stager thread that pulls host batches from any source (a Gluon
``DataLoader``, an ``io.DataIter``, or an iterable of numpy arrays,
tensors or NDArrays).

On CUDA every array of a batch goes through a pinned host buffer and is
copied to the card on the stager's own ``torch.cuda.Stream``
(``non_blocking``); an event recorded after the batch's copies travels
with it through the ring. Two rules keep a batch from being stale without
an error:

- a pinned buffer is refilled only after the copy out of it has completed
  (the stager waits on that copy's event), so the ring holds ``depth + 1``
  pinned slots and the stager reuses them in turn;
- the consumer's stream waits on the batch's event before it may touch
  the device tensors, and each tensor is marked used on the consumer's
  stream (``record_stream``), so the allocator does not hand its memory
  to a later batch while the consumer's kernels still read it.

Elsewhere (``device="cpu"``) the feed copies each array to the device it
is given. With a ``mesh`` (or a ``plan``: its mesh and data axes) every
array of a batch is staged once onto the mesh's first device and then
placed as a :class:`~.mesh.ShardedTensor` with its leading axis split over
the data axes (``batch_axes``), each position's rows in its own buffer,
which is what :class:`~.trainer.ShardedTrainer`'s replicas take.

Counters (:func:`feed_stats`, and the profiler rows
``datafeed.<name>.batches``, ``.bytes_staged``, ``.stage_wait_ms``,
``.depth_occupancy``; the ``datafeed`` gauge of ``/metrics``):
``stage_waits`` counts the consumer's waits on an empty ring, the number
the pipeline exists to hold at 0 after warm-up. Knob:
``MXNET_DATAFEED_DEPTH`` (the ring's depth).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from ..context import default_device
from ..ndarray.ndarray import NDArray
from ..observability import tracer as _trace
from ..resilience._stats import Registry, export_rows
from .mesh import ShardedTensor, batch_sharding

__all__ = ["DeviceFeed", "feed_stats"]

_END = object()          # the stager ran the source dry


class _StageError:
    """The stager caught ``exc`` from the source; re-raised at the
    consumer (a stager must never leave the consumer waiting)."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _FeedHandle:
    """What a :class:`DeviceFeed` registers its stats under: a weak
    reference, so that a feed dropped without ``close()`` (and its staged
    buffers) can be collected; the collection removes the handle."""

    __slots__ = ("name", "_ref", "__weakref__")

    def __init__(self, feed):
        self.name = feed.name
        self_ref = weakref.ref(self)

        def on_collect(_, self_ref=self_ref):
            handle = self_ref()
            if handle is not None:
                _registry.discard(handle)

        self._ref = weakref.ref(feed, on_collect)

    def stats(self):
        feed = self._ref()
        return None if feed is None else feed.stats()


class _PinnedSlot:
    """Pinned host buffers for one batch's arrays, and the event of the
    last copy out of them."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs = []
        self.event = None

    def buffer(self, i, like):
        while len(self.bufs) <= i:
            self.bufs.append(None)
        b = self.bufs[i]
        if b is None or b.shape != like.shape or b.dtype != like.dtype:
            b = self.bufs[i] = torch.empty(like.shape, dtype=like.dtype,
                                           pin_memory=True)
        return b


def _stager_main(feed_ref, source, gen):
    """The stager thread. It holds no strong reference to the feed while
    it waits, so an abandoned feed can be collected, and it retires when
    the feed is collected, closed or restarted (``gen`` moved on)."""

    def live_feed():
        feed = feed_ref()
        if feed is None or feed._gen != gen or feed._stop.is_set():
            return None
        return feed

    def ring_put(item):
        while True:
            feed = live_feed()
            if feed is None:
                return False
            ring = feed._ring
            feed = None
            try:
                ring.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue

    try:
        it = iter(source)
        while True:
            if live_feed() is None:
                return
            try:
                item = next(it)
            except StopIteration:
                break
            feed = live_feed()
            if feed is None:
                return
            staged = feed._stage_item(item)
            feed = None
            if not ring_put(staged):
                return
        ring_put(_END)
    except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
        ring_put(_StageError(exc))


class DeviceFeed:
    """Depth-K ring of batches staged to the device ahead of consumption,
    kept full by one stager thread.

    Parameters
    ----------
    source : iterable
        A ``DataLoader``, an ``io.DataIter`` (its ``DataBatch`` items are
        unpacked), or an iterable of batches. A batch is ``(data,
        label)`` (``data`` a tuple or list for several inputs), ``(x1,
        ..., xn, label)``, or a ``DataBatch``.
    depth : int, optional
        Batches staged ahead (default ``MXNET_DATAFEED_DEPTH``).
    output : {"arrays", "batch"}
        ``"arrays"`` (the trainer's) yields ``(xs_tuple, y)`` of device
        tensors; ``"batch"`` (``DataLoader(pin_memory=True)``) yields the
        source's own structure with every array replaced by a device
        NDArray.
    timeout : float
        Seconds the consumer waits on an empty ring before it declares the
        stager wedged.
    name : str
        Stats key: rows ``datafeed.<name>.*``.
    device : torch.device or str, optional
        Where batches go (CUDA when None; raises without one).
    mesh, batch_axes, plan
        Sharded staging over a :class:`~.mesh.Mesh`: the leading axis split
        over ``batch_axes`` (a plan's ``data_axes``; a plan without a mesh
        takes ``plan.n_devices`` positions on ``device``). Only with
        ``output="arrays"``.
    """

    def __init__(self, source, mesh=None, batch_axes=("dp",), depth=None,
                 output="arrays", timeout=120.0, name="default", plan=None,
                 device=None):
        if output not in ("arrays", "batch"):
            raise ValueError("output must be 'arrays' or 'batch', got %r"
                             % (output,))
        if plan is not None:
            if mesh is None:
                mesh = plan.mesh(devices=None if device is None else
                                 [device] * plan.n_devices)
            batch_axes = plan.data_axes
        self._sharding = None
        if mesh is not None:
            if output != "arrays":
                raise ValueError("DeviceFeed: a mesh stages arrays only "
                                 "(output='arrays')")
            self._sharding = batch_sharding(mesh, tuple(batch_axes))
            device = mesh.device(0)
        if depth is None:
            from .. import config as _config
            depth = _config.get("MXNET_DATAFEED_DEPTH")
        if int(depth) < 1:
            raise ValueError("depth must be >= 1, got %r" % (depth,))
        self._device = default_device(device)
        self._cuda = self._device.type == "cuda"
        # a high-priority stream: its copies go ahead of compute, and it is
        # never one of the default-priority pool streams that CUDA-graph
        # captures take
        self._stream = torch.cuda.Stream(self._device, priority=-1) \
            if self._cuda else None
        self._slots = [_PinnedSlot() for _ in range(int(depth) + 1)] \
            if self._cuda else []
        self._slot_next = 0
        self._source = source
        self.depth = int(depth)
        self._output = output
        self._timeout = float(timeout)
        self.name = name
        self._ring = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._gen = 0           # moved on by a restart: retires old stagers
        self._thread = None
        self._closed = False    # only reset() revives a closed feed
        self._exhausted = False
        self._holdover = deque()    # batches handed back by _unget
        self._lock = threading.Lock()
        self._stats = {"batches": 0, "bytes_staged": 0, "stage_time_s": 0.0,
                       "stage_waits": 0, "stage_wait_s": 0.0, "flushed": 0}
        self._reg_handle = _FeedHandle(self)
        _registry.add(self._reg_handle)

    # -- staging (on the stager thread only) --------------------------------

    @staticmethod
    def _host_tensor(a):
        if isinstance(a, NDArray):
            return a._data
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a))

    def _put_one(self, a, slot, i):
        """Stage one array: through ``slot``'s ``i``-th pinned buffer on
        CUDA (an array already on the card passes as it is), a copy
        elsewhere."""
        v = self._host_tensor(a)
        if self._cuda and v.device == self._device:
            return v
        t0 = time.perf_counter()
        if self._cuda:
            pin = slot.buffer(i, v)
            pin.copy_(v)
            with torch.cuda.stream(self._stream):
                out = torch.empty(v.shape, dtype=v.dtype,
                                  device=self._device)
                out.copy_(pin, non_blocking=True)
        else:
            out = v.to(self._device, copy=True)
        dt = time.perf_counter() - t0
        with self._lock:
            self._stats["bytes_staged"] += v.numel() * v.element_size()
            self._stats["stage_time_s"] += dt
        return out

    def _split(self, item):
        """One source item as ``(xs_tuple, y)``."""
        if hasattr(item, "data") and hasattr(item, "label"):  # DataBatch
            xs = tuple(item.data)
            label = item.label or ()
            if len(label) != 1:
                raise ValueError(
                    "DeviceFeed: DataBatch must carry exactly one label "
                    "array, got %d" % len(label))
            return xs, label[0]
        if isinstance(item, (list, tuple)):
            if len(item) < 2:
                raise ValueError("DeviceFeed: batch must be (data, label), "
                                 "got %d element(s)" % len(item))
            head, y = item[0], item[-1]
            if len(item) == 2 and isinstance(head, (list, tuple)):
                return tuple(head), y     # ((x1, x2, ...), y)
            return tuple(item[:-1]), y    # (x1, ..., xn, y)
        raise TypeError("DeviceFeed: cannot split batch of type %s into "
                        "(data, label)" % type(item).__name__)

    def _take_slot(self):
        """The next pinned slot, once the copy out of it has finished."""
        if not self._cuda:
            return None
        slot = self._slots[self._slot_next]
        self._slot_next = (self._slot_next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def _stage_item(self, item):
        with _trace.span("datafeed.stage", feed=self.name):
            slot = self._take_slot()
            counter = iter(range(1 << 30))
            if self._output == "batch":
                staged = self._stage_structure(item, slot, counter)
            else:
                xs, y = self._split(item)
                staged = (tuple(self._put_one(x, slot, next(counter))
                                for x in xs),
                          self._put_one(y, slot, next(counter)))
                if self._sharding is not None:
                    staged = self._shard(staged)
            event = None
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
                slot.event = event
            return staged, event

    def _shard(self, staged):
        """The staged arrays placed over the mesh (on the stager's stream,
        after their copies)."""
        xs, y = staged
        place = ShardedTensor.place
        with torch.cuda.stream(self._stream) if self._cuda else \
                contextlib.nullcontext():
            out = (tuple(place(x, self._sharding) for x in xs),
                   place(y, self._sharding))
        if self._cuda and any(t.device != self._device
                              for t in out[1].shards):
            # shards on other GPUs: their copies are done before the
            # batch is handed on (the consumer's stream waits on this
            # device's stream only)
            self._stream.synchronize()
        return out

    def _stage_structure(self, item, slot, counter):
        """``output="batch"``: the same structure, with device NDArray
        leaves (lists, tuples, namedtuples and dicts recursed)."""
        if isinstance(item, tuple) and hasattr(item, "_fields"):
            return type(item)(*(self._stage_structure(v, slot, counter)
                                for v in item))
        if isinstance(item, (list, tuple)):
            return type(item)(self._stage_structure(v, slot, counter)
                              for v in item)
        if isinstance(item, dict):
            return {k: self._stage_structure(v, slot, counter)
                    for k, v in item.items()}
        if isinstance(item, (NDArray, np.ndarray, torch.Tensor)):
            return NDArray(self._put_one(item, slot, next(counter)))
        return item

    def _check_open(self):
        if self._closed:
            raise RuntimeError(
                "DeviceFeed(%s) is closed: build a new feed or call "
                "reset()" % self.name)

    def _ensure_started(self):
        self._check_open()
        if self._thread is None and not self._exhausted:
            self._thread = threading.Thread(
                target=_stager_main,
                args=(weakref.ref(self), self._source, self._gen),
                daemon=True, name="datafeed-stager-%s" % self.name)
            self._thread.start()

    # -- consumer -----------------------------------------------------------

    def __iter__(self):
        self._check_open()
        if self._exhausted:
            # a re-iterable source starts over; a spent generator yields
            # nothing
            self._restart()
        self._ensure_started()
        return self

    def _claim(self, staged, event):
        """Make a staged batch safe on the consumer's current stream."""
        if not self._cuda:
            return staged
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)

        def mark(v):
            t = v._data if isinstance(v, NDArray) else v
            if isinstance(t, ShardedTensor):
                mark(t.shards)
            elif isinstance(t, torch.Tensor) and t.device == self._device:
                t.record_stream(stream)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    mark(x)
            elif isinstance(v, dict):
                for x in v.values():
                    mark(x)
        mark(staged)
        return staged

    def __next__(self):
        if self._holdover:
            # a batch handed back by _unget (counted when first served)
            return self._holdover.popleft()
        self._ensure_started()
        if self._exhausted:
            raise StopIteration
        waited = None
        wait_t0 = None
        try:
            item = self._ring.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            wait_t0 = _trace.now()
            try:
                item = self._ring.get(timeout=self._timeout)
            except queue.Empty:
                raise RuntimeError(
                    "DeviceFeed(%s): the stager produced nothing for %.0f s "
                    "(a wedged source?)" % (self.name, self._timeout))
            waited = time.perf_counter() - t0
        if item is _END:
            self._finish_epoch()
            raise StopIteration
        if isinstance(item, _StageError):
            self._finish_epoch()
            raise item.exc
        with self._lock:
            self._stats["batches"] += 1
            if waited is not None:
                # a real batch was waited for: the consumer stalled on
                # staging (a wait that ended in the epoch's end is none)
                self._stats["stage_waits"] += 1
                self._stats["stage_wait_s"] += waited
        if waited is not None and _trace.enabled():
            _trace.complete("datafeed.consumer_wait", wait_t0,
                            wait_t0 + waited, parent=_trace.current(),
                            feed=self.name)
        return self._claim(*item)

    next = __next__

    def _unget(self, item):
        """Hand a consumed batch back to the front of the feed:
        ``step_stream`` does so when a fault fires after it peeked a
        chunk's first batch."""
        self._holdover.append(item)

    def _finish_epoch(self):
        self._exhausted = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _restart(self):
        self._drain()
        self._gen += 1
        self._stop = threading.Event()
        self._exhausted = False

    def prefill(self, timeout=30.0):
        """Block until the ring is full or the source ran dry, so that the
        first batch consumed has ``depth - 1`` successors staged. Returns
        the number of batches in the ring."""
        self._ensure_started()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._ring.full() or self._thread is None \
                    or not self._thread.is_alive():
                break
            time.sleep(0.002)
        return self._ring.qsize()

    def flush(self):
        """Stop the stager and discard every staged batch not consumed
        (the ring and the handed-back ones); returns how many. The next
        iteration starts the source over."""
        self._check_open()
        n = len(self._holdover)
        n += self._shutdown()
        self._restart()
        with self._lock:
            self._stats["flushed"] += n
        return n

    def reset(self):
        """Stop staging, reset a resettable source, and start from its
        top; revives a closed feed."""
        self._shutdown()
        if hasattr(self._source, "reset"):
            self._source.reset()
        if self._closed:
            self._closed = False
            _registry.add(self._reg_handle)
        self._restart()

    def _drain(self):
        """Empty the ring; returns how many batches were discarded."""
        n = 0
        while True:
            try:
                item = self._ring.get_nowait()
            except queue.Empty:
                return n
            if item is not _END and not isinstance(item, _StageError):
                n += 1

    def _shutdown(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
            self._thread = None
        n = self._drain()
        self._holdover.clear()
        return n

    def close(self):
        """Stop the stager, release the staged batches and leave the stats
        registry. Idempotent; :meth:`reset` revives the feed."""
        self._closed = True
        self._shutdown()
        _registry.discard(self._reg_handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    # -- stats --------------------------------------------------------------

    def stats(self):
        """``{batches, bytes_staged, stage_time_s, stage_waits,
        stage_wait_s, flushed, depth, depth_occupancy}``."""
        with self._lock:
            out = dict(self._stats)
        out["depth"] = self.depth
        out["depth_occupancy"] = self._ring.qsize()
        return out


_registry = Registry()


def feed_stats():
    """``{name: stats}`` of every live :class:`DeviceFeed`."""
    return {name: st
            for name, st in _registry.map(lambda h: h.stats()).items()
            if st is not None}


def _profiler_rows():
    rows = {}
    for name, st in feed_stats().items():
        rows["datafeed.%s.batches" % name] = (st["batches"],
                                              st["stage_time_s"])
        rows["datafeed.%s.bytes_staged" % name] = (st["bytes_staged"], 0.0)
        rows["datafeed.%s.stage_wait_ms" % name] = (st["stage_waits"],
                                                    st["stage_wait_s"])
        rows["datafeed.%s.depth_occupancy" % name] = (st["depth_occupancy"],
                                                      0.0)
    return rows


export_rows(_profiler_rows)
