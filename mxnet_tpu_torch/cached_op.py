"""CachedOp: run a callable over NDArrays from a cache keyed on its
inputs' signature, capturing one CUDA graph per signature on the card.

Counterpart of ``mxnet_tpu/cached_op.py``. The reference traces the
callable once per (input shapes, dtypes, train mode) signature and
compiles an XLA program; the port keys the same signature
(:meth:`CachedOp._signature`), with the same LRU bound (``capacity``,
``MXNET_CACHED_OP_CAPACITY``) and the same counters (:meth:`cache_stats`
per instance; :func:`cache_stats` and :func:`reset_cache_stats` over the
process). What an entry holds:

- **On a CUDA device, not recording and not training**, a miss runs the
  callable once on a side stream (so that cuBLAS and the kernels' loaders
  allocate their workspaces outside the capture; one stream a device for
  every capture, since cuBLAS keeps a workspace per stream), then captures
  it into a ``torch.cuda.CUDAGraph`` over static input buffers. A call
  copies its inputs into the buffers, replays the graph and clones the
  outputs out of the graph's buffers before the op's lock is released:
  many HTTP threads dispatch one CachedOp, and the next replay overwrites
  those buffers. The op's graphs share one memory pool; replays are
  serialized under the lock, so one graph's intermediates never outlive
  its replay.
  ``pool_bytes`` is the growth of the allocator's reserved bytes during
  the captures (the pool's size: later captures reuse its free blocks),
  and ``capture_ms`` each signature's capture time (host wall clock, the
  side-stream run included). A capture runs with the garbage collector
  paused, so that no finalizer of a CUDA resource runs inside it. A capture that fails raises; nothing falls
  back to eager execution. A graph reads the storage it was captured
  over, so whatever gives a parameter new storage (``Parameter.cast``,
  ``reset_ctx`` or a re-initialization, ``Block.cast``, a module's
  ``.to``, ``ShardedTrainer.sync_back``) calls :func:`storage_rebound`,
  and every CachedOp drops its graphs at its next call (the next call of
  each signature captures again, a miss).
- **Under ``autograd.record()``, or with the training flag on** (dropout
  draws its key words on the host at each call, so a captured graph would
  bake one mask in), no graph is captured: the call runs the callable under
  torch's autograd, and the signature is still counted in the cache.
- **On the CPU**, a miss captures nothing and every call runs the
  callable; the counters are the same.
- **A callable that reaches a host op** (``ops.registry.register(
  host_op=True)``: ``Custom``, the graph ops; their code reads values to
  the host, which a capture refuses) is seen by the miss's side-stream
  run: that signature captures nothing and runs eagerly at every call,
  and :meth:`CachedOp.cache_stats` counts it under ``"host_eager"`` (on
  the CPU too, where the call itself shows it). A capture of any other
  callable that fails still raises.

A callable that draws from its own ``torch.Generator`` names it in
``generators``: each graph registers it before the capture
(``CUDAGraph.register_generator_state``), so every replay advances it and
draws new numbers. The side-stream run and the capture advance it too,
so after a miss a seeded generator is no longer where an eager run would
have it. Each graph registers the device's sampler generator too
(``ops.random_ops.graph_generators``, once a sampler has run there), so
the registry's samplers inside a captured callable (``_random_*``,
``_sample_*``) draw new numbers at each replay.

A CachedOp called while another one runs its callable (a hybridized block
inside a served function) runs its callable inline, as the reference
inlines a nested trace into the outer program. Aux-state writes
(``_tape.aux_write``) inside a captured graph become extra graph outputs,
written back to their handles after each replay.

``flops_per_call``/``bytes_per_call`` (the reference's XLA cost analysis)
wait for the attribution module (ROADMAP Queue A item 11b);
``serialize``/``deserialize`` wait for AOT artifacts (item 12).
"""
from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict

import torch

from . import _tape
from . import config as _config
from .ops.random_ops import graph_generators
from .ops.registry import host_calls

__all__ = ["CachedOp", "cache_stats", "reset_cache_stats", "storage_rebound"]

# process-wide counters summed over every CachedOp (the serving layer's
# /metrics reads them): a miss is one capture (or, off the graph path, one
# new signature), an eviction one entry dropped under the LRU bound
_GLOBAL_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_STATS_LOCK = threading.Lock()
_inline = threading.local()
# how many times some parameter's storage was replaced; an op whose graphs
# were captured under an older count drops them
_STORAGE_EPOCH = [0]


_SIDE_STREAMS = {}
# the cache entry of a signature whose callable reaches a host op: it runs
# eagerly at every call
_HOST = "host"


def _side_stream(device):
    """The one stream a device's captures warm up on. cuBLAS keeps a
    workspace (32 MiB on Hopper) for every stream it has run on until the
    process ends, so a new stream for each capture would leave one
    workspace behind per capture."""
    with _STATS_LOCK:
        stream = _SIDE_STREAMS.get(device)
        if stream is None:
            stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        return stream


def storage_rebound():
    """Note that a parameter was given new storage: every CachedOp drops
    its captured graphs at its next call."""
    with _STATS_LOCK:
        _STORAGE_EPOCH[0] += 1


def cache_stats():
    """Process-wide ``{"hits", "misses", "evictions"}`` over every
    CachedOp since the last :func:`reset_cache_stats`."""
    with _STATS_LOCK:
        return dict(_GLOBAL_STATS)


def reset_cache_stats():
    with _STATS_LOCK:
        for k in _GLOBAL_STATS:
            _GLOBAL_STATS[k] = 0


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    and the handles its aux outputs write back to."""
    __slots__ = ("graph", "inputs", "outputs", "n_out", "multi", "aux")

    def __init__(self, graph, inputs, outputs, n_out, multi, aux):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.n_out = n_out
        self.multi = multi
        self.aux = aux

    def replay(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a._data)
        self.graph.replay()
        outs = [o.clone() for o in self.outputs]
        for h, v in zip(self.aux, outs[self.n_out:]):
            _tape.assign(h, v)
        return outs[:self.n_out], self.multi


class CachedOp:
    """Signature-cached executor of ``fn`` (NDArrays in, an NDArray or a
    list/tuple of NDArrays out). ``static_alloc``, ``static_shape`` and
    the bulk sizes are kept for API parity: a captured graph is always
    statically allocated. ``generators`` are the CUDA generators ``fn``
    draws from besides the default one."""

    def __init__(self, fn, static_alloc=False, static_shape=False,
                 inline_limit=2, forward_bulk_size=None,
                 backward_bulk_size=None, name="CachedOp", capacity=None,
                 generators=()):
        self._fn = fn
        self._name = name
        self._generators = tuple(generators)
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape,
                           inline_limit=inline_limit,
                           forward_bulk_size=forward_bulk_size,
                           backward_bulk_size=backward_bulk_size)
        if capacity is None:
            capacity = _config.get("MXNET_CACHED_OP_CAPACITY")
        self._capacity = int(capacity)
        self._cache = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "host_eager": 0}
        self._pool = None
        self.pool_bytes = 0
        self.capture_ms = {}
        self._epoch = _STORAGE_EPOCH[0]
        self._dispatch_lock = threading.Lock()

    def cache_stats(self):
        """This op's ``{"size", "capacity", "hits", "misses",
        "evictions", "graphs", "pool_bytes", "host_eager"}``
        (``host_eager``: signatures that reach a host op and run
        eagerly)."""
        with self._dispatch_lock:
            out = dict(self._stats)
            out["size"] = len(self._cache)
            out["graphs"] = sum(isinstance(e, _Graph)
                                for e in self._cache.values())
            out["pool_bytes"] = self.pool_bytes
        out["capacity"] = self._capacity
        return out

    def clear(self):
        """Drop every entry and its graph (the counters keep their
        history)."""
        with self._dispatch_lock:
            self._cache.clear()
            self._drop_pool_if_unused()

    def _drop_pool_if_unused(self):
        # the allocator frees a private pool with its last graph, and a
        # freed pool's handle must not be captured into again
        if not any(isinstance(e, _Graph) for e in self._cache.values()):
            self._pool = None
            self.pool_bytes = 0

    def _mark_host(self, sig):
        """Note an eager call of ``sig`` that reached a host op."""
        with self._dispatch_lock:
            if self._cache.get(sig) is True:
                self._cache[sig] = _HOST
                self._stats["host_eager"] += 1

    def _signature(self, args):
        return (tuple((a.shape, str(a.dtype)) for a in args),
                _tape.is_training())

    def _run(self, args):
        """``fn`` over ``args`` with nested CachedOps inline; returns the
        output tensors (aux values appended), their count and whether
        ``fn`` returned a sequence, and the aux handles."""
        from .ndarray.ndarray import NDArray
        prev = getattr(_inline, "depth", 0)
        _inline.depth = prev + 1
        sink = _tape.push_aux_sink()
        try:
            outs = self._fn(*args)
        finally:
            _tape.pop_aux_sink()
            _inline.depth = prev
        multi = isinstance(outs, (list, tuple))
        outs = list(outs) if multi else [outs]
        tensors = [o._data if isinstance(o, NDArray) else o for o in outs]
        return (tensors + [v for _, v in sink], len(outs), multi,
                [h for h, _ in sink])

    def _capture(self, args):
        from .ndarray.ndarray import NDArray
        t0 = time.perf_counter()
        dev = args[0]._data.device
        static = [NDArray(a._data.detach().clone()) for a in args]
        prev_rec = _tape.set_recording(False)
        try:
            with torch.no_grad():
                side = _side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                calls = host_calls()
                with torch.cuda.stream(side):
                    self._run(static)
                torch.cuda.current_stream(dev).wait_stream(side)
                if host_calls() != calls:
                    return _HOST
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                for gen in self._generators + graph_generators(dev):
                    graph.register_generator_state(gen)
                # no collection inside the capture: a finalizer of garbage
                # that owns CUDA resources (an old graph, an event, pinned
                # memory) would call the runtime there and invalidate it
                # (a collection first would cost every capture ~0.1 s)
                gc_was_enabled = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool,
                                          capture_error_mode="thread_local"):
                        # read inside: entering the capture empties the
                        # cache
                        reserved = torch.cuda.memory_reserved(dev)
                        outs, n_out, multi, aux = self._run(static)
                finally:
                    if gc_was_enabled:
                        gc.enable()
                self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
                torch.cuda.synchronize(dev)
        except BaseException:
            self._drop_pool_if_unused()     # a failed capture holds none
            raise
        finally:
            _tape.set_recording(prev_rec)
        self.capture_ms[str(self._signature(args)[0])] = \
            (time.perf_counter() - t0) * 1e3
        return _Graph(graph, [s._data for s in static], outs, n_out, multi,
                      aux)

    def __call__(self, *args):
        from .ndarray.ndarray import NDArray
        args = [a if isinstance(a, NDArray) else NDArray(a) for a in args]
        if getattr(_inline, "depth", 0):
            return self._fn(*args)
        sig = self._signature(args)
        graphable = bool(args) and args[0]._data.is_cuda and \
            not _tape.is_recording() and not sig[1]
        result = None
        with self._dispatch_lock:
            if self._epoch != _STORAGE_EPOCH[0]:
                self._epoch = _STORAGE_EPOCH[0]
                for k in [k for k, e in self._cache.items()
                          if isinstance(e, _Graph)]:
                    del self._cache[k]
                self._drop_pool_if_unused()
            entry = self._cache.get(sig)
            if entry is not None and entry is not _HOST and \
                    graphable != isinstance(entry, _Graph):
                entry = None      # recorded before, replayed now (or back)
                del self._cache[sig]
                self._drop_pool_if_unused()
            if entry is not None:
                self._cache.move_to_end(sig)
                self._stats["hits"] += 1
                hit = True
            else:
                entry = self._capture(args) if graphable else True
                if entry is _HOST:
                    self._stats["host_eager"] += 1
                self._cache[sig] = entry
                self._cache.move_to_end(sig)
                self._stats["misses"] += 1
                evicted = 0
                while 0 < self._capacity < len(self._cache):
                    self._cache.popitem(last=False)
                    evicted += 1
                if evicted:
                    self._drop_pool_if_unused()
                self._stats["evictions"] += evicted
                hit = False
            if graphable and entry is not _HOST:
                result = entry.replay(args)
        with _STATS_LOCK:
            if hit:
                _GLOBAL_STATS["hits"] += 1
            else:
                _GLOBAL_STATS["misses"] += 1
                _GLOBAL_STATS["evictions"] += evicted
        if result is None:
            calls = host_calls()
            tensors, n_out, multi, aux = self._run(args)
            if host_calls() != calls:
                self._mark_host(sig)
            for h, v in zip(aux, tensors[n_out:]):
                _tape.assign(h, v)
            result = tensors[:n_out], multi
        outs, multi = result
        nds = [NDArray(o) for o in outs]
        return nds if multi else nds[0]
