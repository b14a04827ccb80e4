"""KVStore: gradient aggregation and parameter sync; counterpart of
``mxnet_tpu/kvstore.py``.

``create`` makes the reference's stores: ``local`` and ``device``
aggregate the device copies pushed under a key (the role of
``CommDevice::Reduce``); ``dist_sync``, ``dist_device_sync``,
``dist_tpu_sync``, ``nccl`` and ``dist`` first sum the local copies, then
all-reduce the sum over the job's processes (``parallel._process``:
``torch.distributed``, NCCL or gloo by its rule), under the elastic
collective watchdog (``MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS``). ``rank``
and ``num_workers`` come from the process group (0 and 1 outside a job);
``barrier`` waits for every process; ``num_dead_node`` counts the ranks a
supervised generation's rendezvous records lost. A dist store made in a
process the launcher started (``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES``
> 1) joins the job (``parallel.initialize``) when no group exists yet, as
MXNet's store joins the job its launcher declared; ``DMLC_NUM_WORKER`` > 1
without a launcher's coordinator raises. ``dist_async`` raises
:class:`~.base.MXNetError`, as in the reference.

- ``push`` sums the pushed copies in list order, on the first copy's
  device (each copy compressed first, with its own residual, when
  compression is set), then across processes; with an updater
  (``set_updater``, ``set_optimizer``) the sum updates the stored value,
  without one it replaces it (the reference's ``local = merged``). A push
  to a key never initialized raises :class:`~.base.MXNetError`. ``pull``
  copies the stored value into every out (each its own buffer);
  ``pushpull`` is both; ``broadcast`` is ``init`` then ``pull``;
  ``row_sparse_pull`` gathers the named rows (each process its own row
  set) into a ``RowSparseNDArray`` out (a dense out gets the whole value).
- Gradient compression (``set_gradient_compression``), applied to each
  pushed copy with error feedback (a residual per key and copy) before any
  sum: ``{"type": "2bit", "threshold": t}`` quantizes to ``{-t, 0, +t}``;
  ``{"type": "int8"}`` is symmetric per tensor (scale ``max|x| / 127``).
  The reference's validation: unknown types and ``t <= 0`` raise.
- ``save_optimizer_states``/``load_optimizer_states`` write and read the
  reference's ``.states`` format (the updater's).
- Transient faults of a push or a pull (the ``kvstore.push`` and
  ``kvstore.pull`` chaos points) are retried by the ``retry.kvstore``
  policy (``retry_policy=False`` turns it off); a
  :class:`~.resilience.elastic.CollectiveTimeout` is never retried.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .resilience import chaos as _chaos
from .resilience import retry as _retry

__all__ = ["KVStore", "create"]

_DIST = ("dist_tpu_sync", "dist_sync", "dist_device_sync", "dist", "nccl")


def _tensor(v):
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


def _owned(t, device=None):
    out = torch.empty(t.shape, dtype=t.dtype,
                      device=t.device if device is None else device)
    with torch.no_grad():
        out.copy_(t)
    return out


class KVStore:
    """A store of keyed values over the devices of this process."""

    def __init__(self, kind="local", retry_policy=None):
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._residuals = {}
        self._is_dist = kind in _DIST
        if retry_policy is None:
            retry_policy = _retry.named_policy("retry.kvstore")
        self._retry = retry_policy or None

    # ---- identity ---------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        from .parallel import _process
        return _process.rank() if self._is_dist else 0

    @property
    def num_workers(self):
        from .parallel import _process
        return _process.size() if self._is_dist else 1

    def _across(self):
        from .parallel import _process
        return self._is_dist and _process.size() > 1

    # ---- init/push/pull ---------------------------------------------------
    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            self._store[k] = NDArray._bind(_owned(_tensor(v)))
            # a re-initialized key starts a fresh compression history
            for rk in [rk for rk in self._residuals if rk[0] == k]:
                del self._residuals[rk]

    def _reduce(self, values):
        """The pushed copies' sum, in list order, on the first's device;
        then, for a dist store in a job, the sum over the processes."""
        dev = values[0].device
        acc = values[0]
        for v in values[1:]:
            acc = acc + v.to(dev)
        if self._across():
            # a peer lost mid-all-reduce blocks here: the watchdog turns
            # the wedge into a CollectiveTimeout (off unless the deadline
            # knob is set)
            from .resilience.elastic import guard_collective
            acc = guard_collective(_cross_process_allreduce, acc,
                                   op="kvstore.allreduce")
        return acc

    def push(self, key, value, priority=0):
        if self._retry is not None:
            return self._retry.call(self._push_once, key, value)
        return self._push_once(key, value)

    def _push_once(self, key, value):
        # before anything changes: a retried fault never double-consumes
        # a residual or double-applies the updater
        _chaos.point("kvstore.push")
        keys, values = _key_value(key, value)
        grouped = {}
        for k, v in zip(keys, values):
            grouped.setdefault(k, []).append(_tensor(v))
        for k in grouped:
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
        for k, vals in grouped.items():
            if self._compression_params:
                vals = [self._compress(k, i, v) for i, v in enumerate(vals)]
            reduced = self._reduce(vals)
            stored = self._store[k]
            if self._updater is not None:
                self._apply_updater(k, reduced, stored)
            else:
                stored._set_data(_owned(reduced, stored._data.device))

    def _apply_updater(self, k, grad, stored):
        from .optimizer.optimizer import Updater
        grad = grad.to(stored._data.device)
        if isinstance(self._updater, Updater):
            self._updater(_key_int(k), grad, stored._data)
        else:
            self._updater(_key_int(k), NDArray._bind(grad), stored)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._retry is not None:
            return self._retry.call(self._pull_once, key, out)
        return self._pull_once(key, out)

    def _pull_once(self, key, out):
        _chaos.point("kvstore.pull")
        keys, outs = _key_value(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            src = self._store[k]._data
            with torch.no_grad():
                o._data.copy_(src.to(o._data.device, o._data.dtype))

    def pushpull(self, key, value, out=None, priority=0):
        """``push`` then ``pull`` (into ``value`` when ``out`` is
        None)."""
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (deduplicated and sorted) into a
        ``RowSparseNDArray`` out; a dense out gets the whole value. A row
        id out of range raises."""
        if row_ids is None or out is None:
            return self.pull(key, out=out, priority=priority)
        from .ndarray.sparse import RowSparseNDArray
        keys, outs = _key_value(key, out)
        if isinstance(row_ids, (list, tuple)) and \
                len(row_ids) == len(keys) and \
                all(hasattr(r, "__len__") or hasattr(r, "shape")
                    for r in row_ids):
            rids = list(row_ids)
        else:
            rids = [row_ids] * len(keys)
        for k, o, rid in zip(keys, outs, rids):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            if not isinstance(o, RowSparseNDArray):
                self.pull(k, out=o, priority=priority)
                continue
            src = self._store[k]._data
            idx = np.unique(np.asarray(
                rid.asnumpy() if hasattr(rid, "asnumpy") else rid
            ).astype(np.int64).ravel())
            if idx.size and (idx[0] < 0 or idx[-1] >= src.shape[0]):
                raise MXNetError(
                    "row_sparse_pull: row id out of range for key %s "
                    "(shape %s, ids [%d, %d])"
                    % (k, tuple(src.shape), int(idx[0]), int(idx[-1])))
            rows = torch.from_numpy(idx).to(o._device_)
            o._store((src.to(o._device_)[rows].to(o._dtype_), rows))
            o._dense_cache = None
            o._shape_ = tuple(src.shape)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    # ---- optimizer --------------------------------------------------------
    def set_updater(self, updater):
        """``updater(key, grad, stored)`` runs at each push (a port
        ``Updater`` takes the tensors, another callable NDArrays)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        from . import optimizer as opt_mod
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def is_capable(self, capability):
        return capability.lower() == "optimizer"

    # ---- compression ------------------------------------------------------
    def set_gradient_compression(self, compression_params):
        """``{"type": "2bit", "threshold": t}`` or ``{"type": "int8"}``
        (``"none"``/None: off); resets every residual."""
        if compression_params is not None:
            ctype = compression_params.get("type")
            if ctype not in ("2bit", "int8", "none", None):
                raise MXNetError("unsupported gradient compression type %r"
                                 % (ctype,))
            if ctype == "2bit":
                t = float(compression_params.get("threshold", 0.5))
                if t <= 0:
                    raise MXNetError(
                        "2bit compression threshold must be > 0, got %r"
                        % (t,))
        self._compression_params = compression_params
        self._residuals = {}

    def _compress(self, k, slot, v):
        """One pushed copy quantized with error feedback: the dequantized
        payload (what would cross the wire)."""
        params = self._compression_params
        ctype = params.get("type")
        if ctype in (None, "none"):
            return v
        res = self._residuals.get((k, slot))
        x = v if res is None else v + res
        if ctype == "2bit":
            t = torch.tensor(float(params.get("threshold", 0.5)),
                             dtype=v.dtype, device=v.device)
            zero = torch.zeros_like(x)
            deq = torch.where(x >= t, t, torch.where(x <= -t, -t, zero))
        else:
            scale = torch.clamp_min(torch.amax(torch.abs(x)),
                                    1e-12) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            deq = q.to(v.dtype) * scale.to(v.dtype)
        self._residuals[(k, slot)] = x - deq
        return deq

    # ---- control ----------------------------------------------------------
    def barrier(self):
        """Every worker of the job is here (a no-op outside one), under the
        collective watchdog."""
        if self._across():
            from .parallel import _process
            from .resilience.elastic import guard_collective
            guard_collective(_process.barrier, op="kvstore.barrier")

    def _barrier(self):
        self.barrier()

    def send_command_to_servers(self, head, body):
        """No server processes."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("save_optimizer_states: no updater is set")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("load_optimizer_states: no updater is set")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    @property
    def num_dead_node(self):
        """Ranks of this supervised generation whose heartbeats stopped
        (0 outside ``--supervise``)."""
        if not self._is_dist:
            return 0
        from .resilience.elastic import dead_in_job
        return len(dead_in_job())


def _cross_process_allreduce(x):
    """The sum of ``x`` over the job's processes (one collective; gloo
    stages a CUDA tensor through the host)."""
    from .parallel import _process
    return _process.all_reduce(x)


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _key_value(key, value):
    if not isinstance(key, (list, tuple)):
        if isinstance(value, (list, tuple)):
            return [str(key)] * len(value), list(value)
        return [str(key)], [value]
    keys, values = [], []
    for k, v in zip(key, value):
        if isinstance(v, (list, tuple)):
            keys.extend([str(k)] * len(v))
            values.extend(v)
        else:
            keys.append(str(k))
            values.append(v)
    return keys, values


def _join_job(name):
    """A dist store's process group: joined from the launcher's environment
    when none exists; a ``DMLC_NUM_WORKER`` of several workers without
    one raises."""
    import os
    from .parallel import _process
    if _process.is_initialized():
        return
    if int(os.environ.get("MXTPU_NUM_PROCESSES", "1") or 1) > 1 and \
            os.environ.get("MXTPU_COORDINATOR"):
        _process.initialize()
        return
    n = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    if n > 1:
        raise MXNetError(
            "kvstore %r: DMLC_NUM_WORKER declares %d workers but this "
            "process has joined no job: start the workers with python -m "
            "mxnet_tpu_torch.tools.launch, or call parallel.initialize() "
            "first" % (name, n))


def create(name="local"):
    """A :class:`KVStore` of type ``name``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device"):
        return KVStore(name)
    if name in _DIST:
        _join_job(name)
        return KVStore("dist_tpu_sync" if name == "dist" else name)
    if name == "dist_async":
        raise MXNetError(
            "dist_async is not supported: asynchronous parameter-server "
            "updates are not part of this package (use dist_sync)")
    raise MXNetError("unknown KVStore type %s" % name)
