"""The process group of a job of several processes (counterpart of the
reference's ``jax.distributed`` bootstrap, ``parallel/__init__.py:24-42``).

:func:`initialize` joins the job a launcher declared: it reads
``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES`` and ``MXTPU_PROCESS_ID``
(``python -m mxnet_tpu_torch.tools.launch`` sets them) when no arguments
are given, and calls ``torch.distributed.init_process_group`` over a TCP
store at the coordinator's address.

The backend is a rule, decided before the group is made and printed:

- ``nccl`` when CUDA is present and every rank on this host has a device
  of its own (``LOCAL_WORLD_SIZE`` ranks, the launcher's count of the
  ranks it placed on this host, at most ``torch.cuda.device_count()``);
  each rank then works on ``cuda:LOCAL_RANK``;
- ``gloo`` otherwise: the CPU, and several ranks on one card (NCCL
  refuses two ranks on one device). A CUDA tensor is staged through the
  host for a gloo collective.

Nothing turns an NCCL failure into gloo. :func:`all_reduce` and
:func:`barrier` are the collectives the kvstore runs (under the elastic
watchdog); :func:`stats` counts their calls, bytes and host seconds.
"""
from __future__ import annotations

import datetime
import os
import threading
import time

import torch

__all__ = ["initialize", "rank", "size", "backend", "choose_backend",
           "all_reduce", "barrier", "destroy", "is_initialized", "stats"]

_TIMEOUT_S = 300.0      # a collective's (and the rendezvous') bound
_lock = threading.Lock()
_state = {"backend": None, "local_rank": 0}
_stats = {"allreduce_calls": 0, "allreduce_bytes": 0, "allreduce_s": 0.0,
          "barriers": 0}


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _env(name, value, cast=str):
    if value is not None:
        return cast(value)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        raise RuntimeError(
            "parallel.initialize: no %s given and %s is not set (start the "
            "workers with python -m mxnet_tpu_torch.tools.launch, or pass "
            "coordinator_address, num_processes and process_id)"
            % (name.lower().replace("mxtpu_", ""), name))
    return cast(raw)


def choose_backend(local_world_size=None):
    """``"nccl"`` when CUDA is present and each of this host's
    ``local_world_size`` ranks (``LOCAL_WORLD_SIZE``, else 1) has a device
    of its own; ``"gloo"`` otherwise."""
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= int(local_world_size):
        return "nccl"
    return "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the job: ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` with ``num_processes`` ranks, this one
    ``process_id``, on :func:`choose_backend`'s backend. Arguments left
    None come from the launcher's ``MXTPU_*`` variables. Returns the
    backend's name."""
    dist = _dist()
    addr = _env("MXTPU_COORDINATOR", coordinator_address)
    world = _env("MXTPU_NUM_PROCESSES", num_processes, int)
    rank_ = _env("MXTPU_PROCESS_ID", process_id, int)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = choose_backend()
    with _lock:
        if is_initialized():
            raise RuntimeError("parallel.initialize: the process group is "
                               "already initialized (backend %s)"
                               % _state["backend"])
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(local)
            kwargs["device_id"] = torch.device("cuda", local)
        dist.init_process_group(
            backend, init_method="tcp://%s" % addr, world_size=world,
            rank=rank_, timeout=datetime.timedelta(seconds=_TIMEOUT_S),
            **kwargs)
        _state["backend"] = backend
        _state["local_rank"] = local
    print("parallel.initialize: rank %d of %d, backend %s (%s), "
          "coordinator %s" % (rank_, world, backend,
                              "a CUDA device for each of this host's ranks"
                              if backend == "nccl" else
                              "the CPU, or ranks sharing a card",
                              addr), flush=True)
    return backend


def rank():
    """This process's rank (0 outside a job)."""
    return _dist().get_rank() if is_initialized() else 0


def size():
    """The job's number of processes (1 outside a job)."""
    return _dist().get_world_size() if is_initialized() else 1


def backend():
    """The backend :func:`initialize` chose (None outside a job)."""
    return _state["backend"] if is_initialized() else None


def all_reduce(t):
    """The sum of ``t`` over the job's processes, as a new tensor on
    ``t``'s device (gloo stages a CUDA tensor through the host)."""
    dist = _dist()
    t0 = time.perf_counter()
    staged = _state["backend"] == "gloo" and t.device.type != "cpu"
    buf = t.detach().to("cpu", copy=True) if staged \
        else t.detach().clone()
    dist.all_reduce(buf)
    out = buf.to(t.device) if staged else buf
    if out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    with _lock:
        _stats["allreduce_calls"] += 1
        _stats["allreduce_bytes"] += t.numel() * t.element_size()
        _stats["allreduce_s"] += time.perf_counter() - t0
    return out


def barrier():
    """Every process of the job is here."""
    dist = _dist()
    if _state["backend"] == "nccl":
        dist.barrier(device_ids=[_state["local_rank"]])
    else:
        dist.barrier()
    with _lock:
        _stats["barriers"] += 1


def destroy():
    """Leave the job (``destroy_process_group``)."""
    if is_initialized():
        _dist().destroy_process_group()
    _state["backend"] = None


def stats():
    with _lock:
        return dict(_stats)
