"""Devices and contexts.

Counterpart of ``mxnet_tpu/context.py``: :class:`Context`, :func:`cpu`,
:func:`gpu`, :func:`current_context`, :func:`num_gpus` and the ``with
ctx:`` scope, each over a ``torch.device`` (``gpu(i)`` is ``cuda:i``).
The port's entry points run on the card: :func:`default_device` gives CUDA
when no device is named and :func:`current_context` gives ``gpu(0)`` when
no scope is open; both raise when there is no CUDA device. The CPU is used
only when a caller asks for it (``device="cpu"``, ``mx.cpu()``), as the
tests do; nothing falls back to it quietly.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "num_local_cpus", "default_device"]

_thread_local = threading.local()


def _no_cuda():
    return RuntimeError(
        "no CUDA device: mxnet_tpu_torch runs on the GPU; pass "
        "device='cpu' (or ctx=mx.cpu()) to run on the CPU explicitly")


class Context:
    """A device context: ``Context("cpu")`` or ``Context("gpu", i)``."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devstr2type:
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device):
        """The context of a ``torch.device`` (or a device name)."""
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", torch.cuda.current_device()
                       if device.index is None else device.index)
        if device.type == "cpu":
            return cls("cpu", 0)
        raise ValueError("no context for device %s" % device)

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    @property
    def torch_device(self):
        """The ``torch.device``: ``cpu``, or ``cuda:<device_id>`` (which
        raises when CUDA is absent)."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise _no_cuda()
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        if not hasattr(_thread_local, "stack"):
            _thread_local.stack = []
        _thread_local.stack.append(self)
        return self

    def __exit__(self, *args):
        _thread_local.stack.pop()

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this device."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_local_cpus():
    """The logical CPU devices this process takes for a mesh: the
    launcher's per-worker share ``MXTPU_LOCAL_DEVICES`` (``--total-devices``
    re-spread over a supervised world), 0 when it is not set."""
    import os
    return int(os.environ.get("MXTPU_LOCAL_DEVICES", "0") or 0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context, else ``gpu(0)``.
    Raises :class:`RuntimeError` when that is a GPU and CUDA is absent."""
    stack = getattr(_thread_local, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise _no_cuda()
    return Context("gpu", 0)


def default_device(device=None):
    """``torch.device`` for ``device`` (a name, a ``torch.device`` or a
    :class:`Context`); CUDA when ``device`` is None. A CUDA device without
    an index resolves to the current one, so that devices compare equal.

    Raises :class:`RuntimeError` when no device is named and CUDA is
    absent."""
    if isinstance(device, Context):
        return device.torch_device
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise _no_cuda()
    return torch.device("cuda", torch.cuda.current_device())
