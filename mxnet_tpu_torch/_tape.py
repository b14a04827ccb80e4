"""Recording state, grad_req hooks and aux-state sinks.

Counterpart of ``mxnet_tpu/_tape.py``. The reference records a tape of
pure JAX functions and differentiates it with ``jax.vjp``; the port records
nothing itself: torch's autograd builds the graph. What stays here:

- the thread-local recording and training flags (``autograd.record()``,
  ``pause()``, ``train_mode()``); ops run with torch's grad mode on only
  while recording (``ops.registry.invoke``, ``gluon.Block.__call__``);
- :func:`hook_grad_req`, which gives a leaf tensor the reference's
  ``grad_req`` on top of torch's accumulating ``.grad``: ``"write"``
  leaves each backward pass's own gradient (a tensor hook keeps the pass's
  gradient aside, and a post-accumulate hook puts it in place of the sum),
  ``"add"`` sums the passes. ``Parameter`` and ``NDArray.attach_grad``
  both use it;
- the aux-state sinks (BatchNorm's moving statistics): a layer calls
  :func:`aux_write`; eagerly the handle is rebound at once, and inside a
  ``CachedOp`` the pair is collected so that a captured graph's replay
  writes the new value back.
"""
from __future__ import annotations

import threading
import weakref

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "hook_grad_req", "push_aux_sink", "pop_aux_sink", "aux_write",
           "assign"]

_state = threading.local()


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_recording(flag: bool) -> bool:
    prev = is_recording()
    _state.recording = bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev = is_training()
    _state.training = bool(flag)
    return prev


# ---- grad_req on torch's accumulating .grad --------------------------------

def hook_grad_req(tensor, owner):
    """Give the leaf ``tensor`` ``owner._grad_req`` semantics (read at each
    backward pass). ``owner`` keeps the pass's gradient in a
    ``_pass_grad`` dict; the hooks hold it weakly. Idempotent per
    tensor."""
    if getattr(tensor, "_mx_hooked", False):
        return
    ref = weakref.ref(owner)
    tensor.register_hook(lambda g, t=weakref.ref(tensor): _keep(ref, t, g))
    tensor.register_post_accumulate_grad_hook(lambda t: _write(ref, t))
    tensor._mx_hooked = True


def _keep(ref, tref, grad):
    owner = ref()
    if owner is not None and owner._grad_req == "write":
        owner._pass_grad[id(tref())] = grad


def _write(ref, tensor):
    """After torch's accumulation: under ``grad_req="write"`` the gradient
    is this pass's alone, as in the reference. It is written into the
    gradient tensor in place where that can be done, so a handle held on
    the gradient sees it."""
    owner = ref()
    if owner is None:
        return
    grad = owner._pass_grad.pop(id(tensor), None)
    if grad is None or owner._grad_req != "write":
        return
    cur = tensor.grad
    if cur is not None and cur is not grad and not cur.requires_grad \
            and not grad.requires_grad and cur.shape == grad.shape:
        cur.copy_(grad)
    else:
        tensor.grad = grad


# ---- aux-state sink --------------------------------------------------------

def push_aux_sink():
    if not hasattr(_state, "aux_sinks"):
        _state.aux_sinks = []
    sink = []
    _state.aux_sinks.append(sink)
    return sink


def pop_aux_sink():
    return _state.aux_sinks.pop()


def aux_write(handle, value):
    """Write ``value`` (a tensor) into the NDArray ``handle``: at once
    eagerly, through the innermost sink inside a ``CachedOp``,
    ``functionalize`` or a ``ShardedTrainer`` step."""
    sinks = getattr(_state, "aux_sinks", None)
    if sinks:
        sinks[-1].append((handle, value))
    else:
        assign(handle, value)


def assign(handle, value):
    """Rebind ``handle`` to ``value``; a handle bound to a module's tensor
    (a layer's moving statistics) takes the value in place."""
    if getattr(handle, "_bound", False):
        handle._set_data(value)
    else:
        handle._data = value
