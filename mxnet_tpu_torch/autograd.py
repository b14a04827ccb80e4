"""Autograd: the imperative differentiation API over torch's autograd.

Counterpart of ``mxnet_tpu/autograd.py``: ``record``, ``pause``,
``train_mode``, ``predict_mode``, ``is_recording``, ``is_training``,
``mark_variables``, ``backward``, ``grad`` and ``Function``. The reference
records a tape of pure functions and differentiates it with ``jax.vjp``;
here ops build torch's autograd graph while ``record()`` is on (they run
with torch's grad mode on only then), ``backward`` is
``torch.autograd.backward`` from the heads, and a leaf's ``grad_req``
(``write``/``add``/``null``) is kept by the hooks of
``_tape.hook_grad_req``. ``Function`` is a ``torch.autograd.Function``
whose forward and backward are the user's NDArray code.
"""
from __future__ import annotations

import torch

from . import _tape
from ._tape import is_recording, is_training
from .ndarray.ndarray import NDArray

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "set_recording", "set_training"]


def set_recording(is_rec):
    return _tape.set_recording(is_rec)


def set_training(train):
    return _tape.set_training(train)


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_rec = is_record
        self._enter_train = train_mode_
        self._prev_rec = None
        self._prev_train = None

    def __enter__(self):
        if self._enter_rec is not None:
            self._prev_rec = _tape.set_recording(self._enter_rec)
        if self._enter_train is not None:
            self._prev_train = _tape.set_training(self._enter_train)
        return self

    def __exit__(self, *a):
        if self._enter_rec is not None:
            _tape.set_recording(self._prev_rec)
        if self._enter_train is not None:
            _tape.set_training(self._prev_train)


def record(train_mode=True):
    """Scope: ops executed inside are recorded for backward."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as leaves whose gradients go into ``gradients``."""
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        if req != "null":
            v._data.grad = g._data
            g._data = v._data.grad
            v._grad = g


def _heads(heads, head_grads):
    if isinstance(heads, NDArray):
        heads = [heads]
        if isinstance(head_grads, NDArray):
            head_grads = [head_grads]
    tensors, grads = [], []
    for i, h in enumerate(heads):
        if not h._data.requires_grad:
            raise ValueError(
                "cannot run backward: head is not part of a recorded "
                "computation (did you call it under autograd.record()?)")
        tensors.append(h._data)
        g = None if head_grads is None else head_grads[i]
        if g is None:
            grads.append(torch.ones_like(h._data))
        else:
            grads.append(g._data if isinstance(g, NDArray)
                         else torch.as_tensor(g, device=h._data.device))
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (weighted by ``head_grads``, ones when None)
    into every marked leaf they reach."""
    tensors, grads = _heads(heads, head_grads)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned (the
    variables' ``.grad`` are left alone). A variable the heads do not
    reach gets zeros. With ``create_graph`` the results are recorded, for
    higher-order gradients."""
    if isinstance(variables, NDArray):
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise ValueError("variable passed to grad() must have "
                             "attach_grad/mark_variables called or be used "
                             "under record()")
    tensors, grads = _heads(heads, head_grads)
    outs = torch.autograd.grad(
        tensors, [v._data for v in variables], grads,
        retain_graph=create_graph if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v._data.detach()) if g is None else
                    (g if create_graph else g.detach()))
            for v, g in zip(variables, outs)]


class Function:
    """Custom differentiable function: subclass, define ``forward`` and
    ``backward`` over NDArrays; under ``record()`` the call is one node of
    torch's graph whose backward runs the user's ``backward``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if not _tape.is_recording():
            return self.forward(*inputs)
        fn = self
        multi_box = []

        class _Node(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *vals):
                with pause(_tape.is_training()):
                    outs = fn.forward(*[NDArray(v) for v in vals])
                multi_box.append(isinstance(outs, (list, tuple)))
                outs = outs if multi_box[0] else [outs]
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with pause(_tape.is_training()):
                    igrads = fn.backward(*[NDArray(g) for g in gs])
                igrads = igrads if isinstance(igrads, (list, tuple)) \
                    else [igrads]
                return tuple(None if ig is None else ig._data
                             for ig in igrads)

        outs = _Node.apply(*[a._data for a in inputs])
        results = [NDArray(o) for o in outs]
        return results if multi_box[0] else results[0]
