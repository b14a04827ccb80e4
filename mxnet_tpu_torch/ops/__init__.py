"""Operators: plain functions on tensors, the CUDA kernels' wrappers, and
the op registry that the ``nd`` namespace is generated from. Importing
this package registers the ops of ``core``, ``tensor_extra``,
``random_ops``, ``nn``, ``loss_ops`` and ``rnn``."""
from . import registry
from . import (core, ctc, flash_attention, generation_ops, loss_ops,  # noqa: F401
               nn, random_ops, rnn, tensor_extra)
from .registry import Op, get_op, invoke, list_ops, register

__all__ = ["ctc", "core", "flash_attention", "generation_ops", "loss_ops",
           "nn", "random_ops", "rnn", "tensor_extra",
           "registry", "register", "get_op", "list_ops", "invoke", "Op",
           "populate_namespace"]


def populate_namespace(target, names=None):
    """Put the registered ops into a module's namespace dict (the ``nd``
    namespace is generated this way, as the reference's)."""
    for name in (names or list_ops()):
        op = get_op(name)
        if op is not None:
            target[name] = op
