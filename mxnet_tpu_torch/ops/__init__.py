"""Operators: plain functions on tensors, the CUDA kernels' wrappers, and
the op registry that the ``nd`` namespace is generated from. Importing
this package registers the ops of ``core``, ``tensor_extra``,
``random_ops``, ``nn``, ``loss_ops``, ``rnn``, ``numpy_ops``,
``linalg_extra``, ``optim_ops`` and ``image_ops``, then ``numpy_ops``'s
aliases onto the others."""
from . import registry
from . import (core, ctc, flash_attention, generation_ops,  # noqa: F401
               image_ops, linalg_extra, loss_ops, nn, numpy_ops, optim_ops,
               random_ops, rnn, tensor_extra)
from .registry import Op, get_op, invoke, list_ops, register

numpy_ops.register_aliases()

__all__ = ["ctc", "core", "flash_attention", "generation_ops", "image_ops",
           "linalg_extra", "loss_ops", "nn", "numpy_ops", "optim_ops",
           "random_ops", "rnn", "tensor_extra",
           "registry", "register", "get_op", "list_ops", "invoke", "Op",
           "populate_namespace"]


def populate_namespace(target, names=None):
    """Put the registered ops into a module's namespace dict (the ``nd``
    namespace is generated this way, as the reference's)."""
    for name in (names or list_ops()):
        op = get_op(name)
        if op is not None:
            target[name] = op
