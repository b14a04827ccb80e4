"""Operators: plain functions on tensors, the CUDA kernels' wrappers, and
the op registry that the ``nd`` namespace is generated from. Importing
this package registers the ops of ``core``, ``tensor_extra``,
``random_ops``, ``nn``, ``loss_ops``, ``rnn``, ``numpy_ops``,
``linalg_extra``, ``optim_ops``, ``image_ops``, ``generation_ops``,
``ctc``, ``transformer_ops``, ``contrib_ops``, ``contrib_misc``,
``ste_graph_ops``, ``spatial_ops``, ``detection_ops``,
``proposal_ops`` and ``quantized_ops``, then ``numpy_ops``'s aliases onto
the others (``mxnet_tpu_torch.operator`` registers ``Custom``)."""
from . import registry
from . import (contrib_misc, contrib_ops, core, ctc,  # noqa: F401
               detection_ops, flash_attention, generation_ops, image_ops,
               linalg_extra, loss_ops, nn, numpy_ops, optim_ops,
               proposal_ops, quantized_ops, random_ops, rnn, spatial_ops,
               ste_graph_ops, tensor_extra, transformer_ops)
from .registry import Op, get_op, invoke, list_ops, register

numpy_ops.register_aliases()

__all__ = ["contrib_misc", "contrib_ops", "ctc", "core", "detection_ops",
           "flash_attention", "generation_ops", "image_ops",
           "linalg_extra", "loss_ops", "nn", "numpy_ops", "optim_ops",
           "proposal_ops", "quantized_ops", "random_ops", "rnn",
           "spatial_ops",
           "ste_graph_ops", "tensor_extra", "transformer_ops",
           "registry", "register", "get_op", "list_ops", "invoke", "Op",
           "populate_namespace"]


def populate_namespace(target, names=None):
    """Put the registered ops into a module's namespace dict (the ``nd``
    namespace is generated this way, as the reference's)."""
    for name in (names or list_ops()):
        op = get_op(name)
        if op is not None:
            target[name] = op
