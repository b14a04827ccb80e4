"""Training steps (counterpart of ``mxnet_tpu.parallel``): the
single-device ``ShardedTrainer``, ``functionalize`` and the functional
optimizers."""
from .functional import functional_optimizer, functionalize
from .trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "functional_optimizer", "functionalize"]
