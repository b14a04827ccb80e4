"""Training steps (counterpart of ``mxnet_tpu.parallel``): the
single-device ``ShardedTrainer`` (with ``step_stream``), ``functionalize``,
the functional optimizers and ``DeviceFeed``."""
from .datafeed import DeviceFeed, feed_stats
from .functional import functional_optimizer, functionalize
from .trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "functional_optimizer", "functionalize",
           "DeviceFeed", "feed_stats"]
