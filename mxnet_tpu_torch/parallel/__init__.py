"""Parallelism and distribution inside one process (counterpart of
``mxnet_tpu.parallel``): meshes of logical devices and their collectives,
``ShardedTrainer`` on one device or over a mesh (``step_stream``,
``shard_params``, sharding plans), ``DeviceFeed``, ring attention, the
expert-parallel MoE FFN, the pipeline, the sharding planner and
checkpoints; and a job of several processes (``initialize``, ``rank``,
``size``, ``backend``: ``_process.py``, which the ``dist_*`` kvstores and
the launcher use)."""
from ._process import backend, initialize, rank, size
from .checkpoint import restore_checkpoint, save_checkpoint
from .datafeed import DeviceFeed, feed_stats
from .functional import functional_optimizer, functionalize, shard_params
from .mesh import (Mesh, MeshConfig, NamedSharding, PartitionSpec,
                   ShardedTensor, all_gather, all_reduce, all_to_all,
                   batch_sharding, current_mesh, make_mesh, ppermute,
                   reduce_scatter, replicated, set_mesh)
from .moe import init_moe_params, moe_ffn, moe_ffn_sharded
from .pipeline import pipeline_apply, pipeline_spmd
from .planner import (ModelProfile, PlanError, PlanMismatchError,
                      ShardingPlan, plan_serving, plan_sharding)
from .ring_attention import ring_attention, ring_attention_sharded
from .trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "functional_optimizer", "functionalize",
           "shard_params", "DeviceFeed", "feed_stats", "Mesh", "MeshConfig",
           "NamedSharding", "PartitionSpec", "ShardedTensor", "make_mesh",
           "current_mesh", "set_mesh", "replicated", "batch_sharding",
           "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "ppermute", "save_checkpoint", "restore_checkpoint",
           "ring_attention", "ring_attention_sharded", "pipeline_apply",
           "pipeline_spmd", "moe_ffn", "moe_ffn_sharded", "init_moe_params",
           "ModelProfile", "PlanError", "PlanMismatchError", "ShardingPlan",
           "plan_sharding", "plan_serving", "initialize", "rank", "size",
           "backend"]

