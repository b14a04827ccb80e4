"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, held against it module by module (the
JAX package is the reference; the port imports none of it). Its module
layout and names follow ``mxnet_tpu``, so each module's counterpart is
found by name. Entry points run on the GPU: with no ``device`` (or
``ctx``) they take CUDA and raise when there is none; ``device="cpu"`` or
``ctx=mx.cpu()`` asks for the CPU explicitly, where every CUDA kernel's
wrapper computes its plain PyTorch version.

What the port carries so far:

- the core runtime: ``Context`` (``cpu()``, ``gpu(i)``), ``NDArray`` and
  the ``nd`` namespace generated from the op registry, ``autograd``
  (``record``, ``backward``, ``grad``, ``Function``) over torch's
  autograd, ``CachedOp`` (one CUDA graph per input signature), ``engine``
  and ``runtime``;
- Gluon: ``Block``/``HybridBlock`` (``torch.nn.Module``s, ``hybridize``),
  ``Parameter`` with deferred initialization, ``initializer``,
  ``lr_scheduler``, every ``optimizer``, the eager ``gluon.Trainer``,
  ``gluon.utils.clip_global_norm`` and every ``gluon.loss``;
- TransformerLM and BERT (``models``), trained with
  ``parallel.ShardedTrainer`` or the Gluon loop, whose attention runs the
  hand-written CUDA flash-attention kernels (``csrc/flash_attn_fwd.cu``,
  ``csrc/flash_attn_bwd.cu``);
- serving: ``/predict`` (``ModelServer(engine)`` over a
  ``DynamicBatcher`` over an ``InferenceEngine``) and ``/generate``
  (``GenerationScheduler(DecodeEngine(lm))``, its programs through
  ``CachedOp``);
- the data path: ``recordio``, ``io`` (``NDArrayIter``,
  ``ImageRecordIter`` on the native pump built from ``csrc/io/``),
  ``image``, ``gluon.data`` (datasets, samplers, ``DataLoader``, vision
  transforms) and ``parallel.DeviceFeed`` (pinned staging on a CUDA
  stream) under ``ShardedTrainer.step_stream``;
- the RNN family: the fused ``RNN`` op (cuDNN on the card),
  ``gluon.rnn`` (the cells, ``RNN``/``LSTM``/``GRU``), ``gluon.contrib``
  (its layers and cells, the ``Estimator``), ``rnn``
  (``BucketSentenceIter``), ``metric`` and the word language model
  (``models.RNNModel``);
- the symbolic and legacy frontends: ``sym``/``symbol`` (``Symbol``,
  ``Executor``: inference forwards through ``CachedOp``), ``mod``/
  ``module`` (``Module``, ``BucketingModule``, ``SequentialModule``,
  ``PythonModule``), ``model`` (checkpoints, ``FeedForward``),
  ``callback``, ``monitor``, ``viz``, ``gluon.SymbolBlock`` with
  ``HybridBlock.export``, and ``serving.InferenceEngine.load``;
- the first part of the op corpus: the reference's ``ops/core.py``,
  ``ops/tensor_extra.py`` and ``ops/random_ops.py`` whole (ordering,
  ``linalg_*``, the multi-tensor checks, every sampler and density),
  ``random``'s samplers, ``nd.random``, ``nd.linalg`` and
  ``test_utils``;
- the numpy frontends: ``np`` (``numpy``: ``ndarray`` and the functions,
  in the reference's dtypes; ``np.linalg``, ``np.random``) and ``npx``
  (``numpy_extension``), over the second part of the op corpus
  (``ops/numpy_ops.py``, the rest of ``ops/nn.py``, ``optim_ops``,
  ``linalg_extra``, ``image_ops``);
- the rest of the op corpus: the contrib, control-flow, spatial and
  detection families; ``operator`` (Python ``CustomOp``s as the ``Custom``
  op, ``nd.Custom``, ``sym.Custom``), the INT8 family with
  ``contrib.quantization`` (``quantize_net``, ``quantize_model``), sparse
  storage (``nd.sparse``: ``CSRNDArray``, ``RowSparseNDArray``, ``dot``,
  SGD's lazy update) and ``contrib.graph``;
- distribution inside one process: ``kvstore``/``kv`` (``local``,
  ``device``), and ``parallel``'s meshes of logical devices,
  ``ShardedTrainer`` over a mesh (``tp_rules``, sharding plans), ring
  attention, the MoE FFN, the pipeline, the planner and checkpoints
  (``models.MoETransformerLM``); ``gluon.Trainer``, ``Module`` and
  ``model.FeedForward`` over several contexts; ``sym``'s subgraph
  backends and ``group2ctx``;
- a job of several processes: ``parallel.initialize``/``rank``/``size``
  over ``torch.distributed`` (NCCL or gloo by rule), the ``dist_*`` and
  ``nccl`` kvstores summing across processes, and the launcher
  (``python -m mxnet_tpu_torch.tools.launch``, with ``--supervise``);
- training resilience: ``resilience.resume`` (``resumable_fit``),
  ``resilience.guardrails`` (``GuardedStep``) and ``resilience.elastic``
  (preemption, membership, ``elastic_fit``, the collective watchdog).
"""
from . import (autograd, base, callback, config, context, contrib, convert,
               engine, gluon, image, initializer, io, kvstore, lr_scheduler,
               metric,
               model, models, module, monitor, ndarray, numpy,
               numpy_extension, operator, ops, optimizer, parallel, random,
               recordio, rnn, runtime, serving, symbol, test_utils,
               visualization)
from .base import MXNetError
from .cached_op import CachedOp
from .context import (Context, cpu, current_context, default_device, gpu,
                      num_gpus)

nd = ndarray
kv = kvstore
init = initializer
sym = symbol
mod = module
viz = visualization
np = numpy
npx = numpy_extension

__version__ = "0.3.0"

__all__ = ["autograd", "base", "callback", "config", "context", "contrib",
           "convert",
           "engine", "gluon", "image", "initializer", "init", "io",
           "lr_scheduler", "metric", "mod", "model", "models", "module",
           "monitor", "nd", "ndarray", "np", "npx", "numpy",
           "numpy_extension", "operator", "ops", "optimizer", "parallel",
           "random", "recordio", "rnn", "runtime", "serving", "sym",
           "symbol", "test_utils", "visualization", "viz", "CachedOp", "Context",
           "MXNetError", "cpu", "gpu", "current_context", "default_device",
           "num_gpus"]
