"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, held against it module by module (the
JAX package is the reference; the port imports none of it). Its module
layout and names follow ``mxnet_tpu``, so each module's counterpart is
found by name. Entry points run on the GPU: with no ``device`` they take
CUDA and raise when there is none; ``device="cpu"`` asks for the CPU
explicitly, where every CUDA kernel's wrapper computes its plain PyTorch
version.

The port carries two paths of TransformerLM so far:

- generation serving: ``GenerationScheduler(DecodeEngine(lm))`` behind
  ``ModelServer(None, generator=sched)``, with a hand-written CUDA
  flash-attention forward (``csrc/flash_attn_fwd.cu``) under every prefill;
- training: ``parallel.ShardedTrainer(lm, gluon.loss.SoftmaxCrossEntropyLoss(),
  "adam", ...)`` on one device, whose backward runs the hand-written CUDA
  flash-attention backward kernels (``csrc/flash_attn_bwd.cu``);
- the Gluon training surface: ``initializer``, ``lr_scheduler``, every
  ``optimizer``, ``gluon.collect_params`` and the eager ``gluon.Trainer``,
  ``gluon.utils.clip_global_norm`` and every ``gluon.loss``.
"""
from . import (config, context, convert, gluon, initializer, lr_scheduler,
               models, ops, optimizer, parallel, random, serving)
from .context import default_device

__version__ = "0.2.0"

__all__ = ["config", "context", "convert", "gluon", "initializer",
           "lr_scheduler", "models", "ops", "optimizer", "parallel", "random",
           "serving", "default_device"]
