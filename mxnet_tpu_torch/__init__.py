"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, held against it module by module (the
JAX package is the reference; the port imports none of it). Its module
layout and names follow ``mxnet_tpu``, so each module's counterpart is
found by name. Entry points run on the GPU: with no ``device`` they take
CUDA and raise when there is none; ``device="cpu"`` asks for the CPU
explicitly, where every CUDA kernel's wrapper computes its plain PyTorch
version.

This slice carries TransformerLM generation serving:
``GenerationScheduler(DecodeEngine(lm))`` behind
``ModelServer(None, generator=sched)``, with a hand-written CUDA
flash-attention forward (``csrc/flash_attn_fwd.cu``) under every prefill.
"""
from . import config, context, convert, models, ops, serving
from .context import default_device

__version__ = "0.1.0"

__all__ = ["config", "context", "convert", "models", "ops", "serving",
           "default_device"]
