"""Generation serving (counterpart of ``mxnet_tpu.serving.generation``).

- :class:`SlotKVCache` (``kvcache.py``): the preallocated
  ``(layers, slots, max_seq, heads, head_dim)`` K/V arena on the device,
  its free-list and its length counters.
- :class:`DecodeEngine` (``decode.py``): ladder-bucketed prefill (its
  attention is the CUDA flash kernel on the card) and one decode step for
  the whole slot batch, sampling from a ``torch.Generator``.
- :class:`GenerationScheduler` (``scheduler.py``): continuous batching
  with deadline-aware admission, streamed tokens, backpressure and drain.

Quickstart::

    from mxnet_tpu_torch.models import transformer_lm_tiny
    from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                    GenerationScheduler)
    net = transformer_lm_tiny()               # on the GPU
    sched = GenerationScheduler(DecodeEngine(net, num_slots=8))
    for tok in sched.submit([1, 2, 3], max_new_tokens=32).tokens():
        print(tok)
"""
from .decode import DecodeEngine, PromptTooLong
from .kvcache import CacheFull, SlotKVCache
from .scheduler import GenerationRequest, GenerationScheduler

__all__ = ["SlotKVCache", "CacheFull", "DecodeEngine", "PromptTooLong",
           "GenerationScheduler", "GenerationRequest"]
