"""Generation serving (counterpart of ``mxnet_tpu.serving.generation``).

- :class:`SlotKVCache` (``kvcache.py``): the preallocated
  ``(layers, slots, max_seq, heads, head_dim)`` K/V arena on the device,
  its free-list and its length counters.
- :class:`DecodeEngine` (``decode.py``): ladder-bucketed prefill (its
  attention is the CUDA flash kernel on the card), chunked prefill, the
  prefix cache's copy-on-admit and publish, and one decode step for the
  whole slot batch, sampling from a ``torch.Generator``.
- :class:`PrefixCache` (``prefix_cache.py``): token-hash-chain keyed,
  refcounted, LRU-evicted host copies of prompt K/V, so shared system
  prompts skip prefill (bitwise-equal outputs).
- :class:`SpeculativeDecoder` (``speculative.py``): a draft model proposes
  k tokens and one verify step of the target accepts the longest agreeing
  run, token-exact under greedy decoding.
- :class:`GenerationScheduler` (``scheduler.py``): continuous batching
  with deadline-aware admission, chunked prefills interleaved with decode
  steps, ``mixed``/``prefill``/``decode`` lanes, streamed tokens,
  retry around a ``generation.step`` chaos point, backpressure and drain.

Quickstart::

    from mxnet_tpu_torch.models import transformer_lm_tiny
    from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                    GenerationScheduler)
    net = transformer_lm_tiny()               # on the GPU
    sched = GenerationScheduler(DecodeEngine(net, num_slots=8, chunk=128))
    for tok in sched.submit([1, 2, 3], max_new_tokens=32).tokens():
        print(tok)
"""
from .decode import DecodeEngine, PromptTooLong
from .kvcache import CacheFull, SlotKVCache, cache_stats
from .prefix_cache import PrefixCache, prefix_stats
from .scheduler import (GenerationRequest, GenerationScheduler,
                        scheduler_stats)
from .speculative import SpeculativeDecoder

__all__ = ["SlotKVCache", "CacheFull", "DecodeEngine", "PromptTooLong",
           "GenerationScheduler", "GenerationRequest", "PrefixCache",
           "SpeculativeDecoder", "gauge", "cache_stats", "scheduler_stats",
           "prefix_stats"]


def gauge():
    """Slot-arena occupancy, the prefix-cache ledger and scheduler state
    for every live instance."""
    return {"kvcache": cache_stats(), "prefix": prefix_stats(),
            "schedulers": scheduler_stats()}
