"""Generation operators: seeded sampling and KV-cache writes.

Counterpart of ``mxnet_tpu/ops/generation_ops.py``.

- Sampling takes an explicit ``torch.Generator``: the same generator state
  and the same logits give the same tokens. (It does not give the JAX
  package's tokens: ``jax.random`` and ``torch.Generator`` draw different
  numbers from one seed. Greedy rows match exactly.)
- Per-row ``temperature <= 0`` selects greedy for that row. The sampler
  never reads a value back to the host, so a CUDA graph can hold it: it
  draws one exponential per logit for every call, greedy rows too, and
  takes ``argmax(p / q)`` (``torch.multinomial``'s own one-sample path,
  without that path's host-side checks).
- The cache writes update their target in place and return it: the
  reference returns a new buffer (XLA makes that an in-place
  ``dynamic_update_slice``); here the in-place write is what saves
  copying the arena. An arena index may be a Python int or a one-element
  device tensor; a tensor index keeps the write (and the read, which is
  then a copy) free of host values, as a captured graph needs.

The registry ops (``_contrib_sample_greedy`` ... ``_contrib_arena_update``,
each with its bare alias, as the reference registers them) are pure, as
the reference's: the samplers bind the invoke-time ``key`` words and draw
from :func:`.random_ops.generator_for`, token ids come out int32, and the
cache writes update a copy.
"""
from __future__ import annotations

import torch

from .registry import bind_key, register

__all__ = ["sample_greedy", "sample_temperature", "sample_top_k", "generation_sample",
           "kv_cache_update", "arena_update", "arena_slice"]

_NEG_INF = -1e9  # large-negative fill that stays finite in fp16/bf16


def sample_greedy(logits):
    """Argmax over the last axis (the first maximum on ties, as
    ``jnp.argmax``): token ids of shape ``logits.shape[:-1]``."""
    return torch.argmax(logits, dim=-1)


def sample_temperature(logits, generator=None, temperature=1.0):
    """Categorical sample from ``softmax(logits / temperature)``.

    ``temperature`` is a scalar or a per-row ``(B,)`` tensor over
    ``logits (B, V)``; rows with ``temperature <= 0`` take the argmax (the
    first maximum on ties, as ``jnp.argmax``). It draws for every row,
    greedy ones too, so each call advances ``generator`` by the same
    amount."""
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device)
    greedy = torch.argmax(logits, dim=-1)
    cold = temp <= 0.0
    t = temp[:, None] if temp.dim() == 1 else temp
    probs = torch.softmax(logits.float() / t.clamp_min(1e-6), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    sampled = torch.argmax(probs / q, dim=-1)
    return torch.where(cold, greedy, sampled)


def _top_k_filter(logits, k):
    """Keep the k largest logits per row; fill the rest with -1e9."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, _NEG_INF))


def sample_top_k(logits, generator=None, k=0, temperature=1.0):
    """Top-k filtered temperature sampling (``k <= 0``: no filter)."""
    return sample_temperature(_top_k_filter(logits, int(k)), generator,
                              temperature)


def generation_sample(logits, generator, temperatures, k=0):
    """The serving sampler: per-row temperatures ``(B,)`` over ``logits
    (B, V)`` (0 = greedy for that row) with an optional top-k."""
    return sample_top_k(logits, generator, k=int(k), temperature=temperatures)


def kv_cache_update(cache, new, positions):
    """Write ``new (B, n, ...)`` into ``cache (B, S, ...)`` at per-row
    offsets ``positions (B,)`` along axis 1, in place; returns ``cache``.
    Offsets clamp to ``[0, S - n]`` as ``dynamic_update_slice`` does."""
    B, n = new.shape[0], new.shape[1]
    pos = torch.as_tensor(positions, device=cache.device).long().reshape(B)
    pos = pos.clamp(0, cache.shape[1] - n)
    rows = torch.arange(B, device=cache.device).reshape(B, 1)
    cols = pos.reshape(B, 1) + torch.arange(n, device=cache.device)
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def _clamped(index, arena, size, axis):
    return max(0, min(int(index), arena.shape[axis] - size))


def _rows(index, arena, size, axis):
    """The ``size`` indices on ``axis`` from a one-element tensor
    ``index``, clamped into range, on the device."""
    start = index.reshape(1).long().clamp(0, arena.shape[axis] - size)
    return start + torch.arange(size, device=arena.device)


def arena_slice(arena, index, size=1, axis=1):
    """``size`` rows of ``arena`` at ``index`` on ``axis`` (full extent
    elsewhere); the index clamps into range. A view for an int index, a
    copy for a tensor index."""
    if isinstance(index, torch.Tensor):
        return arena.index_select(axis, _rows(index, arena, size, axis))
    return arena.narrow(axis, _clamped(index, arena, size, axis), size)


def arena_update(arena, block, index, axis=1):
    """Write ``block`` into ``arena`` at ``index`` on ``axis`` and at 0 on
    every other axis, in place; returns ``arena``. ``block`` has the
    arena's rank; the index clamps into range."""
    size = block.shape[axis]
    dst = arena
    for ax in range(arena.dim()):
        if ax != axis:
            dst = dst.narrow(ax, 0, block.shape[ax])
    if isinstance(index, torch.Tensor):
        dst.index_copy_(axis, _rows(index, arena, size, axis),
                        block.to(arena.dtype))
    else:
        dst.narrow(axis, _clamped(index, arena, size, axis),
                   size).copy_(block)
    return arena


# ---- the registry ops -----------------------------------------------------

_RNG = {"key": bind_key}


def _gen(logits, key):
    from .random_ops import generator_for
    return generator_for(logits.device, key)


@register("_contrib_sample_greedy", aliases=("sample_greedy",),
          differentiable=False)
def _sample_greedy_op(logits):
    return sample_greedy(logits).to(torch.int32)


@register("_contrib_sample_temperature", aliases=("sample_temperature",),
          differentiable=False, state_binders=_RNG)
def _sample_temperature_op(logits, key=None, temperature=1.0):
    return sample_temperature(logits, _gen(logits, key),
                              temperature).to(torch.int32)


@register("_contrib_sample_top_k", aliases=("sample_top_k",),
          differentiable=False, state_binders=_RNG)
def _sample_top_k_op(logits, key=None, k=0, temperature=1.0):
    return sample_top_k(logits, _gen(logits, key), int(k),
                        temperature).to(torch.int32)


@register("_contrib_generation_sample", aliases=("generation_sample",),
          differentiable=False, state_binders=_RNG)
def _generation_sample_op(logits, key=None, temperatures=1.0, k=0):
    return generation_sample(logits, _gen(logits, key), temperatures,
                             int(k)).to(torch.int32)


@register("_contrib_kv_cache_update", aliases=("kv_cache_update",),
          differentiable=False)
def _kv_cache_update_op(cache, new, positions):
    return kv_cache_update(cache.clone(), new, positions)


@register("_contrib_arena_slice", aliases=("arena_slice",),
          differentiable=False)
def _arena_slice_op(arena, index, size=1, axis=1):
    return arena_slice(arena, index, int(size), int(axis)).clone()


@register("_contrib_arena_update", aliases=("arena_update",),
          differentiable=False)
def _arena_update_op(arena, block, index, axis=1):
    return arena_update(arena.clone(), block, index, int(axis))
