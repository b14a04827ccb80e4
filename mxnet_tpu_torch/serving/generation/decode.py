"""Slot-batched decoding: bucket-laddered prefill + one decode step.

Counterpart of ``mxnet_tpu/serving/generation/decode.py``, for the two
program families the plain (unchunked, uncached) path runs:

- **prefill** fills one slot from a prompt in one forward pass. Prompts
  pad up to a *ladder* rung (``MXNET_GEN_LADDER``); the pad tail is masked
  out of attention and never becomes readable cache. On the card its
  attention is the CUDA flash kernel (``ops/flash_attention.py``).
- **decode** is one step for the whole slot batch: ``(num_slots, 1)``
  tokens, per-slot lengths and temperatures, attention against the arena
  with a mask built from the lengths, and sampling from the engine's
  ``torch.Generator``.

Both write the K/V arena in place. PyTorch runs eagerly, so there is no
compile to count; the engine counts prefills per rung and decode steps.
Chunked prefill, the prefix cache and speculative decoding are not ported
yet: asking for one raises :class:`NotImplementedError`.
"""
from __future__ import annotations

import bisect
import threading

import numpy as np
import torch

from ... import config as _config
from ...context import default_device
from ...ops import generation_ops as _gen
from ..batcher import ServingError
from .kvcache import SlotKVCache

__all__ = ["DecodeEngine", "PromptTooLong"]


class PromptTooLong(ServingError):
    """Prompt exceeds the prefill ladder or leaves no room to generate."""


def _ladder_from_config(max_seq):
    raw = _config.get("MXNET_GEN_LADDER")
    rungs = tuple(int(r) for r in str(raw).split(",") if str(r).strip())
    return tuple(r for r in sorted(set(rungs)) if r <= max_seq) or (max_seq,)


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class DecodeEngine:
    """Slot-batched autoregressive decoder over a :class:`SlotKVCache`.

    Parameters
    ----------
    model : TransformerLM
        Exposes ``prefill(tokens, lengths)``, ``step(tokens, cache,
        lengths)`` and the geometry properties; it must live on ``device``.
    cache : SlotKVCache, optional
        Built from the model when omitted (``num_slots``/``max_seq``,
        defaulting to ``MXNET_GEN_SLOTS``/``MXNET_GEN_MAX_SEQ`` capped to
        the model's ``max_len``).
    ladder : sequence of int, optional
        Prefill rungs (default ``MXNET_GEN_LADDER``); rungs above
        ``max_seq`` are dropped.
    top_k : int, optional
        Top-k filter of the sampler (``MXNET_GEN_TOP_K``; 0 = off).
        Temperature is per request: greedy and sampled requests mix in one
        step.
    seed : int
        Seed of the sampling generator: a fixed seed replays a run.
    device : torch.device or str, optional
        CUDA when None (raises without one).
    """

    def __init__(self, model, cache=None, num_slots=None, max_seq=None,
                 ladder=None, top_k=None, seed=0, dtype="float32",
                 chunk=None, prefix_cache=None, device=None,
                 name="generation"):
        if chunk:
            raise NotImplementedError(
                "chunked prefill (chunk=%r) is not ported yet" % chunk)
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError("model lives on %s, engine on %s"
                             % (model.device, self.device))
        self._model = model
        self._name = name
        if cache is None:
            num_slots = int(num_slots or _config.get("MXNET_GEN_SLOTS"))
            max_seq = int(max_seq or min(_config.get("MXNET_GEN_MAX_SEQ"),
                                         model.max_len))
            cache = SlotKVCache.for_model(model, num_slots, max_seq,
                                          dtype=_torch_dtype(dtype),
                                          device=self.device, name=name)
        self.cache = cache
        if ladder is None:
            ladder = _ladder_from_config(cache.max_seq)
        self._ladder = tuple(r for r in sorted(set(int(r) for r in ladder))
                             if 1 <= r <= cache.max_seq)
        if not self._ladder:
            raise ValueError("empty prefill ladder for max_seq=%d"
                             % cache.max_seq)
        self._top_k = int(_config.get("MXNET_GEN_TOP_K")
                          if top_k is None else top_k)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._lock = threading.Lock()
        self._prefills = {r: 0 for r in self._ladder}
        self._decode_steps = 0

    # ---- configuration ----------------------------------------------------
    @property
    def num_slots(self):
        return self.cache.num_slots

    @property
    def max_seq(self):
        return self.cache.max_seq

    def rung_for(self, n):
        """Smallest ladder rung >= n; :class:`PromptTooLong` when the
        prompt (plus one generated position) cannot fit."""
        if n < 1:
            raise ServingError("empty prompt")
        if n > self._ladder[-1] or n >= self.cache.max_seq:
            raise PromptTooLong(
                "prompt of %d tokens exceeds the prefill ladder (max rung "
                "%d) or leaves no room to generate (max_seq %d)"
                % (n, self._ladder[-1], self.cache.max_seq))
        return self._ladder[bisect.bisect_left(self._ladder, n)]

    def validate_prompt(self, n):
        """Admission-time length check: the prefill ladder bounds the
        prompt."""
        self.rung_for(n)

    # ---- entry points -----------------------------------------------------
    def prefill(self, slot, prompt, temperature=0.0):
        """Fill ``slot`` from ``prompt`` (1-D token ids) and sample the
        first generated token (python int). Pads to a ladder rung, writes
        the slot's K/V rows of the arena in place, records the length."""
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        n = int(prompt.shape[0])
        rung = self.rung_for(n)
        padded = np.zeros((1, rung), dtype=np.int64)
        padded[0, :n] = prompt
        with torch.no_grad():
            tokens = torch.from_numpy(padded).to(self.device)
            lengths = torch.tensor([n], device=self.device)
            logits, cache = self._model.prefill(tokens, lengths)
            for layer, (k, v) in enumerate(cache):
                _gen.arena_update(self.cache.k_arena[layer], k, slot, axis=0)
                _gen.arena_update(self.cache.v_arena[layer], v, slot, axis=0)
            temps = torch.tensor([float(temperature)], device=self.device)
            tok = _gen.generation_sample(logits, self._generator, temps,
                                         k=self._top_k)
            tok = int(tok.item())
        self.cache.set_length(slot, n)
        with self._lock:
            self._prefills[rung] += 1
        return tok

    def decode_step(self, tokens, temperatures):
        """One decode iteration for every slot.

        ``tokens (num_slots,)`` each held slot's pending token (free slots:
        any valid id, conventionally 0); ``temperatures (num_slots,)``.
        Appends each token at its slot's current length (in place) and
        returns the sampled next tokens ``(num_slots,)`` (numpy int64). The
        caller advances lengths for the slots it holds live."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(self.num_slots, 1)
        temps = np.asarray(temperatures, dtype=np.float32).reshape(
            self.num_slots)
        lengths = np.minimum(self.cache.lengths, self.max_seq - 1)
        with torch.no_grad():
            cache = [(self.cache.k_arena[layer], self.cache.v_arena[layer])
                     for layer in range(self.cache.num_layers)]
            logits, _ = self._model.step(
                torch.from_numpy(tokens).to(self.device), cache,
                torch.from_numpy(lengths).to(self.device))
            toks = _gen.generation_sample(
                logits, self._generator,
                torch.from_numpy(temps).to(self.device), k=self._top_k)
            out = toks.cpu().numpy().reshape(-1)
        with self._lock:
            self._decode_steps += 1
        return out

    # ---- stats ------------------------------------------------------------
    def stats(self):
        """Prefills per rung and decode steps so far."""
        with self._lock:
            return {"prefills": dict(self._prefills),
                    "prefill_total": sum(self._prefills.values()),
                    "decode_steps": self._decode_steps}
