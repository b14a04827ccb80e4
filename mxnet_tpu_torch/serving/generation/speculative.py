"""Speculative decoding: draft k tokens, then verify them in one step.

Counterpart of ``mxnet_tpu/serving/generation/speculative.py`` (Leviathan
et al. 2023). Decode emits one token per target step because each step's
input is the previous step's output. A small *draft* model proposes ``k``
tokens one by one (cheap), then ONE verify step of the target scores all
``k + 1`` positions at once and accepts the longest run where the target's
own greedy choice agrees with the draft. Greedy acceptance is token-exact:
every emitted token is the target's argmax given its committed prefix, so
a speculative stream is the plain stream; speculation changes the
schedule, not the output.

On the slot arena:

- The draft runs its own :class:`DecodeEngine` over a mirror arena (same
  slots and ``max_seq``, on the target's device) and holds every draft
  slot for good: draft slot ``i`` mirrors target slot ``i``. Drafting is
  ``k + 1`` draft decode steps for the whole live batch (the extra step
  writes the last proposal's K/V, so full acceptance leaves no hole).
- The verify is the target's ``prefill_chunk`` over ``(num_slots, k + 1)``
  tokens at every slot's committed length, writing the arena in place.
- Rollback is free: rejected positions stay written but past the committed
  length, where every later mask ignores them.
- The draft cache heals itself: before a round, a slot whose draft length
  differs from the target's committed length is rebuilt by chunk-prefilling
  the request's committed tokens through the draft.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ... import config as _config
from ...observability import tracer as _trace
from ...ops import generation_ops as _gen
from .decode import DecodeEngine

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """Draft-then-verify fast path over a target :class:`DecodeEngine`.

    Parameters
    ----------
    engine : DecodeEngine
        The target engine (owns the authoritative arena and sampling).
    draft_model : TransformerLM
        The proposer, with the same incremental-decode contract, on the
        target's device and with ``max_len >= engine.max_seq``.
    k : int, optional
        Proposals per verify step (``MXNET_GEN_SPEC_K``).
    """

    def __init__(self, engine, draft_model, k=None, name=None):
        self.engine = engine
        self.k = int(k if k is not None else _config.get("MXNET_GEN_SPEC_K"))
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")
        name = name or (engine._name + ".spec")
        self.name = name
        if int(draft_model.max_len) < engine.max_seq:
            # the mirror arena would be clamped to the draft's max_len and
            # fail every live request at its edge: refuse it here instead
            raise ValueError(
                "draft model max_len %d < target max_seq %d: the draft "
                "must cover the full arena depth"
                % (int(draft_model.max_len), engine.max_seq))
        # the draft's prefix cache would be useless (it prefills only to
        # resync), and its chunk must be positive so that any history
        # length can be rebuilt
        self.draft = DecodeEngine(
            draft_model, num_slots=engine.num_slots, max_seq=engine.max_seq,
            ladder=engine.ladder, top_k=0,
            chunk=engine.chunk or engine.ladder[-1], prefix_cache=False,
            dtype=draft_model.dtype, device=engine.device,
            name=name + ".draft", span="generation.draft")
        for _ in range(self.draft.num_slots):
            self.draft.cache.acquire()
        self._base = {}
        self._lock = threading.Lock()
        self._c = {"rounds": 0, "drafted": 0, "accepted": 0, "syncs": 0,
                   "verifies": 0}

    def can_step(self, slots):
        """Whether a round fits: EVERY slot (live, free, or mid-chunked
        prefill) needs room for ``k + 1`` writes before the arena's edge,
        since the verify writes all ``num_slots`` rows at their lengths and
        a clamped write would shift over committed K/V. ``slots`` is
        accepted for symmetry; the check is arena-wide."""
        del slots
        lengths = self.engine.cache.lengths
        return bool((lengths + self.k + 1 <= self.engine.max_seq).all())

    def _sync_draft(self, slot, history):
        """Rebuild one draft slot from the request's committed tokens."""
        self.draft.cache.set_length(slot, 0)
        self.draft.prefill_chunks(slot, history, 0, sample=False)
        with self._lock:
            self._c["syncs"] += 1

    def round(self, slots, pending, history_fn):
        """One speculative iteration for the live ``slots``.

        ``pending[slot]`` is each sequence's last sampled, not yet written
        token; ``history_fn(slot)`` gives its committed tokens for a draft
        resync. Returns ``{slot: [tokens]}``: 1 to ``k + 1`` target-greedy
        tokens per slot, untrimmed (the scheduler cuts at budget and EOS,
        then calls :meth:`commit` with the count it kept)."""
        eng = self.engine
        t_len = eng.cache.lengths
        d_len = self.draft.cache.lengths
        for s in slots:
            if int(d_len[s]) != int(t_len[s]):
                self._sync_draft(s, history_fn(s))
        with self._lock:
            self._base = {s: int(t_len[s]) for s in slots}
        n_slots = eng.num_slots
        x = np.zeros(n_slots, dtype=np.int64)
        for s in slots:
            x[s] = pending[s]
        zeros_t = np.zeros(n_slots, dtype=np.float32)
        consumed = [x.copy()]                      # x_0 = pending
        with _trace.span("generation.spec_draft", slots=len(slots),
                         k=self.k):
            for i in range(self.k + 1):
                toks = self.draft.decode_step(x, zeros_t)
                self.draft.cache.advance(slots)
                if i < self.k:
                    x = x.copy()
                    for s in slots:
                        x[s] = toks[s]
                    consumed.append(x)             # x_{i+1} = draft_{i+1}
        tokens_mat = np.stack(consumed, axis=1)    # (num_slots, k + 1)
        g = self.verify(tokens_mat)
        out = {}
        accepted = 0
        for s in slots:
            y, d = g[s], tokens_mat[s]
            a = 0
            while a < self.k and int(d[a + 1]) == int(y[a]):
                a += 1
            accepted += a
            out[s] = [int(t) for t in y[:a + 1]]
        with self._lock:
            self._c["rounds"] += 1
            self._c["verifies"] += 1
            self._c["drafted"] += self.k * len(slots)
            self._c["accepted"] += accepted
        return out

    def verify(self, tokens):
        """The target's greedy token after each of ``tokens (num_slots,
        k + 1)``, every slot's row written at its committed length: one
        ``prefill_chunk`` over the arena, one device-to-host copy."""
        eng = self.engine
        # can_step keeps every write window inside the arena; the minimum
        # only guards the clamp
        lengths = np.minimum(eng.cache.lengths, eng.max_seq - (self.k + 1))
        with _trace.span("generation.spec_verify", slots=eng.cache.in_use,
                         k=self.k), torch.no_grad():
            cache = [(eng.cache.k_arena[layer], eng.cache.v_arena[layer])
                     for layer in range(eng.cache.num_layers)]
            logits, _ = eng._model.prefill_chunk(
                torch.from_numpy(tokens).to(eng.device), cache,
                torch.from_numpy(lengths).to(eng.device))
            return _gen.sample_greedy(logits).cpu().numpy()

    def commit(self, slot, n):
        """Advance both arenas' committed length of ``slot`` by the ``n``
        tokens the scheduler kept; everything past it is unreachable."""
        base = self._base[slot]
        self.engine.cache.set_length(slot, base + n)
        self.draft.cache.set_length(slot, base + n)

    def stats(self):
        with self._lock:
            out = dict(self._c)
        out["k"] = self.k
        out["acceptance_rate"] = (out["accepted"] / float(out["drafted"])
                                  if out["drafted"] else 0.0)
        out["draft"] = self.draft.stats()
        return out

    def close(self):
        self.draft.close()
