"""Slotted KV cache: one preallocated arena whose membership churns.

Counterpart of ``mxnet_tpu/serving/generation/kvcache.py``. One arena pair

    K, V : (num_layers, num_slots, max_seq, num_heads, head_dim)

lives on the device from engine build on; a sequence owns a slot index for
its lifetime, its keys and values live at ``[:, slot, :len]``, and joining
or leaving changes only data. Prefill and decode write into the arenas in
place (``ops/generation_ops.py``), so the cache never holds a second copy.

Host-side state is small and lock-guarded: the free-list, the per-slot
length counters and the occupancy counters. Stats flow through the
resilience :class:`~mxnet_tpu_torch.resilience._stats.Registry`
(:func:`cache_stats`, rows ``generation.kvcache.<name>.*``).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...context import default_device
from ...resilience._stats import Registry, export_rows
from ..batcher import ServingError

__all__ = ["SlotKVCache", "CacheFull", "cache_stats"]

_registry = Registry(weak=True)


class CacheFull(ServingError):
    """No free slot in the arena: admission must wait (backpressure)."""


class SlotKVCache:
    """Preallocated K/V slot arena + free-list + per-slot length counters.

    ``acquire``/``release``/``reset`` manage slot ownership;
    ``advance``/``set_length`` keep the per-slot valid-prefix lengths that
    the decode step turns into its attention mask. Release does not zero a
    slot's data: stale positions are unreachable, because attention is
    masked to ``< length`` and the next prefill overwrites the prefix.
    """

    def __init__(self, num_slots, num_layers, max_seq, num_heads, head_dim,
                 dtype=torch.float32, device=None, name="kvcache"):
        if num_slots < 1 or max_seq < 2:
            raise ValueError("need num_slots >= 1 and max_seq >= 2")
        self.name = name
        self.device = default_device(device)
        self.num_slots = int(num_slots)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        shape = (self.num_layers, self.num_slots, self.max_seq,
                 self.num_heads, self.head_dim)
        self.k_arena = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_arena = torch.zeros(shape, dtype=dtype, device=self.device)
        self._lengths = np.zeros(self.num_slots, dtype=np.int64)
        self._free = list(range(self.num_slots - 1, -1, -1))  # pop() -> 0..
        self._held = set()
        self._lock = threading.Lock()
        self._c = {"acquires": 0, "releases": 0, "acquire_failures": 0,
                   "resets": 0, "peak_in_use": 0, "hwm": 0}
        _registry.add(self)

    @classmethod
    def for_model(cls, model, num_slots, max_seq=None, dtype=torch.float32,
                  device=None, name="kvcache"):
        """Size an arena from a ``TransformerLM`` (``num_layers``,
        ``num_heads``, ``head_dim``, ``max_len``)."""
        max_seq = int(max_seq or model.max_len)
        return cls(num_slots, model.num_layers, min(max_seq, model.max_len),
                   model.num_heads, model.head_dim, dtype=dtype,
                   device=device, name=name)

    # ---- slot lifecycle ---------------------------------------------------
    @property
    def free_slots(self):
        with self._lock:
            return len(self._free)

    @property
    def in_use(self):
        with self._lock:
            return len(self._held)

    def acquire(self):
        """Claim a free slot (length reset to 0); :class:`CacheFull` when
        every slot is held."""
        with self._lock:
            if not self._free:
                self._c["acquire_failures"] += 1
                raise CacheFull("all %d KV-cache slots in use"
                                % self.num_slots)
            slot = self._free.pop()
            self._held.add(slot)
            self._lengths[slot] = 0
            self._c["acquires"] += 1
            self._c["peak_in_use"] = max(self._c["peak_in_use"],
                                         len(self._held))
            return slot

    def release(self, slot):
        """Return a slot to the free-list; releasing a slot that is not
        held raises."""
        slot = int(slot)
        with self._lock:
            if slot not in self._held:
                raise ValueError("slot %d is not held" % slot)
            self._held.discard(slot)
            self._lengths[slot] = 0
            self._free.append(slot)
            self._c["releases"] += 1

    def reset(self):
        """Free every slot and zero every length (arena data stays; the
        masks make it unreachable)."""
        with self._lock:
            self._held.clear()
            self._free = list(range(self.num_slots - 1, -1, -1))
            self._lengths[:] = 0
            self._c["resets"] += 1

    # ---- length counters --------------------------------------------------
    @property
    def lengths(self):
        """Copy of the per-slot valid-prefix lengths (int64 numpy)."""
        with self._lock:
            return self._lengths.copy()

    def set_length(self, slot, n):
        """Record that ``slot`` holds ``n`` valid positions."""
        n = int(n)
        if not 0 <= n <= self.max_seq:
            raise ValueError("length %d outside [0, %d]" % (n, self.max_seq))
        with self._lock:
            if slot not in self._held:
                raise ValueError("slot %d is not held" % slot)
            self._lengths[slot] = n
            self._note_tokens_locked()

    def advance(self, slots):
        """Lengths + 1 for each held slot in ``slots``; raises past
        ``max_seq`` (the scheduler retires at the edge)."""
        with self._lock:
            for slot in slots:
                if slot not in self._held:
                    raise ValueError("slot %d is not held" % int(slot))
                if self._lengths[slot] >= self.max_seq:
                    raise ValueError("slot %d already at max_seq %d"
                                     % (int(slot), self.max_seq))
                self._lengths[slot] += 1
            self._note_tokens_locked()

    def _note_tokens_locked(self):
        total = int(self._lengths.sum())
        if total > self._c["hwm"]:
            self._c["hwm"] = total

    # ---- stats ------------------------------------------------------------
    def stats(self):
        with self._lock:
            tokens = int(self._lengths.sum())
            in_use = len(self._held)
            out = dict(self._c)
            out.update({
                "num_slots": self.num_slots,
                "in_use": in_use,
                "free": len(self._free),
                "occupancy": in_use / float(self.num_slots),
                "max_seq": self.max_seq,
                "tokens_cached": tokens,
                "slots_peak": self._c["peak_in_use"],
                # held-but-empty share of the in-use slots' capacity
                "fragmentation": (1.0 - tokens /
                                  float(in_use * self.max_seq)
                                  if in_use else 0.0),
                "arena_bytes": 2 * self.k_arena.numel()
                * self.k_arena.element_size(),
            })
        return out

    def close(self):
        """Unregister from the stats registry now (the registry holds the
        cache weakly, so a dropped cache leaves it anyway)."""
        _registry.discard(self)


def cache_stats():
    """``{name: stats}`` over all registered arenas."""
    return _registry.map(lambda c: c.stats())


def _stats_rows():
    rows = {}
    for name, st in cache_stats().items():
        prefix = "generation.kvcache.%s" % name
        for key in ("in_use", "acquires", "releases", "acquire_failures",
                    "tokens_cached", "hwm", "slots_peak"):
            rows["%s.%s" % (prefix, key)] = (st[key], 0.0)
    return rows


export_rows(_stats_rows)
