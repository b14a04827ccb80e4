"""Copy-on-admit prefix KV cache: shared prompts skip prefill.

A copy of ``mxnet_tpu/serving/generation/prefix_cache.py`` (host logic
only; its slabs are numpy arrays). Requests that share a system prompt
would recompute its K/V on every admit; instead this cache keeps *copies*
of prefix K/V slabs outside the slot arena and, on an admit whose prompt
starts with a cached prefix, ``DecodeEngine.prefix_admit`` copies the slab
into the request's slot and only the suffix is prefilled.

Keying is a *token-hash chain*: ``h_i = fnv(h_{i-1}, token_i)``, so the
hash of every prefix of a prompt is computed in one O(n) sweep and a
lookup probes descending block-aligned prefix lengths until one hits.
Entries are stored at multiples of ``MXNET_GEN_PREFIX_BLOCK``, verified
against the stored token run on hit (a chain collision must degrade to a
miss, never serve another prompt's K/V), refcounted while an admit is
copying them (eviction cannot free a slab mid-copy), and LRU-evicted
when the store exceeds ``MXNET_GEN_PREFIX_CACHE_MB``.

Stats flow through the resilience Registry: :func:`prefix_stats` and the
rows ``generation.prefix.<name>.{hits,misses,tokens_saved,evictions,...}``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as _np

from ... import config as _config
from ...resilience._stats import Registry, export_rows

__all__ = ["PrefixCache", "prefix_stats"]

_registry = Registry(weak=True)

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = 0xffffffffffffffff


def _hash_chain(tokens):
    """FNV-1a chain over token ids: ``out[i]`` hashes ``tokens[:i+1]``.

    Split out (and monkeypatchable) so the collision-safety test can
    force two different prefixes onto one key and prove the token-run
    verification catches it."""
    h = _FNV_OFFSET
    out = []
    for t in tokens:
        h = ((h ^ (int(t) & _MASK64)) * _FNV_PRIME) & _MASK64
        out.append(h)
    return out


class _Entry:
    __slots__ = ("key", "tokens", "length", "k_slab", "v_slab", "nbytes",
                 "refs", "hits")

    def __init__(self, key, tokens, k_slab, v_slab):
        self.key = key
        self.tokens = tokens            # verification run (collision guard)
        self.length = len(tokens)
        self.k_slab = k_slab            # (layers, 1, length, heads, dim)
        self.v_slab = v_slab
        self.nbytes = int(k_slab.nbytes) + int(v_slab.nbytes)
        self.refs = 0
        self.hits = 0


class PrefixCache:
    """Refcounted LRU store of prefix K/V slabs, keyed by hash chain.

    Parameters
    ----------
    block : int, optional
        Sharing granularity: prefixes are stored/probed at multiples of
        this many tokens (``MXNET_GEN_PREFIX_BLOCK``). Coarse blocks
        bound entry count and lookup probes; fine blocks raise the
        fraction of a shared prompt that can be skipped.
    capacity_mb : float, optional
        Slab-byte budget (``MXNET_GEN_PREFIX_CACHE_MB``); exceeding it
        evicts least-recently-used entries whose refcount is zero.
    """

    def __init__(self, block=None, capacity_mb=None, name="prefix"):
        self.name = name
        self.block = int(block if block is not None
                         else _config.get("MXNET_GEN_PREFIX_BLOCK"))
        if self.block < 1:
            raise ValueError("prefix block must be >= 1")
        cap = float(capacity_mb if capacity_mb is not None
                    else _config.get("MXNET_GEN_PREFIX_CACHE_MB"))
        self.capacity_bytes = int(cap * 1024 * 1024)
        self._entries = OrderedDict()   # key -> _Entry, LRU order
        self._bytes = 0
        self._lock = threading.Lock()
        self._c = {"hits": 0, "misses": 0, "tokens_saved": 0,
                   "evictions": 0, "collisions": 0, "insertions": 0}
        _registry.add(self)

    # ---- key helpers ------------------------------------------------------
    def _probe_lengths(self, n, limit):
        """Block-aligned prefix lengths to probe, longest first. ``limit``
        caps the usable prefix (an admit must leave >= 1 suffix token to
        produce the first-token logits)."""
        top = min(int(n), int(limit))
        return range((top // self.block) * self.block, 0, -self.block)

    def store_lengths(self, n, max_points=16):
        """Block-aligned insertion points for an ``n``-token prompt.

        Slabs are independent copies (not shared pages), so storing every
        multiple of a long prompt would cost O(n²/block) bytes; past
        ``max_points`` the ladder is thinned evenly, always keeping the
        longest point (the one a same-prompt admit hits). Lookup probes
        every multiple regardless, so thinned storage only coarsens
        *partial* sharing of very long prompts."""
        pts = list(range(self.block, int(n) + 1, self.block))
        if len(pts) <= max_points:
            return pts
        stride = (len(pts) + max_points - 1) // max_points
        return pts[::-1][::stride][::-1]   # thin from the top: keep longest

    # ---- lookup / insert --------------------------------------------------
    def lookup(self, tokens, limit=None):
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(entry, length)`` with the entry's refcount taken (the
        caller MUST :meth:`release` after copying its slabs), or ``None``
        on a miss. ``limit`` caps the usable length (default
        ``len(tokens) - 1``)."""
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        if limit is None:
            limit = n - 1
        chain = _hash_chain(tokens[:min(n, int(limit))])
        with self._lock:
            for plen in self._probe_lengths(n, limit):
                key = (plen, chain[plen - 1])
                entry = self._entries.get(key)
                if entry is None:
                    continue
                if entry.tokens != tokens[:plen]:
                    # chain collision: another prompt's slab under this
                    # key — serving it would be silent corruption
                    self._c["collisions"] += 1
                    continue
                entry.refs += 1
                entry.hits += 1
                self._entries.move_to_end(key)
                self._c["hits"] += 1
                self._c["tokens_saved"] += plen
                return entry, plen
            self._c["misses"] += 1
            return None

    def release(self, entry):
        """Return a :meth:`lookup` reference (copy finished)."""
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    def missing_store_points(self, tokens):
        """``(points, chain)``: the store-point lengths of ``tokens`` not
        already cached, computed with ONE hash-chain sweep (probing each
        point via :meth:`has` would rehash the whole prompt per point —
        O(points·n) Python work on the scheduler's iteration thread).
        Pass ``chain`` back to :meth:`insert` to skip rehashing there
        too."""
        tokens = [int(t) for t in tokens]
        chain = _hash_chain(tokens)
        points = []
        with self._lock:
            for p in self.store_lengths(len(tokens)):
                e = self._entries.get((p, chain[p - 1]))
                if e is None or e.tokens != tokens[:p]:
                    points.append(p)
        return points, chain

    def insert(self, tokens, k_slab, v_slab, chain=None):
        """Store one prefix slab (host copies are taken). Duplicate keys
        refresh LRU recency instead of re-storing. ``chain`` may carry a
        precomputed hash chain of ``tokens`` *or any extension of it*
        (chain hashing has the prefix property: entry ``len(tokens)-1``
        hashes exactly ``tokens``)."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            return
        h = (chain[len(tokens) - 1] if chain is not None
             else _hash_chain(tokens)[-1])
        key = (len(tokens), h)
        k_slab = _np.ascontiguousarray(k_slab)
        v_slab = _np.ascontiguousarray(v_slab)
        with self._lock:
            old = self._entries.get(key)
            if old is not None and old.tokens == tokens:
                self._entries.move_to_end(key)
                return
            entry = _Entry(key, tokens, k_slab, v_slab)
            if old is not None:
                # same key, different tokens: replace (collision-safe —
                # lookups verify the run either way)
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._bytes += entry.nbytes
            self._c["insertions"] += 1
            self._evict_locked()

    def _evict_locked(self):
        """LRU eviction down to capacity; in-use (refcounted) slabs are
        skipped — an admit mid-copy must never read freed memory."""
        if self.capacity_bytes <= 0:
            return
        while self._bytes > self.capacity_bytes:
            victim = None
            for key, entry in self._entries.items():
                if entry.refs == 0:
                    victim = key
                    break
            if victim is None:
                return  # everything pinned: stay over budget, retry later
            entry = self._entries.pop(victim)
            self._bytes -= entry.nbytes
            self._c["evictions"] += 1

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # ---- stats ------------------------------------------------------------
    def stats(self):
        with self._lock:
            out = dict(self._c)
            out.update({
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "block": self.block,
                "hit_rate": (self._c["hits"] /
                             float(self._c["hits"] + self._c["misses"])
                             if (self._c["hits"] + self._c["misses"])
                             else 0.0),
            })
        return out

    def close(self):
        """Drop the slabs and unregister from the stats exporter."""
        self.clear()
        _registry.discard(self)

    def __repr__(self):
        st = self.stats()
        return ("PrefixCache(%s: %d entries, %.1f MiB, block %d, "
                "%d hits / %d misses)"
                % (self.name, st["entries"], st["bytes"] / 1048576.0,
                   self.block, st["hits"], st["misses"]))


def prefix_stats():
    """``{name: stats}`` over all registered prefix caches (the
    ``/metrics`` ``generation.prefix`` view)."""
    return _registry.map(lambda c: c.stats())


def _profiler_rows():
    rows = {}
    for name, st in prefix_stats().items():
        prefix = "generation.prefix.%s" % name
        for key in ("hits", "misses", "tokens_saved", "evictions",
                    "collisions", "entries", "bytes"):
            rows["%s.%s" % (prefix, key)] = (st[key], 0.0)
    return rows


export_rows(_profiler_rows)
