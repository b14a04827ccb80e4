"""Slot-batched decoding: bucket-laddered prefill, chunked prefill, the
prefix cache's copy-on-admit, and one decode step.

Counterpart of ``mxnet_tpu/serving/generation/decode.py``. Three program
families run on the K/V arena:

- **prefill** fills one slot from a prompt in one forward pass. Prompts
  pad up to a *ladder* rung (``MXNET_GEN_LADDER``); the pad tail is masked
  out of attention and never becomes readable cache. On the card its
  attention is the CUDA flash kernel (``ops/flash_attention.py``).
- **chunk** appends a run of prompt tokens to one slot at its committed
  length (``TransformerLM.prefill_chunk``): chunked prefill
  (``MXNET_GEN_PREFILL_CHUNK``) cuts a long prompt at absolute multiples
  of ``chunk``, and a prefix-cache hit fills the suffix after the copied
  slab. Its attention is the plain path (the mask is per query).
- **decode** is one step for the whole slot batch: ``(num_slots, 1)``
  tokens, per-slot lengths and temperatures, attention against the arena
  with a mask built from the lengths, and sampling from the engine's
  ``torch.Generator``.

All three write the arena in place. The prefix cache
(:class:`~.prefix_cache.PrefixCache`, on by default as
``MXNET_GEN_PREFIX_CACHE``) holds host copies of prompt K/V: an admit that
hits copies the slab into its slot (the **prefix_insert** program); a
finished prefill publishes its prompt's rows from a background thread,
after the scheduler's thread has copied them out on the device (the
**prefix_extract** program; the slot is overwritten by the next step or
occupant).

The five programs run through :class:`~mxnet_tpu_torch.cached_op.CachedOp`
under the reference's names (``<name>.decode``, ``.prefill``, ``.chunk``,
``.prefix_insert``, ``.prefix_extract``): on the card each signature is
captured once as a CUDA graph and replayed, on the CPU each runs eagerly
and its signatures are still counted (:meth:`DecodeEngine.compile_stats`,
bounded by :meth:`DecodeEngine.program_bound`). A graph holds no host
value, so the programs take only small device tensors as arguments:
tokens, lengths, temperatures, the slot index, the chunk start and the
prefix slabs. The arena is not an argument (a replay would copy it in):
each program closes over the cache's arena tensors and writes them in
place, and indexes the slot with ``index_select``/``index_copy_``. The
signature is the rung, chunk width or slab width, as in the reference, so
requests joining and leaving the batch capture nothing new.

The sampler draws from the engine's own ``torch.Generator``, which the
decode graph registers: a fixed ``seed`` makes an engine's run repeat
itself, and greedy streams are token for token those of an eager run (and
the reference's), but a sampled stream depends on how many draws the
captures took and so differs from an eager run's.
"""
from __future__ import annotations

import bisect
import queue as _queue
import threading
import weakref

import numpy as np
import torch

from ... import config as _config
from ...cached_op import CachedOp
from ...context import default_device
from ...observability import tracer as _trace
from ...ops import generation_ops as _gen
from ..batcher import ServingError
from .kvcache import SlotKVCache
from .prefix_cache import PrefixCache

__all__ = ["DecodeEngine", "PromptTooLong"]

# prefix publishes waiting for the publisher thread; more are dropped
_PUBLISH_QUEUE = 8
# how often an idle publisher checks that its engine is still alive
_PUBLISH_POLL_S = 1.0


def _next_pow2(n, cap=None):
    """Smallest power of two >= n (capped at ``cap``): the width of an
    arena-edge chunk tail that no chunk rung fits, and of a prefix slab's
    insert."""
    w = 1
    while w < n:
        w <<= 1
    return min(w, cap) if cap is not None else w


def _host(t):
    """A device tensor as a numpy array of the same bytes (bf16 as
    int16: numpy has no bfloat16)."""
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


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
        Exposes ``prefill(tokens, lengths)``, ``prefill_chunk(tokens,
        cache, start)``, ``step(tokens, cache, lengths)`` and the geometry
        properties; it must live on ``device``.
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
    chunk : int, optional
        Chunked-prefill size (``MXNET_GEN_PREFILL_CHUNK``; 0 = off). With
        it on, any prompt that leaves room to generate is admitted, and
        the scheduler interleaves its chunks with decode steps.
    prefix_cache : PrefixCache or bool, optional
        A shared :class:`PrefixCache`; ``False`` for none; None builds one
        (owned, closed with the engine) when ``MXNET_GEN_PREFIX_CACHE``
        is on.
    device : torch.device or str, optional
        CUDA when None (raises without one).
    span : str
        Prefix of the tracer spans of this engine's programs
        (``<span>.prefill``, ``.prefill_chunk``, ``.step``,
        ``.prefix_hit``); a draft engine takes its own.
    cached : bool
        Run the five programs through ``CachedOp`` (the default: one CUDA
        graph per signature on the card). False runs them eagerly, every
        call launching its kernels (the replay's baseline); their counts
        then stay at 0.
    """

    def __init__(self, model, cache=None, num_slots=None, max_seq=None,
                 ladder=None, top_k=None, seed=0, dtype="float32",
                 chunk=None, prefix_cache=None, device=None,
                 name="generation", span="generation", cached=True):
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError("model lives on %s, engine on %s"
                             % (model.device, self.device))
        self._model = model
        self._name = name
        self._span = span
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
        self.chunk = int(_config.get("MXNET_GEN_PREFILL_CHUNK")
                         if chunk is None else chunk)
        if self.chunk < 0:
            raise ValueError("chunk must be >= 0, got %d" % self.chunk)
        if self.chunk:
            # chunk widths: the ladder's rungs below the chunk, and the
            # chunk itself
            self._chunk_ladder = tuple(sorted(
                {r for r in self._ladder if r < self.chunk}
                | {min(self.chunk, cache.max_seq)}))
        else:
            # chunking off: the chunk program still fills prefix-hit
            # suffixes, bucketed over the prefill ladder
            self._chunk_ladder = self._ladder
        if prefix_cache is None:
            self._owns_prefix = bool(_config.get("MXNET_GEN_PREFIX_CACHE"))
            self.prefix = PrefixCache(name=name) if self._owns_prefix \
                else None
        else:
            self._owns_prefix = False
            self.prefix = prefix_cache or None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        gens = (self._generator,) if self.device.type == "cuda" else ()
        program = CachedOp if cached else _Eager
        self._decode_op = program(self._decode_fn, name=name + ".decode",
                                  generators=gens)
        self._prefill_op = program(self._prefill_fn, name=name + ".prefill")
        self._chunk_op = program(self._chunk_fn, name=name + ".chunk")
        self._insert_op = program(self._insert_fn,
                                  name=name + ".prefix_insert")
        self._extract_op = program(self._extract_fn,
                                   name=name + ".prefix_extract")
        self._lock = threading.Lock()
        self._prefills = {r: 0 for r in self._ladder}
        self._chunks = {}
        self._decode_steps = 0
        self._publish_errors = 0
        self._publisher = None        # lazy prefix-publish thread
        self._publish_q = None
        self._publish_lock = threading.Lock()

    # ---- configuration ----------------------------------------------------
    @property
    def ladder(self):
        return self._ladder

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
        """Admission-time length check. With chunked prefill on, any
        prompt that leaves room to generate is admitted; without it the
        prefill ladder bounds the prompt."""
        if n < 1:
            raise ServingError("empty prompt")
        if self.chunk:
            if n >= self.cache.max_seq:
                raise PromptTooLong(
                    "prompt of %d tokens leaves no room to generate "
                    "(max_seq %d)" % (n, self.cache.max_seq))
            return
        self.rung_for(n)

    def _chunk_rung(self, m, pos):
        """Chunk width for an ``m``-token segment written at absolute
        position ``pos``: the smallest chunk-ladder rung >= m whose write
        window stays inside the arena (the cache write would otherwise
        clamp its start and overwrite committed positions). Arena-edge
        tails that no rung fits fall back to a power-of-two width, then
        to ``m`` itself, which always fits (``pos + m <= max_seq - 1``)."""
        S = self.cache.max_seq
        for r in self._chunk_ladder:
            if r >= m and pos + r <= S:
                return r
        w = _next_pow2(m)
        if pos + w <= S:
            return w
        return m

    # ---- the programs (NDArrays in and out; the arena in place) ----------
    def _layers(self):
        return range(self.cache.num_layers)

    def _prefill_fn(self, tokens, length, slot):
        """Prefill one slot: the model's forward over the padded prompt,
        its K/V rows written into the slot (a traced index: one program
        per rung serves every slot); returns the last valid logits."""
        from ...ndarray import NDArray
        logits, cache = self._model.prefill(tokens._data, length._data)
        for layer, (k, v) in zip(self._layers(), cache):
            _gen.arena_update(self.cache.k_arena[layer], k, slot._data,
                              axis=0)
            _gen.arena_update(self.cache.v_arena[layer], v, slot._data,
                              axis=0)
        return NDArray(logits)

    def _decode_fn(self, tokens, lengths, temps):
        """One decode step for every slot, sampling included."""
        from ...ndarray import NDArray
        cache = [(self.cache.k_arena[layer], self.cache.v_arena[layer])
                 for layer in self._layers()]
        logits, _ = self._model.step(tokens._data, cache, lengths._data)
        return NDArray(_gen.generation_sample(
            logits, self._generator, temps._data, k=self._top_k))

    def _chunk_fn(self, tokens, start, slot):
        """One chunk of one slot's prefill: the slot's rows copied out of
        the arena, the chunk appended at ``start`` by the model, the rows
        written back; returns the chunk's per-position logits."""
        from ...ndarray import NDArray
        rows = [(_gen.arena_slice(self.cache.k_arena[layer], slot._data,
                                  axis=0),
                 _gen.arena_slice(self.cache.v_arena[layer], slot._data,
                                  axis=0)) for layer in self._layers()]
        logits, _ = self._model.prefill_chunk(tokens._data, rows,
                                              start._data)
        for layer, (k, v) in zip(self._layers(), rows):
            _gen.arena_update(self.cache.k_arena[layer], k, slot._data,
                              axis=0)
            _gen.arena_update(self.cache.v_arena[layer], v, slot._data,
                              axis=0)
        return NDArray(logits)

    def _insert_fn(self, k_slab, v_slab, slot):
        """Copy-on-admit: a prefix slab ``(L, 1, W, H, D)`` into ``slot``
        (``W`` a power of two: one program per width)."""
        _gen.arena_update(self.cache.k_arena, k_slab._data, slot._data,
                          axis=1)
        _gen.arena_update(self.cache.v_arena, v_slab._data, slot._data,
                          axis=1)
        return ()

    def _extract_fn(self, slot):
        """A copy of one slot's K/V rows ``(L, 1, max_seq, H, D)``, for a
        prefix publish (one signature)."""
        from ...ndarray import NDArray
        return (NDArray(_gen.arena_slice(self.cache.k_arena, slot._data,
                                         axis=1)),
                NDArray(_gen.arena_slice(self.cache.v_arena, slot._data,
                                         axis=1)))

    def _index(self, values):
        """Host ints as a device int64 tensor (a program argument)."""
        return torch.tensor(values, dtype=torch.int64, device=self.device)

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
        with _trace.span(self._span + ".prefill", rung=rung, prompt_len=n,
                         slot=int(slot)), torch.no_grad():
            logits = self._prefill_op(
                torch.from_numpy(padded).to(self.device), self._index([n]),
                self._index([int(slot)]))._data
            tok = self._sample_first(logits, temperature)
        self.cache.set_length(slot, n)
        with self._lock:
            self._prefills[rung] += 1
        return tok

    def _sample_first(self, logits, temperature):
        """Sample one token from ``logits (1, V)`` with the decode step's
        sampler; only the token crosses to the host."""
        temps = torch.tensor([float(temperature)], device=self.device)
        tok = _gen.generation_sample(logits, self._generator, temps,
                                     k=self._top_k)
        return int(tok.item())

    def prefill_chunks(self, slot, prompt, start, temperature=0.0,
                       max_chunks=None, sample=True):
        """Advance the prefill of ``prompt`` in ``slot`` from absolute
        position ``start`` by up to ``max_chunks`` chunk calls (None = to
        the end).

        Chunk boundaries are absolute multiples of ``self.chunk`` (when
        chunking is on), so a prompt is cut the same way wherever a
        prefix-cache hit started it: a hit at a block-aligned length then
        runs chunks of the same position, length and width as the cold
        pass, and so gives bitwise the same rows. With chunking off the
        whole remainder goes in one ladder-bucketed call (the prefix-hit
        suffix fill).

        Returns ``(pos, tok)``: the new committed position, and the sampled
        first token once ``pos == len(prompt)`` (None while prefill is in
        flight, or with ``sample=False``: the draft's resync needs only
        the K/V)."""
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        n = int(prompt.shape[0])
        pos = int(start)
        if not 0 <= pos < n:
            raise ServingError("chunk start %d outside prompt [0, %d)"
                               % (pos, n))
        slot_t = self._index([int(slot)])
        steps = 0
        tok = None
        while pos < n and (max_chunks is None or steps < max_chunks):
            end = min(n, (pos // self.chunk + 1) * self.chunk) \
                if self.chunk else n
            m = end - pos
            rung = self._chunk_rung(m, pos)
            padded = np.zeros((1, rung), dtype=np.int64)
            padded[0, :m] = prompt[pos:end]
            with _trace.span(self._span + ".prefill_chunk", rung=rung,
                             start=pos, tokens=m, slot=int(slot)), \
                    torch.no_grad():
                logits = self._chunk_op(
                    torch.from_numpy(padded).to(self.device),
                    self._index([pos]), slot_t)._data
                self.cache.set_length(slot, end)
                if end >= n and sample:
                    tok = self._sample_first(logits[0, m - 1:m], temperature)
            with self._lock:
                self._chunks[rung] = self._chunks.get(rung, 0) + 1
            pos = end
            steps += 1
        return pos, tok

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
        with _trace.span(self._span + ".step",
                         slots=int(self.cache.in_use)), torch.no_grad():
            toks = self._decode_op(
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(lengths).to(self.device),
                torch.from_numpy(temps).to(self.device))._data
            out = toks.cpu().numpy().reshape(-1)
        with self._lock:
            self._decode_steps += 1
        return out

    # ---- prefix cache -----------------------------------------------------
    @staticmethod
    def _slab_rung(n, max_seq):
        """Power-of-two padded insert width: at most log2(max_seq) insert
        programs."""
        return _next_pow2(n, cap=max_seq)

    def prefix_admit(self, slot, prompt):
        """Probe the prefix cache for the longest usable cached prefix of
        ``prompt``; on a hit, copy its K/V slab into ``slot`` and commit
        the slot's length. Returns the number of prompt tokens skipped (0
        on a miss or without a cache)."""
        if self.prefix is None:
            return 0
        hit = self.prefix.lookup(prompt)
        if hit is None:
            return 0
        entry, plen = hit
        try:
            width = self._slab_rung(plen, self.cache.max_seq)
            slabs = []
            for slab in (entry.k_slab, entry.v_slab):
                shape = list(slab.shape)
                shape[2] = width
                pad = np.zeros(shape, dtype=slab.dtype)
                pad[:, :, :plen] = slab[:, :, :plen]
                slabs.append(torch.from_numpy(pad).view(
                    self.cache.k_arena.dtype).to(self.device))
            with _trace.span(self._span + ".prefix_hit", tokens=plen,
                             slot=int(slot)), torch.no_grad():
                self._insert_op(slabs[0], slabs[1], self._index([int(slot)]))
                self.cache.set_length(slot, plen)
        finally:
            self.prefix.release(entry)
        return plen

    def _snapshot(self, slot, prompt):
        """``(k, v, prompt, points, chain)`` for a publish of ``slot``'s
        prompt rows, or None when every store point is cached already.
        ``k``/``v`` are device copies ``(L, 1, n, H, D)`` of the rows up
        to the longest point, launched on the calling thread."""
        prompt = np.array(prompt, dtype=np.int64).reshape(-1)
        points, chain = self.prefix.missing_store_points(prompt)
        if not points:
            return None
        n = points[-1]
        with torch.no_grad():
            k, v = self._extract_op(self._index([int(slot)]))
        return k._data[:, :, :n], v._data[:, :, :n], prompt, points, chain

    def _store(self, snap):
        k, v, prompt, points, chain = snap
        k, v = _host(k), _host(v)
        for p in points:
            self.prefix.insert(prompt[:p], k[:, :, :p], v[:, :, :p],
                               chain=chain)

    def prefix_store(self, slot, prompt):
        """Publish ``slot``'s prefilled prompt K/V into the prefix cache at
        every block-aligned length not stored yet (one device copy and one
        device-to-host copy per prompt), synchronously."""
        if self.prefix is None:
            return
        snap = self._snapshot(slot, prompt)
        if snap is not None:
            self._store(snap)

    def prefix_store_async(self, slot, prompt):
        """Queue a prefix publish for the background publisher thread.

        The arena is written in place, and the slot's rows are overwritten
        by the next decode step or the slot's next occupant. So the rows
        are copied on the device here, on the caller's thread, before any
        later launch of that thread; only the device-to-host copy and the
        insert run on the publisher. Best effort: a full queue drops the
        publish (the next admit that shares the prompt offers it again)."""
        if self.prefix is None:
            return
        snap = self._snapshot(slot, prompt)
        if snap is None:
            return
        with self._publish_lock:
            if self._publisher is None:
                # the thread holds the engine only weakly: close() stops
                # it, and so does the engine's collection
                self._publish_q = _queue.Queue()
                self._publisher = threading.Thread(
                    target=_publish_loop,
                    args=(weakref.ref(self), self._publish_q), daemon=True,
                    name=self._name + "-prefix-publish")
                self._publisher.start()
            if self._publish_q.qsize() < _PUBLISH_QUEUE:
                self._publish_q.put(snap)

    def _publish(self, snap):
        try:
            self._store(snap)
        except Exception:  # noqa: BLE001 — publishing is best effort
            with self._lock:
                self._publish_errors += 1

    def prefix_flush(self):
        """Block until every queued prefix publish has landed (tests and
        the prefill-lane handoff)."""
        with self._publish_lock:
            q = self._publish_q
        if q is not None:
            q.join()

    # ---- stats ------------------------------------------------------------
    def compile_stats(self):
        """Each program family's CachedOp stats (``hits``, ``misses``,
        ``size``, ``graphs``, ...): requests joining and leaving the batch
        leave ``decode["misses"]`` at 1; prefill is bounded by the ladder,
        chunk by the chunk ladder and the arena-edge widths, insert by
        log2(max_seq)."""
        return {"decode": self._decode_op.cache_stats(),
                "prefill": self._prefill_op.cache_stats(),
                "chunk": self._chunk_op.cache_stats(),
                "prefix_insert": self._insert_op.cache_stats(),
                "prefix_extract": self._extract_op.cache_stats()}

    def program_bound(self):
        """The most programs this engine can hold, by the reference's
        formula: the prefill rungs and the decode step, the chunk rungs
        and the power-of-two arena-edge widths, and with a prefix cache
        the insert widths and the extract."""
        log_widths = max(1, self.cache.max_seq.bit_length())
        n = len(self._ladder) + 1
        n += len(self._chunk_ladder) + log_widths
        if self.prefix is not None:
            n += log_widths + 1
        return n

    def stats(self):
        """Prefills and chunk calls per rung, decode steps, and failed
        prefix publishes so far."""
        with self._lock:
            return {"prefills": dict(self._prefills),
                    "prefill_total": sum(self._prefills.values()),
                    "chunks": dict(self._chunks),
                    "chunk_total": sum(self._chunks.values()),
                    "decode_steps": self._decode_steps,
                    "publish_errors": self._publish_errors}

    def close(self):
        """Stop the publisher thread (queued publishes land first), drop
        the programs' graphs, close an owned prefix cache and unregister
        the arena's stats."""
        with self._publish_lock:
            publisher, self._publisher = self._publisher, None
        if publisher is not None:
            self._publish_q.put(None)
            publisher.join(timeout=30.0)
        for op in (self._decode_op, self._prefill_op, self._chunk_op,
                   self._insert_op, self._extract_op):
            op.clear()
        if self.prefix is not None and self._owns_prefix:
            self.prefix.close()
        self.cache.close()


class _Eager:
    """A program called as it is, without a CachedOp (``cached=False``):
    the arguments wrapped as the CachedOp wraps them, no counts."""

    def __init__(self, fn, name, generators=()):
        self._fn = fn
        self._name = name

    def __call__(self, *args):
        from ...ndarray import NDArray
        return self._fn(*[a if isinstance(a, NDArray) else NDArray(a)
                          for a in args])

    def cache_stats(self):
        return {"hits": 0, "misses": 0, "evictions": 0, "size": 0,
                "graphs": 0, "pool_bytes": 0, "capacity": 0}

    def clear(self):
        pass


def _publish_loop(engine_ref, q):
    """The prefix publisher: stores each queued snapshot through the
    engine while it lives; ``None``, or the engine's collection, stops
    it."""
    while True:
        try:
            snap = q.get(timeout=_PUBLISH_POLL_S)
        except _queue.Empty:
            if engine_ref() is None:
                return
            continue
        try:
            if snap is None:
                return
            engine = engine_ref()
            if engine is not None:
                engine._publish(snap)
        finally:
            snap = engine = None      # hold neither while waiting
            q.task_done()
