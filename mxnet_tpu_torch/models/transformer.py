"""Transformer language model.

Counterpart of ``mxnet_tpu/models/transformer.py``: ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerLM`` as ``nn.Module``s with
the same parameter structure (``HybridBlock``s with forwards on
tensors; see ``gluon.block``) (``qkv``/``proj``/``ffn_up``/``ffn_down``,
pre-norm blocks) and the same incremental-decode contract: ``forward``,
``forward_kv``, ``prefill``, ``init_cache``, ``step`` and the multi-token
``prefill_chunk`` (``step_chunk`` in the layers) behind chunked prefill,
the prefix cache's suffix fill and the speculative verify. Attention routes
through :func:`~mxnet_tpu_torch.ops.nn.dot_product_attention` in the
``(B, S, H, D)`` layout, so every prefill on the card reaches the CUDA
flash kernel, and the decode and chunk steps (their keys are the cache,
their mask per query) take the plain path, as in the reference. In training mode the residual dropout is the reference's
lowbias32 ``Dropout`` (``gluon.nn.Dropout``, keys from
:mod:`mxnet_tpu_torch.random`) and attention dropout runs inside the flash
kernel, seeded from :func:`mxnet_tpu_torch.random.default_generator`.

Unlike the reference's functional ``step`` and ``prefill_chunk``, the port
writes the new K/V into the cache tensors in place (the new rows only
instead of a copy of the whole cache) and returns the same tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import random as _random
from ..context import default_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import generation_ops as _gen
from ..ops import nn as _ops

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerLM",
           "transformer_lm_tiny", "transformer_lm_small",
           "transformer_lm_base"]


class MultiHeadAttention(HybridBlock):

    def __init__(self, units, num_heads, dropout=0.0, causal=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        assert units % num_heads == 0
        device = default_device(device)
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        self._causal = causal
        self.qkv = Dense(3 * units, units, use_bias=False, flatten=False,
                         device=device, dtype=dtype)
        self.proj = Dense(units, units, use_bias=False, flatten=False,
                          device=device, dtype=dtype)

    def _split_qkv(self, x):
        """q, k, v as ``(B, T, H, D)`` views of one qkv projection."""
        B, T, C = x.shape
        H = self._num_heads
        qkv = self.qkv(x).reshape(B, T, 3, H, C // H)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = self._split_qkv(x)
        out = _ops.dot_product_attention(
            q, k, v, dropout=self._dropout, causal=self._causal,
            layout="BSHD", generator=_random.default_generator(),
            train=self.training)
        return self.proj(out.reshape(B, T, C))

    def forward_kv(self, x, kv_mask=None):
        """Full-prefix forward that also returns this layer's K/V:
        ``(out (B, T, C), k (B, T, H, D), v (B, T, H, D))``. ``kv_mask``
        ``(B, T)`` (or BERT's ``(B, 1, 1, T)``) keeps the valid key
        positions (None = all)."""
        B, T, C = x.shape
        q, k, v = self._split_qkv(x)
        out = _ops.dot_product_attention(
            q, k, v, mask=kv_mask, dropout=self._dropout,
            causal=self._causal, layout="BSHD",
            generator=_random.default_generator(), train=self.training)
        return self.proj(out.reshape(B, T, C)), k, v

    def step(self, x, k_cache, v_cache, positions):
        """One decode step: ``x (B, 1, C)``; writes the new K/V into
        ``k_cache``/``v_cache (B, S, H, D)`` at ``positions (B,)`` in
        place, attends to every cached position ``<= positions[b]``, and
        returns ``(out (B, 1, C), k_cache, v_cache)``."""
        B, T, C = x.shape
        q, k, v = self._split_qkv(x)
        _gen.kv_cache_update(k_cache, k, positions)
        _gen.kv_cache_update(v_cache, v, positions)
        S = k_cache.shape[1]
        span = torch.arange(S, device=x.device).reshape(1, S)
        kv_mask = span < (positions.reshape(B, 1) + 1)
        # one-token query: validity lives in kv_mask, so causal is off
        out = _ops.dot_product_attention(
            q, k_cache, v_cache, mask=kv_mask, dropout=0.0, causal=False,
            layout="BSHD")
        return self.proj(out.reshape(B, 1, C)), k_cache, v_cache

    def step_chunk(self, x, k_cache, v_cache, start):
        """Append a chunk of ``C`` consecutive positions per row: ``x (B, C,
        units)`` starts at absolute position ``start[b]``; writes the
        chunk's K/V into ``k_cache``/``v_cache (B, S, H, D)`` at ``start``
        in place and attends query ``i`` to every cached position ``<=
        start[b] + i`` (causal within the chunk, full over the prefix).
        ``step`` is the ``C == 1`` case. Rows past the caller's valid count
        write garbage K/V that committed lengths keep masked."""
        B, C, _ = x.shape
        q, k, v = self._split_qkv(x)
        _gen.kv_cache_update(k_cache, k, start)
        _gen.kv_cache_update(v_cache, v, start)
        S = k_cache.shape[1]
        span = torch.arange(S, device=x.device).reshape(1, 1, S)
        qpos = start.reshape(B, 1, 1) + \
            torch.arange(C, device=x.device).reshape(1, C, 1)
        kv_mask = (span < qpos + 1).reshape(B, 1, C, S)
        out = _ops.dot_product_attention(
            q, k_cache, v_cache, mask=kv_mask, dropout=0.0, causal=False,
            layout="BSHD")
        return self.proj(out.reshape(B, C, self._units)), k_cache, v_cache


class TransformerEncoderLayer(HybridBlock):
    """Pre-norm block (attention + MLP)."""

    def __init__(self, units, num_heads, hidden_size, dropout=0.0,
                 causal=True, device=None, dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(units, **kw)
        self.attn = MultiHeadAttention(units, num_heads, dropout, causal,
                                       **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.ffn_up = Dense(hidden_size, units, flatten=False, **kw)
        self.ffn_down = Dense(units, hidden_size, flatten=False, **kw)
        self.dropout = Dropout(dropout)

    def _ffn(self, x):
        h = _ops.gelu(self.ffn_up(self.ln2(x)))
        return x + self.dropout(self.ffn_down(h))

    def forward(self, x):
        return self._ffn(x + self.dropout(self.attn(self.ln1(x))))

    def forward_kv(self, x, kv_mask=None):
        a, k, v = self.attn.forward_kv(self.ln1(x), kv_mask)
        return self._ffn(x + self.dropout(a)), k, v

    def step(self, x, k_cache, v_cache, positions):
        a, k_cache, v_cache = self.attn.step(self.ln1(x), k_cache, v_cache,
                                             positions)
        return self._ffn(x + self.dropout(a)), k_cache, v_cache

    def step_chunk(self, x, k_cache, v_cache, start):
        a, k_cache, v_cache = self.attn.step_chunk(self.ln1(x), k_cache,
                                                   v_cache, start)
        return self._ffn(x + self.dropout(a)), k_cache, v_cache


class TransformerLM(HybridBlock):
    """Decoder-only LM: embed -> N blocks -> norm -> logits.

    Built on ``device`` (CUDA when None; raises without one) in
    ``dtype``. Token ids may be any integer dtype."""

    def __init__(self, vocab_size, units=256, num_layers=4, num_heads=8,
                 hidden_size=None, max_len=2048, dropout=0.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = default_device(device)
        hidden_size = hidden_size or 4 * units
        self._units = units
        self._max_len = max_len
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(vocab_size, units, **kw)
        self.pos_embed = Embedding(max_len, units, **kw)
        self.blocks = nn.ModuleList(
            TransformerEncoderLayer(units, num_heads, hidden_size, dropout,
                                    **kw)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(units, **kw)
        self.head = Dense(vocab_size, units, use_bias=False, flatten=False,
                          **kw)

    def forward(self, tokens):
        """``tokens (B, T)`` -> logits ``(B, T, vocab)``."""
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x))

    # ---- incremental decode (KV-cache) path -------------------------------
    @property
    def num_heads(self):
        return self.blocks[0].attn._num_heads

    @property
    def head_dim(self):
        return self._units // self.num_heads

    @property
    def num_layers(self):
        return len(self.blocks)

    @property
    def max_len(self):
        return self._max_len

    @property
    def device(self):
        return self.head.weight.device

    @property
    def dtype(self):
        return self.head.weight.dtype

    def init_cache(self, batch_size, max_len=None, dtype=None):
        """Zeroed per-layer caches ``[(k, v), ...]``, each
        ``(batch_size, max_len, heads, head_dim)``."""
        S = int(max_len or self._max_len)
        shape = (int(batch_size), S, self.num_heads, self.head_dim)
        dtype = dtype or self.dtype
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(self.num_layers)]

    def prefill(self, tokens, lengths=None):
        """Fill a KV cache from a (padded) prompt in one forward pass.

        ``tokens (B, T)``; ``lengths (B,)`` valid lengths (None = all
        ``T``). Returns ``(logits (B, vocab), cache)``: the logits of each
        row's last valid position, and ``[(k, v), ...]`` with ``(B, T, H,
        D)`` tensors. Positions past ``lengths[b]`` hold garbage that later
        attention keeps masked."""
        B, T = tokens.shape
        pos = torch.arange(T, device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)
        if lengths is None:
            lengths = torch.full((B,), T, device=tokens.device)
        lengths = lengths.to(tokens.device).long()
        kv_mask = pos.reshape(1, T) < lengths.reshape(B, 1)
        cache = []
        for blk in self.blocks:
            x, k, v = blk.forward_kv(x, kv_mask)
            cache.append((k, v))
        x = self.ln_f(x)
        h_last = x[torch.arange(B, device=x.device), lengths - 1]
        return self.head(h_last), cache

    def prefill_chunk(self, tokens, cache, start):
        """Append a chunk of ``C`` tokens per row at per-row offsets:
        ``tokens (B, C)`` whose first element sits at absolute position
        ``start[b]``; ``cache`` holds ``start[b]`` committed positions per
        row. Writes the chunk's K/V into the cache in place; returns
        ``(logits (B, C, vocab), cache)``, ``logits[b, i]`` the next-token
        distribution after ``tokens[b, :i + 1]``. Positions clamp at
        ``max_len - 1`` for the position embedding only (pad rows of a
        final chunk may run past it; their rows are garbage either
        way)."""
        B, C = tokens.shape
        start = start.to(tokens.device).long()
        pos = start.reshape(B, 1) + \
            torch.arange(C, device=tokens.device).reshape(1, C)
        pos = pos.clamp_max(self._max_len - 1)
        x = self.embed(tokens) + self.pos_embed(pos)
        for (k_c, v_c), blk in zip(cache, self.blocks):
            x, _, _ = blk.step_chunk(x, k_c, v_c, start)
        return self.head(self.ln_f(x)), cache

    def step(self, tokens, cache, lengths):
        """One decode step for a batch: ``tokens (B, 1)``, ``cache`` as from
        :meth:`init_cache`, ``lengths (B,)`` positions already cached (the
        position each new token is written at). Writes the new K/V into the
        cache in place; returns ``(logits (B, vocab), cache)``."""
        B = tokens.shape[0]
        lengths = lengths.to(tokens.device).long()
        x = self.embed(tokens) + self.pos_embed(lengths.reshape(B, 1))
        for (k_c, v_c), blk in zip(cache, self.blocks):
            x, _, _ = blk.step(x, k_c, v_c, lengths)
        x = self.ln_f(x)
        return self.head(x.reshape(B, self._units)), cache


def tp_rules():
    """Megatron-style tensor-parallel rules for ``TransformerLM`` (and
    BERT) parameters, by their reference names: ``[(regex,
    PartitionSpec)]`` for ``ShardedTrainer(param_rules=...)``. A device
    holds 1/tp of each parameter they name; the compute is not split yet
    (ROADMAP lead: Megatron column and row parallel)."""
    from ..parallel.mesh import PartitionSpec as P
    return [
        (r"qkv_weight$", P("tp", None)),       # column parallel (out, in)
        (r"ffn_up_weight$", P("tp", None)),
        (r"proj_weight$", P(None, "tp")),      # row parallel
        (r"ffn_down_weight$", P(None, "tp")),
        (r"embed_weight$", P(None, "tp")),
        (r"head_weight$", P("tp", None)),
    ]


def transformer_lm_tiny(vocab_size=1024, **kwargs):
    return TransformerLM(vocab_size, units=64, num_layers=2, num_heads=4,
                         max_len=256, **kwargs)


def transformer_lm_small(vocab_size=32000, **kwargs):
    return TransformerLM(vocab_size, units=512, num_layers=8, num_heads=8,
                         **kwargs)


def transformer_lm_base(vocab_size=32000, **kwargs):
    """BERT-base scale (~110M) decoder: units 768, 12 layers, 12 heads."""
    return TransformerLM(vocab_size, units=768, num_layers=12, num_heads=12,
                         **kwargs)
