"""Stage-stacked Mixture-of-Experts transformer LM: counterpart of
``mxnet_tpu/models/moe_transformer.py``.

Every per-layer parameter is one tensor with a leading ``n_stages`` axis
(``stack_*``), and the expert FFN weights carry ``(n_stages, n_experts,
...)`` leading axes (``stack_expert_*``), so a
:class:`~mxnet_tpu_torch.parallel.ShardingPlan`'s regex rules place the
whole model (``P('pp')`` and ``P('pp', 'ep')``). The MoE FFN is
:func:`~mxnet_tpu_torch.ops.contrib_misc.moe_ffn` (Switch top-1 routing,
static capacity) over the whole token pool. Inside a mesh step whose
replicas split the batch, each layer gathers the replicas' tokens first
and keeps its own rows of the result, so the routing (capacity, token
positions) is the global batch's, as in the reference's SPMD program.
Each replica computes the MoE FFN over the whole pool, so over ``n``
replicas the FFN's compute is ``n`` times the one-device step's (ep does
not split the experts yet: ROADMAP lead).
The load-balancing aux loss of the last forward is :meth:`aux_loss`; the
default objective leaves it out.

The model is built as the reference's (``params.get`` under the block's
name scope, made by ``initialize``; the embeddings and the head are
deferred to the first call's context), so its parameters carry the
reference's names and a plan's rules, ``convert.load_mxnet_params`` and
``collect_params().initialize(Xavier())`` treat it as the reference's.
Attention is causal and dropout-free. ``prefill``/``prefill_chunk``/
``step`` are the KV-cache decode contract of ``TransformerLM``.
"""
from __future__ import annotations

import math

import torch

from ..gluon.block import HybridBlock
from ..gluon import nn
from ..ops import _collective
from ..ops import generation_ops as _gen
from ..ops import nn as _ops
from ..ops.contrib_misc import moe_ffn

__all__ = ["MoETransformerLM", "moe_lm_tiny"]


def _ln(x, gamma, beta, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


_STACKS = ("stack_ln1_gamma", "stack_ln1_beta", "stack_ln2_gamma",
           "stack_ln2_beta", "stack_qkv_weight", "stack_proj_weight",
           "stack_gate_weight", "stack_expert_w1", "stack_expert_w2")


class MoETransformerLM(HybridBlock):
    """Decoder-only LM: embed -> ``num_layers`` x [attention + MoE FFN]
    -> logits, every per-layer parameter stacked on a leading
    ``num_layers`` axis."""

    def __init__(self, vocab_size=64, units=32, num_heads=2, num_layers=2,
                 hidden_size=None, n_experts=4, max_len=64,
                 capacity_factor=2.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        hidden_size = hidden_size or 2 * units
        assert units % num_heads == 0
        self._units = units
        self._num_heads = num_heads
        self._num_layers = num_layers
        self._n_experts = n_experts
        self._capacity_factor = capacity_factor
        self._max_len = max_len
        self._aux = None
        L, D, H, E = num_layers, units, hidden_size, n_experts
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, units, prefix="embed_")
            self.pos_embed = nn.Embedding(max_len, units, prefix="pos_")
            self.head = nn.Dense(vocab_size, flatten=False, use_bias=False,
                                 in_units=units, prefix="head_")
            get = self.params.get
            self.stack_ln1_gamma = get("stack_ln1_gamma", shape=(L, D),
                                       init="ones")
            self.stack_ln1_beta = get("stack_ln1_beta", shape=(L, D),
                                      init="zeros")
            self.stack_ln2_gamma = get("stack_ln2_gamma", shape=(L, D),
                                       init="ones")
            self.stack_ln2_beta = get("stack_ln2_beta", shape=(L, D),
                                      init="zeros")
            self.stack_qkv_weight = get("stack_qkv_weight",
                                        shape=(L, D, 3 * D))
            self.stack_proj_weight = get("stack_proj_weight",
                                         shape=(L, D, D))
            self.stack_gate_weight = get("stack_gate_weight",
                                         shape=(L, D, E))
            self.stack_expert_w1 = get("stack_expert_w1",
                                       shape=(L, E, D, H))
            self.stack_expert_w2 = get("stack_expert_w2",
                                       shape=(L, E, H, D))

    @property
    def n_experts(self):
        return self._n_experts

    @property
    def num_layers(self):
        return self._num_layers

    @property
    def num_heads(self):
        return self._num_heads

    @property
    def head_dim(self):
        return self._units // self._num_heads

    @property
    def units(self):
        return self._units

    @property
    def max_len(self):
        return self._max_len

    def profile(self, batch, seq, **kwargs):
        """The planner's ``ModelProfile`` at one batch geometry."""
        from ..parallel.planner import ModelProfile
        return ModelProfile.from_block(self, batch, seq=seq,
                                       d_model=self._units, **kwargs)

    def aux_loss(self):
        """The Switch load-balancing aux loss summed over the stages of
        the last forward."""
        return self._aux

    def _slabs(self):
        return [self._parameters[n] for n in _STACKS]

    def _moe(self, x, gate_w, w1, w2):
        # in a mesh step's replica: route the global token pool
        pool, own = _collective.batch_gather(x)
        y, aux = moe_ffn(pool, gate_w, w1, w2, self._capacity_factor)
        return y[own], aux

    def _attn(self, x, qkv_w, proj_w):
        B, T, D = x.shape
        hd = D // self._num_heads
        qkv = (x @ qkv_w).reshape(B, T, 3, self._num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=x.device).tril()
        s = s.masked_fill(~causal, -math.inf)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
        return out.transpose(1, 2).reshape(B, T, D) @ proj_w

    def _embed(self, tokens, pos):
        return self.embed(tokens) + self.pos_embed(pos)

    def forward(self, tokens):
        """``tokens (B, T)`` -> logits ``(B, T, vocab)``."""
        T = tokens.shape[1]
        x = self._embed(tokens, torch.arange(T, device=tokens.device))
        g1, b1, g2, b2, qkv_w, proj_w, gate_w, w1, w2 = self._slabs()
        aux_total = 0.0
        for i in range(self._num_layers):
            x = x + self._attn(_ln(x, g1[i], b1[i]), qkv_w[i], proj_w[i])
            y, aux = self._moe(_ln(x, g2[i], b2[i]), gate_w[i], w1[i], w2[i])
            x = x + y
            aux_total = aux_total + aux
        self._aux = aux_total
        return self.head(x)

    # ---- incremental decode (KV-cache) path -------------------------------

    def init_cache(self, batch_size, max_len=None, dtype=None):
        """Zeroed per-layer caches ``[(k, v), ...]``, each ``(batch_size,
        max_len, heads, head_dim)``."""
        w = self._parameters["stack_qkv_weight"]
        S = int(max_len or self._max_len)
        shape = (int(batch_size), S, self.num_heads, self.head_dim)
        return [(torch.zeros(shape, dtype=dtype or w.dtype, device=w.device),
                 torch.zeros(shape, dtype=dtype or w.dtype, device=w.device))
                for _ in range(self._num_layers)]

    def _split_qkv(self, x, qkv_w):
        B, T, D = x.shape
        qkv = (x @ qkv_w).reshape(B, T, 3, self._num_heads, self.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _ffn(self, x, i, slabs):
        g2, b2, gate_w, w1, w2 = (slabs[2], slabs[3], slabs[6], slabs[7],
                                  slabs[8])
        y, _ = moe_ffn(_ln(x, g2[i], b2[i]), gate_w[i], w1[i], w2[i],
                       self._capacity_factor)
        return x + y

    def prefill(self, tokens, lengths=None):
        """Fill a KV cache from a (padded) prompt in one forward: returns
        ``(logits (B, vocab) at each row's last valid position, cache)``."""
        B, T = tokens.shape
        pos = torch.arange(T, device=tokens.device)
        x = self._embed(tokens, pos)
        if lengths is None:
            lengths = torch.full((B,), T, device=tokens.device)
        lengths = lengths.to(tokens.device).long()
        kv_mask = pos.reshape(1, T) < lengths.reshape(B, 1)
        slabs = self._slabs()
        cache = []
        for i in range(self._num_layers):
            q, k, v = self._split_qkv(_ln(x, slabs[0][i], slabs[1][i]),
                                      slabs[4][i])
            out = _ops.dot_product_attention(q, k, v, mask=kv_mask,
                                             causal=True, layout="BSHD")
            x = x + out.reshape(B, T, self._units) @ slabs[5][i]
            x = self._ffn(x, i, slabs)
            cache.append((k, v))
        h_last = x[torch.arange(B, device=x.device), lengths - 1]
        return self.head(h_last), cache

    def _incremental(self, tokens, cache, start, chunk):
        B, C = tokens.shape
        start = start.to(tokens.device).long()
        if chunk:
            pos = start.reshape(B, 1) + \
                torch.arange(C, device=tokens.device).reshape(1, C)
            pos = pos.clamp_max(self._max_len - 1)
        else:
            pos = start.reshape(B, 1)
        x = self._embed(tokens, pos)
        slabs = self._slabs()
        for i, (k_c, v_c) in enumerate(cache):
            q, k, v = self._split_qkv(_ln(x, slabs[0][i], slabs[1][i]),
                                      slabs[4][i])
            _gen.kv_cache_update(k_c, k, start)
            _gen.kv_cache_update(v_c, v, start)
            S = k_c.shape[1]
            span = torch.arange(S, device=x.device).reshape(1, 1, S)
            qpos = start.reshape(B, 1, 1) + \
                torch.arange(C, device=x.device).reshape(1, C, 1)
            kv_mask = (span < qpos + 1).reshape(B, 1, C, S)
            out = _ops.dot_product_attention(q, k_c, v_c, mask=kv_mask,
                                             causal=False, layout="BSHD")
            x = x + out.reshape(B, C, self._units) @ slabs[5][i]
            x = self._ffn(x, i, slabs)
        return x, cache

    def prefill_chunk(self, tokens, cache, start):
        """Append ``C`` tokens per row at per-row offsets ``start``
        (written into the cache in place): ``(logits (B, C, vocab),
        cache)``."""
        x, cache = self._incremental(tokens, cache, start, chunk=True)
        return self.head(x), cache

    def step(self, tokens, cache, lengths):
        """One decode step: ``tokens (B, 1)`` at positions ``lengths``:
        ``(logits (B, vocab), cache)``."""
        B = tokens.shape[0]
        x, cache = self._incremental(tokens, cache, lengths, chunk=False)
        return self.head(x.reshape(B, self._units)), cache


def moe_lm_tiny(vocab_size=64, n_experts=4, num_layers=2, **kwargs):
    """The test configuration: 2 stages x 4 experts (factorable as
    dp x pp2 x ep{1,2,4} on an 8-device pool)."""
    return MoETransformerLM(vocab_size, units=32, num_heads=2,
                            num_layers=num_layers, n_experts=n_experts,
                            max_len=64, **kwargs)
