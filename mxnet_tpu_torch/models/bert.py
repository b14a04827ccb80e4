"""BERT for masked-LM + next-sentence pretraining.

Counterpart of ``mxnet_tpu/models/bert.py`` (``_MaskedAttention``,
``_BERTLayer``, ``BERTEncoder``, ``BERTModel``, ``BERTPretrainingLoss``,
``bert_tiny``, ``bert_base``) as ``nn.Module``s with the same parameter
structure, and of the pretraining step of
``example/bert/pretrain_bert.py`` (``synthetic_batch``, ``PretrainStep``,
``PretrainLoss``). Attention is bidirectional: every layer calls
:func:`~mxnet_tpu_torch.ops.nn.dot_product_attention` with
``causal=False`` in the ``(B, S, H, D)`` layout, so on the card it runs
the CUDA flash kernels, with the ``(B, 1, 1, T)`` keep mask that a
``valid_len`` makes reduced to the kernels' ``(B, S)`` key mask. In
training mode attention dropout runs inside the kernel and the residual
dropout is the lowbias32 ``Dropout``, as in ``models/transformer.py``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..context import default_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import nn as _ops
from .transformer import MultiHeadAttention, tp_rules  # noqa: F401

__all__ = ["BERTModel", "BERTEncoder", "bert_tiny", "bert_base",
           "BERTPretrainingLoss", "PretrainStep", "PretrainLoss",
           "synthetic_batch"]


def _gather_positions(x, positions):
    """The ``(B*M, ...)`` rows of ``x (B, T, ...)`` at ``positions (B, M)``
    (any real dtype: the reference's positions arrive as float32)."""
    B, M = positions.shape
    rows = torch.arange(B, device=x.device).reshape(B, 1).expand(B, M)
    return x[rows.reshape(-1), positions.reshape(-1).long()]


def _pick(data, index):
    """``data[..., index]`` along the last axis (the reference's ``pick``)."""
    return data.gather(-1, index.long().unsqueeze(-1)).squeeze(-1)


class _MaskedAttention(MultiHeadAttention):
    """MultiHeadAttention with a padding keep-mask (bidirectional)."""

    def __init__(self, units, num_heads, dropout=0.0, device=None,
                 dtype=torch.float32):
        super().__init__(units, num_heads, dropout=dropout, causal=False,
                         device=device, dtype=dtype)

    def forward(self, x, mask=None):
        return self.forward_kv(x, mask)[0]


class _BERTLayer(HybridBlock):
    """Post-norm encoder block (BERT convention: residual -> LayerNorm)."""

    def __init__(self, units, num_heads, hidden_size, dropout=0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=default_device(device), dtype=dtype)
        self.attn = _MaskedAttention(units, num_heads, dropout, **kw)
        self.ln1 = LayerNorm(units, **kw)
        self.ffn_up = Dense(hidden_size, units, flatten=False, **kw)
        self.ffn_down = Dense(units, hidden_size, flatten=False, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, mask)))
        h = _ops.gelu(self.ffn_up(x))
        return self.ln2(x + self.dropout(self.ffn_down(h)))


class BERTEncoder(HybridBlock):
    """Token + segment + learned-position embeddings -> N encoder blocks.

    A ``valid_len (B,)`` becomes the ``(B, 1, 1, T)`` keep mask: every
    query attends to the keys before its row's length."""

    def __init__(self, vocab_size, units, num_layers, num_heads,
                 hidden_size, max_length=512, num_segments=2, dropout=0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=default_device(device), dtype=dtype)
        self.word_embed = Embedding(vocab_size, units, **kw)
        self.segment_embed = Embedding(num_segments, units, **kw)
        self.pos_embed = Embedding(max_length, units, **kw)
        self.ln = LayerNorm(units, **kw)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            _BERTLayer(units, num_heads, hidden_size, dropout, **kw)
            for _ in range(num_layers))

    def forward(self, tokens, segments, valid_len=None):
        B, T = tokens.shape
        pos = torch.arange(T, device=tokens.device).reshape(1, T)
        x = self.word_embed(tokens) + self.segment_embed(segments) \
            + self.pos_embed(pos)
        x = self.dropout(self.ln(x))
        mask = None
        if valid_len is not None:
            valid_len = torch.as_tensor(valid_len, device=tokens.device)
            mask = pos.reshape(1, 1, 1, T) < valid_len.reshape(B, 1, 1, 1)
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Encoder + pooler + MLM decoder + NSP classifier (pretraining heads).

    Forward returns ``(sequence_output, pooled, mlm_logits, nsp_logits)``.
    With ``masked_positions (B, M)`` the MLM head runs on the ``B*M``
    gathered rows only and ``mlm_logits`` is ``(B, M, vocab)``; without,
    on every position, ``(B, T, vocab)``. The decoder is not tied to the
    word embedding."""

    def __init__(self, vocab_size=30522, units=768, num_layers=12,
                 num_heads=12, hidden_size=3072, max_length=512,
                 num_segments=2, dropout=0.1, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=default_device(device), dtype=dtype)
        self.vocab_size = vocab_size
        self.encoder = BERTEncoder(vocab_size, units, num_layers, num_heads,
                                   hidden_size, max_length, num_segments,
                                   dropout, **kw)
        self.pooler = Dense(units, units, flatten=False, **kw)
        self.mlm_transform = Dense(units, units, flatten=False, **kw)
        self.mlm_ln = LayerNorm(units, **kw)
        self.mlm_decoder = Dense(vocab_size, units, flatten=False, **kw)
        self.nsp = Dense(2, units, flatten=False, **kw)

    def forward(self, tokens, segments, valid_len=None,
                masked_positions=None):
        seq = self.encoder(tokens, segments, valid_len)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        if masked_positions is not None:
            # gather first: the MLM transform and the vocab decoder run on
            # the M masked slots only
            B, M = masked_positions.shape
            picked = _gather_positions(seq, masked_positions).reshape(B, M,
                                                                      -1)
            h = _ops.gelu(self.mlm_transform(picked))
        else:
            h = _ops.gelu(self.mlm_transform(seq))
        mlm_logits = self.mlm_decoder(self.mlm_ln(h))
        return seq, pooled, mlm_logits, self.nsp(pooled)


class BERTPretrainingLoss(HybridBlock):
    """Masked-LM + next-sentence loss, op for op as the reference in the
    logits' dtype. ``mlm_positions (B, M)`` selects the masked slots;
    ``mlm_weights`` zeroes padding in M.

    ``picked=True`` declares that ``mlm_logits`` is already ``(B, M, V)``
    from the model's gather-first decode (``masked_positions`` passed to
    ``BERTModel``)."""

    def __init__(self, picked=False):
        super().__init__()
        self._picked = picked

    def forward(self, mlm_logits, nsp_logits, mlm_labels, mlm_positions,
                mlm_weights, nsp_labels):
        B, M = mlm_positions.shape
        V = mlm_logits.shape[-1]
        if self._picked:
            if mlm_logits.shape[1] != M:
                raise ValueError("picked=True expects (B, M, V) logits, got "
                                 "%s for M=%d" % (tuple(mlm_logits.shape), M))
            picked = mlm_logits.reshape(B * M, V)
        else:
            picked = _gather_positions(mlm_logits, mlm_positions)
        ll = _pick(_ops.log_softmax(picked), mlm_labels.reshape(-1))
        w = mlm_weights.reshape(-1)
        mlm_loss = -(ll * w).sum() / (w.sum() + 1e-6)
        nsp_loss = -_pick(_ops.log_softmax(nsp_logits), nsp_labels).mean()
        return mlm_loss + nsp_loss


def bert_tiny(vocab_size=1000, max_length=128, **kwargs):
    """2-layer/128-unit config for tests."""
    return BERTModel(vocab_size=vocab_size, units=128, num_layers=2,
                     num_heads=2, hidden_size=512, max_length=max_length,
                     dropout=0.0, **kwargs)


def bert_base(vocab_size=30522, **kwargs):
    """BERT-base: 12 layers x 768 units x 12 heads, hidden 3072, dropout
    0.1."""
    return BERTModel(vocab_size=vocab_size, units=768, num_layers=12,
                     num_heads=12, hidden_size=3072, **kwargs)


# ---- the pretraining step of example/bert/pretrain_bert.py ---------------

def synthetic_batch(rng, batch, seq_len, vocab, n_masks):
    """A synthetic pretraining batch from the numpy ``rng``, all float32:
    ``(masked tokens, segments, positions, labels, weights, nsp labels)``
    (``example/bert/pretrain_bert.py:synthetic_batch``; [MASK] is 3)."""
    tokens = rng.integers(4, vocab, (batch, seq_len)).astype("float32")
    segments = np.zeros((batch, seq_len), "float32")
    segments[:, seq_len // 2:] = 1.0
    positions = np.stack([rng.choice(seq_len, n_masks, replace=False)
                          for _ in range(batch)]).astype("float32")
    labels = np.take_along_axis(tokens, positions.astype(int), axis=1)
    masked = tokens.copy()
    np.put_along_axis(masked, positions.astype(int), 3.0, axis=1)
    weights = np.ones((batch, n_masks), "float32")
    nsp = rng.integers(0, 2, (batch,)).astype("float32")
    return masked, segments, positions, labels, weights, nsp


class PretrainStep(nn.Module):
    """The whole pretraining loss inside one module, so that a trainer sees
    a scalar output (``example/bert/pretrain_bert.py:PretrainStep``):
    inputs ``(tokens, segments, positions, labels, weights, nsp_labels)``,
    the model called with ``valid_len=None`` and the gather-first MLM
    decode."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert
        self.loss = BERTPretrainingLoss(picked=True)

    def forward(self, tokens, segments, positions, labels, weights,
                nsp_labels):
        _, _, mlm_logits, nsp_logits = self.bert(tokens, segments, None,
                                                 positions)
        return self.loss(mlm_logits, nsp_logits, labels, positions, weights,
                         nsp_labels)


class PretrainLoss:
    """Identity: :class:`PretrainStep` already produced the scalar loss
    (the label a trainer passes is unused)."""

    def __call__(self, out, _dummy):
        return out
