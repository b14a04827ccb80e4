"""Interleaved-projection attention matmuls: counterpart of
``mxnet_tpu/ops/transformer_ops.py`` (the reference's
``src/operator/contrib/transformer.cc`` ops that GluonNLP's BERT uses).

Layout, as the reference's: the last dim of ``queries_keys_values`` is
``(heads, 3, head_dim)``, a contiguous ``[q|k|v]`` block a head (``[k|v]``
for the encoder-decoder ops); attention batches are sequence-major and
head-minor, row ``b * heads + h``. Scores are scaled by ``1/sqrt(head_dim)``
on the queries, in their dtype, before the product. Each op is one
``torch.einsum`` (a batched GEMM).
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt"]


def _scaled(q, d):
    return q * torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype,
                            device=q.device)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=("interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """``(seq, batch, 3*heads*head_dim)`` -> scaled ``Q K^T`` scores
    ``(batch*heads, seq, seq)``."""
    S, B, P = queries_keys_values.shape
    D = P // (3 * heads)
    qkv = queries_keys_values.reshape(S, B, heads, 3, D)
    q, k = qkv[..., 0, :], qkv[..., 1, :]
    att = torch.einsum("qbhd,kbhd->bhqk", _scaled(q, D), k)
    return att.reshape(B * heads, S, S)


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=("interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """``attention (batch*heads, seq, seq) @ V`` -> ``(seq, batch,
    heads*head_dim)``."""
    S, B, P = queries_keys_values.shape
    D = P // (3 * heads)
    v = queries_keys_values.reshape(S, B, heads, 3, D)[..., 2, :]
    att = attention.reshape(B, heads, S, S)
    return torch.einsum("bhqk,kbhd->qbhd", att, v).reshape(S, B, heads * D)


@register("_contrib_interleaved_matmul_encdec_qk",
          aliases=("interleaved_matmul_encdec_qk",))
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """``queries (q_seq, batch, heads*head_dim)``, ``keys_values (kv_seq,
    batch, 2*heads*head_dim)`` -> scaled scores ``(batch*heads, q_seq,
    kv_seq)``."""
    Sq, B, E = queries.shape
    D = E // heads
    Sk = keys_values.shape[0]
    q = queries.reshape(Sq, B, heads, D)
    k = keys_values.reshape(Sk, B, heads, 2, D)[..., 0, :]
    att = torch.einsum("qbhd,kbhd->bhqk", _scaled(q, D), k)
    return att.reshape(B * heads, Sq, Sk)


@register("_contrib_interleaved_matmul_encdec_valatt",
          aliases=("interleaved_matmul_encdec_valatt",))
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """``attention (batch*heads, q_seq, kv_seq) @ V`` -> ``(q_seq, batch,
    heads*head_dim)``."""
    Sk, B, P = keys_values.shape
    D = P // (2 * heads)
    v = keys_values.reshape(Sk, B, heads, 2, D)[..., 1, :]
    Sq = attention.shape[1]
    att = attention.reshape(B, heads, Sq, Sk)
    return torch.einsum("bhqk,kbhd->qbhd", att, v).reshape(Sq, B, heads * D)
