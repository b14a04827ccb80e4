"""Ring attention: exact attention over sequence-sharded inputs;
counterpart of ``mxnet_tpu/parallel/ring_attention.py``.

Each position of the ``sp`` axis holds Q for its sequence shard; the K/V
shards rotate one step around the ring per block (:func:`~.mesh.ppermute`)
while each position folds the block into an online softmax kept in
float32, with the reference's guards: a fully masked row gives ``corr =
0`` (never ``exp(-inf - -inf)``), and the output divides by
``max(row_sum, 1e-20)``. The causal mask of a block is built from the
block's source index. Plain tensor code, as in the reference (it is no
Pallas kernel there).
"""
from __future__ import annotations

import math

import torch

from .mesh import NamedSharding, PartitionSpec, ShardedTensor, ppermute

__all__ = ["ring_attention", "ring_attention_sharded"]


def _block_attn(q, k, v, acc, row_max, row_sum, causal_mask):
    """One (Q block x KV block) tile folded into the online softmax."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if causal_mask is not None:
        s = torch.where(causal_mask, s, torch.tensor(-math.inf,
                                                     device=s.device))
    new_max = torch.maximum(row_max, torch.amax(s, dim=-1))
    safe = torch.isfinite(new_max)
    corr = torch.where(safe, torch.exp(row_max - new_max),
                       torch.zeros((), device=s.device))
    p = torch.exp(s - new_max[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros((), device=s.device))
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    acc = acc * corr[..., None] + pv
    row_sum = row_sum * corr + torch.sum(p, dim=-1)
    return acc, new_max, row_sum


def ring_attention(qs, ks, vs, mesh, axis_name="sp", causal=False):
    """Attention of per-position shards ``qs``, ``ks``, ``vs`` (lists over
    the mesh's positions, each ``(batch, heads, seq_shard, dim)``; the
    port's form of the reference's call inside ``shard_map``). Returns the
    per-position output shards."""
    n = mesh.shape[axis_name]
    idx = [mesh.coords(p)[axis_name] for p in range(mesh.size)]
    S = qs[0].shape[2]
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    row_max = [torch.full(q.shape[:-1], -math.inf, device=q.device)
               for q in qs]
    row_sum = [torch.zeros(q.shape[:-1], device=q.device) for q in qs]
    k_blk, v_blk = list(ks), list(vs)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n):
        for p, q in enumerate(qs):
            mask = None
            if causal:
                src = (idx[p] - i) % n    # the shard this K/V block is
                ar = torch.arange(S, device=q.device)
                mask = ((idx[p] * S + ar)[:, None]
                        >= (src * S + ar)[None, :])[None, None]
            acc[p], row_max[p], row_sum[p] = _block_attn(
                q, k_blk[p], v_blk[p], acc[p], row_max[p], row_sum[p], mask)
        k_blk = ppermute(k_blk, mesh, axis_name, perm)
        v_blk = ppermute(v_blk, mesh, axis_name, perm)
    return [(a / torch.clamp_min(r[..., None], 1e-20)).to(q.dtype)
            for a, r, q in zip(acc, row_sum, qs)]


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           batch_axis="dp"):
    """Shard ``(B, H, S, D)`` tensors over ``mesh`` (batch over
    ``batch_axis``, sequence over ``axis_name``), run
    :func:`ring_attention`, and return the output gathered whole (on the
    first position's device)."""
    sharding = NamedSharding(mesh, PartitionSpec(batch_axis, None,
                                                 axis_name, None))
    qs, ks, vs = (ShardedTensor.place(t, sharding) for t in (q, k, v))
    outs = ring_attention(qs.shards, ks.shards, vs.shards, mesh,
                          axis_name=axis_name, causal=causal)
    out = ShardedTensor(outs, sharding, q.shape, q.dtype).full()
    # a lost sp peer would wedge the K/V ring: the collective watchdog
    # bounds the wait (free unless its deadline knob is set)
    from ..resilience.elastic import guard_wait
    return guard_wait(out, op="ring.dispatch")
