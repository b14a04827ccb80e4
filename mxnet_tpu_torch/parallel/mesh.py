"""Device meshes, shardings and the collectives over a named axis:
counterpart of ``mxnet_tpu/parallel/mesh.py``.

A :class:`Mesh` is an array of **logical devices** (:class:`~mxnet_tpu_torch
.context.Context` objects) with named axes, in the reference's order ``dp, pp,
ep, tp, sp``. One physical device may stand at several positions:
``make_mesh(dp=2, tp=2, devices=[mx.gpu(0)] * 4)`` is four positions on one
card, and the tests' ``[mx.cpu(i) for i in range(8)]`` eight on the CPU,
as the reference's tests get 8 CPU devices from XLA's forced host device
count. The port's process holds every position.

A :class:`ShardedTensor` is one value over a mesh: one owned tensor per
mesh position (its :class:`NamedSharding`'s chunk), never a view of
another position's (the port's optimizers update in place), and
:meth:`ShardedTensor.full` gathers it whole.

The collectives work on per-position lists of tensors (index = the
position's flat index in the mesh): :func:`all_reduce` (sum or mean),
:func:`all_gather`, :func:`reduce_scatter`, :func:`all_to_all` and
:func:`ppermute` over one axis or a tuple of axes. Every sum adds the
positions in mesh order, with no atomics, so results repeat bit for bit;
every shard moves with ``.to(target)``, which costs nothing on the same
device, so one code path serves logical positions of one card and distinct
GPUs. The results are differentiable (autograd sees ``.to``, ``+`` and
``cat``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..context import Context, _no_cuda, cpu, gpu, num_local_cpus

__all__ = ["MeshConfig", "Mesh", "make_mesh", "current_mesh", "set_mesh",
           "replicated", "batch_sharding", "PartitionSpec", "NamedSharding",
           "ShardedTensor", "all_reduce", "all_gather", "reduce_scatter",
           "all_to_all", "ppermute", "AXES"]

_CURRENT = [None]

AXES = ("dp", "pp", "ep", "tp", "sp")


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None`` (not split), an axis name, or a
    tuple of names (split over their product, the first outermost).
    Trailing ``None`` entries are implied."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)

    def dim_axes(self, dim):
        """The axis names that split dimension ``dim``."""
        entry = self[dim] if dim < len(self) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def normalized(self):
        parts = list(self)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(p if p is None or isinstance(p, str) else tuple(p)
                     for p in parts)


class MeshConfig:
    """Sizes per logical axis; -1 on dp means 'use remaining devices'."""

    def __init__(self, dp=-1, pp=1, ep=1, tp=1, sp=1):
        self.dp, self.pp, self.ep = dp, pp, ep
        self.tp, self.sp = tp, sp

    def resolve(self, n_devices):
        fixed = self.pp * self.ep * self.tp * self.sp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed:
                raise ValueError("device count %d not divisible by "
                                 "pp*ep*tp*sp=%d" % (n_devices, fixed))
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError("mesh %s does not cover %d devices" % (
                (dp, self.pp, self.ep, self.tp, self.sp), n_devices))
        return (dp, self.pp, self.ep, self.tp, self.sp)


def _context(d):
    if isinstance(d, Context):
        return d
    return Context.from_device(d)


class Mesh:
    """Logical devices in an array with named axes: ``Mesh(devices,
    axis_names)``, ``devices`` nested lists (or an object array) of
    contexts whose dimensions the names label."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError("mesh of %d dims with axis names %s"
                             % (arr.ndim, self.axis_names))
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = _context(d)
        self.devices = flat.reshape(arr.shape)

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv
                                      for kv in self.shape.items())

    def axis_size(self, axes):
        """The product of the sizes of ``axes`` (a name or a tuple); an
        axis the mesh lacks counts 1."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = self.shape
        n = 1
        for a in axes:
            n *= shape.get(a, 1)
        return n

    def coords(self, pos):
        """``{axis: index}`` of flat position ``pos``."""
        idx = np.unravel_index(pos, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def axis_index(self, pos, axes):
        """Row-major index of ``pos`` over ``axes`` (the first outermost);
        0 when ``axes`` is empty."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c, shape = self.coords(pos), self.shape
        i = 0
        for a in axes:
            if a in shape:
                i = i * shape[a] + c[a]
        return i

    def context(self, pos):
        return self.devices.reshape(-1)[pos]

    def device(self, pos):
        return self.context(pos).torch_device

    def groups(self, axes):
        """The positions grouped by every coordinate but ``axes``: each
        group lists the positions that differ only along ``axes``, ordered
        by :meth:`axis_index`."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = self.shape
        for a in axes:
            if a not in shape:
                raise ValueError("mesh %r has no axis %r" % (self, a))
        out = OrderedDict()
        for pos in range(self.size):
            c = self.coords(pos)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(pos)
        return [sorted(g, key=lambda p: self.axis_index(p, axes))
                for g in out.values()]


def make_mesh(dp=-1, pp=1, ep=1, tp=1, sp=1, devices=None):
    """A :class:`Mesh` over ``devices`` (contexts or torch devices; one
    may repeat), axes ``(dp, pp, ep, tp, sp)``; every visible GPU, one
    position each, when None (without CUDA: the launcher's
    ``MXTPU_LOCAL_DEVICES`` logical CPU devices, else it raises)."""
    if devices is None:
        if torch.cuda.is_available():
            devices = [gpu(i) for i in range(torch.cuda.device_count())]
        elif num_local_cpus():
            devices = [cpu(i) for i in range(num_local_cpus())]
        else:
            raise _no_cuda()
    devices = [_context(d) for d in devices]
    shape = MeshConfig(dp, pp, ep, tp, sp).resolve(len(devices))
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(shape), AXES)


def set_mesh(mesh):
    _CURRENT[0] = mesh
    return mesh


def current_mesh():
    return _CURRENT[0]


class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)

    def _parts(self, ndim):
        return [self.mesh.axis_size(self.spec.dim_axes(d))
                for d in range(ndim)]

    def shard_shape(self, shape):
        """The shape of one position's chunk of a ``shape`` value."""
        out = []
        for d, (n, k) in enumerate(zip(shape, self._parts(len(shape)))):
            if n % k:
                raise ValueError("dimension %d of %s does not split %d ways "
                                 "(%r)" % (d, tuple(shape), k, self.spec))
            out.append(n // k)
        return tuple(out)

    def chunk_index(self, pos, ndim):
        """Per dimension, the chunk that position ``pos`` holds."""
        return tuple(self.mesh.axis_index(pos, self.spec.dim_axes(d))
                     for d in range(ndim))

    def is_equivalent_to(self, other, ndim):
        return (tuple(self.mesh.shape.items())
                == tuple(other.mesh.shape.items())
                and all(self.spec.dim_axes(d) == other.spec.dim_axes(d)
                        for d in range(ndim)))

    def is_replicated(self):
        return not self.spec.normalized()


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh, axes=("dp",)):
    """The leading (batch) dimension split over the data axes."""
    return NamedSharding(mesh, PartitionSpec(tuple(axes)))


def _owned(t, device):
    """A copy of ``t`` on ``device`` in its own contiguous storage."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    with torch.no_grad():
        out.copy_(t)
    return out


def _chunk(t, sharding, pos):
    shard = sharding.shard_shape(t.shape)
    for d, i in enumerate(sharding.chunk_index(pos, t.dim())):
        if shard[d] != t.shape[d]:
            t = t.narrow(d, i * shard[d], shard[d])
    return t


class ShardedTensor:
    """One value over a mesh: ``shards[pos]`` is position ``pos``'s chunk
    (owned storage on its device)."""

    def __init__(self, shards, sharding, shape, dtype):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    @classmethod
    def place(cls, full, sharding):
        """``full`` split by ``sharding``, each chunk copied onto its
        position's device."""
        full = full.detach()
        mesh = sharding.mesh
        shards = [_owned(_chunk(full, sharding, p), mesh.device(p))
                  for p in range(mesh.size)]
        return cls(shards, sharding, full.shape, full.dtype)

    @property
    def spec(self):
        return self.sharding.spec

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return "ShardedTensor(shape=%s, dtype=%s, %r)" % (
            self.shape, self.dtype, self.spec)

    def chunk_of(self, t, pos):
        """Position ``pos``'s chunk of a full-shape tensor ``t`` (a
        view)."""
        return _chunk(t, self.sharding, pos)

    def full(self, device=None):
        """The whole value, gathered from the first position holding each
        chunk, on ``device`` (position 0's when None)."""
        mesh = self.sharding.mesh
        device = mesh.device(0) if device is None else device
        if self.sharding.is_replicated():
            return _owned(self.shards[0], device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        with torch.no_grad():
            for pos in range(mesh.size):
                idx = self.sharding.chunk_index(pos, self.ndim)
                if idx in seen:
                    continue
                seen.add(idx)
                self.chunk_of(out, pos).copy_(self.shards[pos])
        return out

    def numpy(self):
        return self.full(torch.device("cpu")).numpy()


# ---- collectives over per-position lists ------------------------------------

def _ordered_sum(shards, group, device):
    acc = None
    for p in group:
        v = shards[p].to(device)
        acc = v if acc is None else acc + v
    return acc


def all_reduce(shards, mesh, axis, op="sum"):
    """Each position gets the sum (``op="mean"``: the mean) of its group's
    shards along ``axis``, added in mesh order."""
    if op not in ("sum", "mean"):
        raise ValueError("all_reduce op must be 'sum' or 'mean', got %r"
                         % (op,))
    out = list(shards)
    for group in mesh.groups(axis):
        dev = shards[group[0]].device
        acc = _ordered_sum(shards, group, dev)
        if op == "mean":
            acc = acc / len(group)
        for p in group:
            out[p] = acc.to(shards[p].device, copy=True)
    return out


def all_gather(shards, mesh, axis, dim=0):
    """Each position gets its group's shards concatenated along ``dim`` in
    mesh order."""
    out = list(shards)
    for group in mesh.groups(axis):
        for p in group:
            dev = shards[p].device
            out[p] = torch.cat([shards[q].to(dev) for q in group], dim)
    return out


def reduce_scatter(shards, mesh, axis, dim=0):
    """The group's sum split along ``dim``: the position at index ``i``
    along ``axis`` keeps chunk ``i``."""
    out = list(shards)
    for group in mesh.groups(axis):
        acc = _ordered_sum(shards, group, shards[group[0]].device)
        parts = torch.chunk(acc, len(group), dim)
        for i, p in enumerate(group):
            out[p] = parts[i].to(shards[p].device, copy=True)
    return out


def all_to_all(shards, mesh, axis, split_dim=0, concat_dim=0):
    """Position ``j`` of a group gets chunk ``j`` (along ``split_dim``) of
    every member's shard, concatenated along ``concat_dim`` in mesh
    order."""
    out = list(shards)
    for group in mesh.groups(axis):
        n = len(group)
        parts = [torch.chunk(shards[p], n, split_dim) for p in group]
        for j, p in enumerate(group):
            dev = shards[p].device
            out[p] = torch.cat([parts[i][j].to(dev) for i in range(n)],
                               concat_dim)
    return out


def ppermute(shards, mesh, axis, perm):
    """``perm``: ``(source, destination)`` indices along ``axis``; a
    destination gets its source's shard, a position that no pair names
    gets zeros."""
    out = [None] * len(shards)
    for group in mesh.groups(axis):
        for src, dst in perm:
            p, q = group[src], group[dst]
            out[q] = shards[p].to(shards[q].device, copy=True)
        for p in group:
            if out[p] is None:
                out[p] = torch.zeros_like(shards[p])
    return out
