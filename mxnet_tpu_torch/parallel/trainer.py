"""ShardedTrainer: counterpart of ``mxnet_tpu/parallel/trainer.py``.

The reference compiles forward, backward, gradient all-reduce and the
optimizer update into one SPMD program over a mesh. The port runs a step
eagerly: the block's forward on the trainer's own parameter values
(``torch.func.functional_call`` on one device; the values installed in
the block's modules on a mesh), the loss's mean, autograd's backward
(through the CUDA flash-attention backward kernels under every attention
layer) and the in-place optimizer update.

**On one device** (no ``mesh``, ``param_rules`` or ``plan``) the trainer
holds one tensor per parameter on ``device``.

**Over a mesh** (ROADMAP item 10a) it keeps the reference's semantics,
GSPMD's: a step computes the one-device step over the whole batch. The
batch is split over the data axes (``batch_axes``, a plan's ``data_axes``)
into one replica per data shard, each run on its lead position's device
by a :class:`~.replicas.ReplicaGroup` in lock step. Every parameter and
its optimizer state are stored as :class:`~.mesh.ShardedTensor` values
by the spec of the first ``param_rules`` regex that matches its name (a
plan's rules after the caller's; unmatched: replicated), so a device holds 1/tp
of a ``tp_rules()`` parameter. A replica gathers each parameter whole to
compute (tp and pp do not split the compute yet: ROADMAP lead), its loss
is its shard's mean over the number of replicas, and one backward over
the replicas' losses, summed in replica order, gives each replica's
gradient; their sum is scattered onto the shards, where each position
updates its own shard with its own state (an elementwise optimizer; of
the positions that hold the same chunk on one device the first updates
and the others copy its result; ``lamb``'s norms take the whole
tensor). What the reference reduces over
the global batch inside the program, the replicas reduce through the
group: BatchNorm's batch moments (and so its moving statistics), Switch
routing's token pool (``MoETransformerLM``), the loss mean and the
gradient sum. Every shard and every replica value owns its buffer.

As in the reference, the trainer holds its own copy of every parameter (in
``dtype`` when given, the optimizer state likewise); the block's own
trainable parameters change only at :meth:`ShardedTrainer.sync_back`.
:meth:`ShardedTrainer.step_stream` trains from a
:class:`~.datafeed.DeviceFeed` (or any batch source, wrapped in one): it
takes the feed's batches in chunks of ``MXNET_DATAFEED_CHUNK`` steps,
fires the ``trainer.step`` chaos point once per chunk before it consumes,
and runs each batch as one :meth:`ShardedTrainer.step` while the feed
stages the next ones; so its losses are those of ``step()`` calls over the
same batches, bit for bit.

Aux state (BatchNorm's moving statistics) is carried as the reference
carries it (``parallel/trainer.py:180-190``): each step's aux writes land
in the trainer's own values, never pass through the optimizer (a
weight-decayed update would decay them), and are copied into the block's
tensors after the step, as the reference writes its handles.
"""
from __future__ import annotations

import itertools

import torch
from torch.func import functional_call

from .. import _tape
from .. import config as _config
from .. import random as _random
from ..context import default_device
from ..observability import tracer as _trace
from ..resilience import chaos as _chaos
from ..ndarray.ndarray import NDArray
from .functional import functional_optimizer
from .mesh import ShardedTensor, make_mesh

__all__ = ["ShardedTrainer"]

# optimizers whose update is elementwise: a shard updates on its own
_ELEMENTWISE = ("sgd", "nag", "adam")

# a stats name for each feed that step_stream wraps around a plain source
_stream_seq = itertools.count()


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class ShardedTrainer:
    """Trainer with the reference's interface::

        trainer = ShardedTrainer(net, loss_fn, "adam",
                                 {"learning_rate": 1e-4})
        for x, y in batches:
            loss = trainer.step(x, y)
        trainer.sync_back()   # write the trained values into net

    ``loss_fn(out, label)`` returns per-sample losses; a step minimises
    their mean. ``dtype`` (e.g. ``"bfloat16"``) casts the trainer's
    parameters, and so their gradients and the optimizer state, as in the
    reference. ``preprocess`` is applied to each model input inside the
    step. ``device``: where the trainer's values live and the step runs
    (CUDA when None; raises without one).

    ``mesh`` (a :class:`~.mesh.Mesh`), ``param_rules`` (``[(regex,
    PartitionSpec), ...]``, first match wins) and ``plan`` (a
    :class:`~.planner.ShardingPlan`: its mesh, data axes and rules, the
    caller's rules first) train over a mesh. ``param_rules`` without a
    mesh take every visible GPU (the reference's every device), or one
    position on ``device`` when it is given; a plan without a mesh takes
    ``plan.n_devices`` positions on ``device`` when it is given."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=None, batch_axes=("dp",),
                 dtype=None, preprocess=None, plan=None, device=None):
        self._block = block
        self._loss = loss_fn
        self._preprocess = preprocess
        self._plan = plan
        if plan is not None:
            if mesh is None:
                mesh = plan.mesh(devices=None if device is None else
                                 [device] * plan.n_devices)
            batch_axes = plan.data_axes
            param_rules = list(param_rules or []) + list(plan.param_rules())
        if mesh is None and param_rules:
            mesh = make_mesh(devices=None if device is None else [device])
        self._mesh = mesh
        self._batch_axes = tuple(batch_axes)
        self._device = default_device(device) if mesh is None \
            else mesh.device(0)
        optimizer_params = dict(optimizer_params or {})
        self._lr = optimizer_params.get("learning_rate", 0.01)
        self._opt_name = optimizer.lower()
        init_state, self._update = functional_optimizer(optimizer,
                                                        **optimizer_params)
        dtype = _torch_dtype(dtype)
        self._t = 0
        self._generator = None
        if mesh is not None:
            self._init_mesh(param_rules, init_state, dtype)
            return
        self._values = {}
        for name, p in block.named_parameters():
            v = p.detach().to(device=self._device, dtype=dtype or p.dtype,
                              copy=True)
            self._values[name] = v.requires_grad_(p.requires_grad)
        self._states = {n: init_state(v) for n, v in self._values.items()
                        if v.requires_grad}
        self._name_of = {id(v): n for n, v in self._values.items()}

    @property
    def mesh(self):
        """The trainer's :class:`~.mesh.Mesh` (None on one device)."""
        return self._mesh

    @property
    def plan(self):
        """The :class:`~.planner.ShardingPlan` the trainer was built from,
        or None."""
        return self._plan

    # ---- the mesh path ------------------------------------------------------

    def _init_mesh(self, param_rules, init_state, dtype):
        from ..gluon.parameter import collect_params
        from .functional import shard_params
        mesh = self._mesh
        block = self._block
        named = list(block.named_parameters())
        # rules match the reference's parameter names
        ref_name = {id(p.tensor()): n
                    for n, p in collect_params(block).items()}
        specs = shard_params([ref_name.get(id(p), n) for n, p in named],
                             mesh, param_rules)
        self._trainable = [n for n, p in named if p.requires_grad]
        self._values = {}
        self._states = {}
        for (name, p), sharding in zip(named, specs):
            v = p.detach().to(dtype=dtype or p.dtype)
            self._values[name] = ShardedTensor.place(v, sharding)
            if p.requires_grad:
                # the state is made whole and placed as its parameter is
                self._states[name] = tuple(
                    ShardedTensor.place(s, sharding)
                    for s in init_state(torch.zeros_like(v)))
        # every module slot that holds a parameter (tied ones included)
        canon = {id(p): n for n, p in named}
        self._slots = []
        for _, mod in block.named_modules(remove_duplicate=False):
            for leaf, t in mod._parameters.items():
                if t is not None and id(t) in canon:
                    self._slots.append((mod, leaf, canon[id(t)]))
        # replicas: one per data shard, on the first position holding it
        n = mesh.axis_size(self._batch_axes)
        leads = [None] * n
        for pos in range(mesh.size):
            r = mesh.axis_index(pos, self._batch_axes)
            if leads[r] is None:
                leads[r] = pos
        self._leads = leads
        self._chunk_groups = {}

    def _replica_devices(self):
        return [self._mesh.device(p) for p in self._leads]

    def _run_replicas(self, fn, values):
        """``fn(r)`` for each replica ``r``, in lock step, each with its
        ``values[r]`` installed in the block's modules."""
        from .. import context as _context
        from ..gluon.block import set_slots, slots_set_to
        from . import replicas as _replicas
        slots = [(mod, leaf) for mod, leaf, _ in self._slots]

        def tensors(r):
            return [values[r][name] for _, _, name in self._slots]

        group = _replicas.ReplicaGroup(
            self._mesh, self._batch_axes, self._replica_devices(),
            on_turn=lambda r: set_slots(slots, tensors(r)))
        with slots_set_to(slots, tensors(0)):
            return group.run(
                [lambda r=r: fn(r) for r in range(group.n)],
                state=(_tape._state, _context._thread_local, _random._state))

    def _slices(self, x, device_list):
        """Replica ``r``'s share of a batch ``x``: a DeviceFeed's shard, or
        a contiguous slice of the leading axis."""
        n = len(device_list)
        if isinstance(x, ShardedTensor):
            return [x.shards[p] for p in self._leads]
        x = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError("batch of %d rows does not split over %d "
                             "replicas (data axes %s)"
                             % (x.shape[0], n, self._batch_axes))
        b = x.shape[0] // n
        return [x.narrow(0, r * b, b).to(device_list[r]).contiguous()
                for r in range(n)]

    def _replica_values(self, devices, grad):
        return [{name: (st.full(dev).requires_grad_(
            grad and name in self._states))
            for name, st in self._values.items()} for dev in devices]

    def _mesh_grads(self, data, label, scale=None):
        """The mesh step's forward and backward: ``(loss, grads, sink,
        values0)`` with ``grads`` the gradient sum of each trainable
        parameter on the lead device (of the loss times ``scale``, a 0-dim
        tensor, when given), and replica 0's aux writes."""
        devices = self._replica_devices()
        n = len(devices)
        xs = [self._slices(x, devices) for x in data]
        ys = self._slices(label, devices)
        values = self._replica_values(devices, grad=True)
        block = self._block
        sinks = [None] * n

        def replica(r):
            xr = tuple(x[r] for x in xs)
            if self._preprocess is not None:
                xr = tuple(self._preprocess(x) for x in xr)
            sink = _tape.push_aux_sink()
            try:
                with torch.enable_grad():
                    out = block(*xr)
            finally:
                _tape.pop_aux_sink()
            sinks[r] = sink
            with torch.enable_grad():
                if isinstance(out, (tuple, list)):
                    out = out[0]
                return self._loss(out, ys[r]).mean() / n

        was_training = block.training
        block.train()
        try:
            losses = self._run_replicas(replica, values)
        finally:
            block.train(was_training)
        dev0 = devices[0]
        with torch.enable_grad():
            total = losses[0]
            for loss in losses[1:]:
                total = total + loss.to(dev0)
            (total if scale is None else total * scale).backward()
        self._t += 1
        grads = {}
        for name in self._trainable:
            grad = None
            for r in range(n):
                g = values[r][name].grad
                if g is None:
                    continue
                g = g.to(dev0)
                grad = g if grad is None else grad + g
            st = self._values[name]
            if grad is None:
                grad = torch.zeros(st.shape, dtype=st.dtype, device=dev0)
            grads[name] = grad.to(st.dtype)
        return total.detach(), grads, sinks[0], values[0]

    def _mesh_step(self, data, label, lr):
        loss, grads, sink, values0 = self._mesh_grads(data, label)
        self._commit(grads, lr, self._t, (sink, values0))
        return loss

    def _commit(self, grads, lr, t, aux):
        """The optimizer update of every trainable parameter with its
        gradient in ``grads``, at optimizer step ``t``, then the step's aux
        writes (``_grads``' last item)."""
        lr = self._lr if lr is None else lr
        if self._mesh is not None:
            for name, grad in grads.items():
                self._apply_update(name, grad, lr, t)
            self._carry_mesh_aux(*aux)
            return
        for name, g in grads.items():
            self._update(self._values[name], g, self._states[name], t, lr)
        self._carry_aux(aux)

    def _grads(self, xs, y, scale=None):
        """One step's loss and gradients, the update not applied: ``(loss,
        grads, aux)`` (see :meth:`_mesh_grads`); advances ``_t``."""
        if self._mesh is not None:
            loss, grads, sink, values0 = self._mesh_grads(xs, y, scale)
            return loss, grads, (sink, values0)
        self._t += 1
        loss, sink = self._forward_backward(xs, y, scale)
        grads = {}
        for name in self._states:
            w = self._values[name]
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            grads[name] = g.to(w.dtype)
        return loss, grads, sink

    def _aux_targets(self, aux):
        """The tensors a commit of ``aux`` writes besides the values and
        states (the block's own aux parameters)."""
        own = dict(self._block.named_parameters())
        if self._mesh is not None:
            sink, values0 = aux
            if not sink:
                return []
            name_of = {id(v): n for n, v in values0.items()}
            return [own[name_of[id(h._data)]] for h, _ in sink]
        return [own[self._name_of[id(h._data)]] for h, _ in aux]

    def _apply_update(self, name, grad, lr, t):
        """The optimizer update of every position's shard of ``name``
        with its chunk of the full gradient ``grad``, at step ``t``."""
        st, states = self._values[name], self._states[name]
        mesh = self._mesh
        if self._opt_name in _ELEMENTWISE or st.sharding.is_replicated():
            # positions holding the same chunk on the same device would
            # compute the same values: the first updates, the rest copy
            for group in self._same_chunk(st):
                p0 = group[0]
                g = st.chunk_of(grad, p0).to(mesh.device(p0), copy=True)
                self._update(st.shards[p0], g,
                             tuple(s.shards[p0] for s in states), t, lr)
                with torch.no_grad():
                    for p in group[1:]:
                        for x in (st,) + states:
                            x.shards[p].copy_(x.shards[p0])
            return
        # a norm-taking update (lamb) of a split parameter: on the whole
        # tensor, then every position takes its chunk
        w = st.full(grad.device)
        state = tuple(s.full(grad.device) for s in states)
        self._update(w, grad, state, t, lr)
        with torch.no_grad():
            for whole, target in ((w, st),) + tuple(zip(state, states)):
                for p in range(mesh.size):
                    target.shards[p].copy_(target.chunk_of(whole, p))

    def _same_chunk(self, st):
        """The mesh's positions grouped by (chunk of ``st``, device)."""
        key = (st.spec.normalized(), st.ndim)
        groups = self._chunk_groups.get(key)
        if groups is None:
            by = {}
            for p in range(self._mesh.size):
                k = (st.sharding.chunk_index(p, st.ndim),
                     self._mesh.device(p))
                by.setdefault(k, []).append(p)
            groups = self._chunk_groups[key] = list(by.values())
        return groups

    def _carry_mesh_aux(self, sink, values0):
        """Replica 0's aux writes (equal in every replica: their moments
        are the group's) into every position's value and the block."""
        if not sink:
            return
        name_of = {id(v): n for n, v in values0.items()}
        own = dict(self._block.named_parameters())
        with torch.no_grad():
            for handle, value in sink:
                name = name_of[id(handle._data)]
                st = self._values[name]
                for p in range(self._mesh.size):
                    st.shards[p].copy_(st.chunk_of(value.detach(), p))
                own[name].copy_(value)

    def _mesh_forward(self, data):
        devices = self._replica_devices()
        xs = [self._slices(x, devices) for x in data]
        values = self._replica_values(devices, grad=False)
        block = self._block

        def replica(r):
            xr = tuple(x[r] for x in xs)
            if self._preprocess is not None:
                xr = tuple(self._preprocess(x) for x in xr)
            with torch.no_grad():
                return block(*xr)

        was_training = block.training
        block.eval()
        try:
            outs = self._run_replicas(replica, values)
        finally:
            block.train(was_training)
        dev0 = devices[0]
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(torch.cat([o[i].to(dev0) for o in outs])
                                 for i in range(len(outs[0])))
        return torch.cat([o.to(dev0) for o in outs])

    @property
    def values(self):
        """The trainer's parameter values by name: on one device tensors
        (after a step each trainable one holds that step's gradient in
        ``.grad``), over a mesh :class:`~.mesh.ShardedTensor` values."""
        return self._values

    @property
    def states(self):
        """The optimizer state of each trainable parameter by name: a tuple
        (``adam``: the first and second moments) of tensors on one device,
        of :class:`~.mesh.ShardedTensor` values over a mesh."""
        return self._states

    def _place(self, x):
        return torch.as_tensor(x, device=self._device)

    def _inputs(self, data):
        return tuple(data if isinstance(data, tuple) else (data,))

    def step(self, data, label, lr=None):
        """One step: forward, ``loss_fn(out, label).mean()``, backward and
        the optimizer update. ``data`` is one input, or a TUPLE of model
        inputs; a list is refused as ambiguous. Returns the loss, a 0-dim
        tensor on the trainer's device. Fires the ``trainer.step`` chaos
        point before any state changes and the ``trainer.grads`` poison
        point on the staged batch (``nan``: its floating inputs, or its
        labels, become NaN; the unguarded trainer absorbs them, a
        ``resilience.guardrails.GuardedStep`` skips the step)."""
        if isinstance(data, list):
            raise TypeError(
                "ShardedTrainer.step: pass a TUPLE for multi-input models "
                "or a single stacked array; a list is ambiguous")
        _chaos.point("trainer.step")
        return self._run(data, label, lr, _chaos.poisoned("trainer.grads"))

    def _stage(self, data, label, poison):
        """The step's inputs and label: placed on the device (one device),
        as given over a mesh; NaN-poisoned when ``poison``."""
        xs = self._inputs(data)
        y = label
        if self._mesh is None:
            xs = tuple(self._place(x) for x in xs)
            y = self._place(label)
        if poison:
            from ..resilience.guardrails import poison_nonfinite
            xs, y = poison_nonfinite(xs, y)
        return xs, y

    def _run(self, data, label, lr, poison=False):
        xs, y = self._stage(data, label, poison)
        if self._mesh is not None:
            loss = self._mesh_step(xs, y, lr)
        else:
            if self._preprocess is not None:
                xs = tuple(self._preprocess(x) for x in xs)
            loss, grads, aux = self._grads(xs, y)
            self._commit(grads, lr, self._t, aux)
        self._await_plan((loss, self._values, self._states))
        return loss

    def _await_plan(self, outputs):
        """A multi-axis plan's step (pp, ep or sp > 1) waits for its work
        under the collective watchdog (``guard_wait``, op
        ``trainer.dispatch``): free unless
        ``MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS`` is set."""
        if self._plan is not None and self._plan.multi_axis:
            from ..resilience.elastic import guard_wait
            guard_wait(outputs, op="trainer.dispatch")

    def _forward_backward(self, xs, y, scale=None):
        """Forward and backward on one device (of the loss times ``scale``
        when given): ``(loss, aux_sink)``, the aux writes not carried."""
        block = self._block
        was_training = block.training
        block.train()
        try:
            for v in self._values.values():
                v.grad = None
            sink = _tape.push_aux_sink()
            try:
                with torch.enable_grad():
                    out = functional_call(block, self._values, xs)
            finally:
                _tape.pop_aux_sink()
            with torch.enable_grad():
                if isinstance(out, (tuple, list)):
                    out = out[0]
                loss = self._loss(out, y).mean()
                (loss if scale is None else loss * scale).backward()
        finally:
            block.train(was_training)
        return loss.detach(), sink

    def _carry_aux(self, aux):
        """Write a step's aux values into the trainer's values (the
        carried state) and into the block's own tensors."""
        own = dict(self._block.named_parameters())
        with torch.no_grad():
            for handle, value in aux:
                handle._data.copy_(value)
                own[self._name_of[id(handle._data)]].copy_(value)

    def forward(self, data):
        """Inference forward of the block on the trainer's values (no
        gradient, no update); ``data`` is one input or a TUPLE."""
        if self._mesh is not None:
            return self._mesh_forward(self._inputs(data))
        xs = tuple(self._place(x) for x in
                   (data if isinstance(data, tuple) else (data,)))
        if self._preprocess is not None:
            xs = tuple(self._preprocess(x) for x in xs)
        block = self._block
        was_training = block.training
        block.eval()
        try:
            with torch.no_grad():
                out = functional_call(block, self._values, xs)
        finally:
            block.train(was_training)
        return out

    def _batch_generator(self):
        """The trainer's own generator on its device, seeded at first use
        from this thread's (``random.seed`` decides it)."""
        if self._generator is None:
            seed = int(torch.randint(0, 2 ** 62, (),
                                     generator=_random.default_generator()))
            self._generator = torch.Generator(self._device).manual_seed(seed)
        return self._generator

    def bench_span(self, steps, data_shape, num_classes, dtype=None):
        """``steps`` training steps on batches generated on the device from
        the trainer's own generator (uniform [0, 1) images of
        ``data_shape`` in ``dtype``, float32 unless ``"bfloat16"``; uint8
        under ``preprocess``, which then takes the raw shape; labels
        uniform in ``[0, num_classes)`` as float32), each the same
        :meth:`step` as a fed one. Returns the losses, shape
        ``(steps,)``."""
        dt = torch.bfloat16 if dtype in ("bfloat16", torch.bfloat16) \
            else torch.float32

        def make_batch(g):
            if self._preprocess is not None:
                x = torch.randint(0, 256, tuple(data_shape), generator=g,
                                  device=self._device, dtype=torch.uint8)
            else:
                x = torch.rand(tuple(data_shape), generator=g,
                               device=self._device, dtype=dt)
            y = torch.randint(0, num_classes, (data_shape[0],), generator=g,
                              device=self._device).float()
            return (x,), y
        return self.bench_span_fn(steps, make_batch)

    def bench_span_fn(self, steps, make_batch, tag=None):
        """Like :meth:`bench_span` with a caller's batch maker:
        ``make_batch(generator)`` returns ``(x_args_tuple, y)`` made on the
        device from the trainer's generator. ``tag`` is accepted for the
        reference's signature (it keys a compile cache there)."""
        gen = self._batch_generator()
        losses = []
        for _ in range(steps):
            xs, y = make_batch(gen)
            xs = tuple(xs)
            losses.append(self.step(xs if len(xs) > 1 else xs[0], y))
        return torch.stack(losses)

    def step_many(self, data, label, lr=None):
        """``data.shape[0]`` steps, one per entry of the leading axis of
        ``data`` (or of each array of a TUPLE) and ``label``. Returns the
        losses, shape ``(n_steps,)``."""
        if isinstance(data, list):
            raise TypeError(
                "ShardedTrainer.step_many: pass a TUPLE for multi-input "
                "models or a single (n_steps, batch, ...) array; a list is "
                "ambiguous")
        multi = isinstance(data, tuple)
        xs = data if multi else (data,)
        # one chaos fire and one poison draw for the whole span, as the
        # reference's one staged program
        _chaos.point("trainer.step")
        poison = _chaos.poisoned("trainer.grads")
        losses = []
        for i in range(xs[0].shape[0]):
            x = tuple(a[i] for a in xs) if multi else xs[0][i]
            losses.append(self._run(x, label[i], lr, poison))
        return torch.stack(losses)

    def step_stream(self, feed, steps=None, chunk=None, lr=None,
                    preemption=None):
        """Train off a :class:`~.datafeed.DeviceFeed` (any other batch
        source is wrapped in one on the trainer's device, and closed on
        return) in chunks of ``chunk`` steps (``MXNET_DATAFEED_CHUNK``):
        while a chunk's steps run, the feed's stager copies the next
        batches to the device.

        ``steps`` caps the steps run (None: until the feed is dry). Each
        chunk first takes one batch (a dry feed fires nothing), then fires
        the ``trainer.step`` chaos point before any state changes; on a
        fault the batch is handed back to the feed, so a retry loses
        nothing. Each batch runs as one :meth:`step` as soon as it is
        taken (the reference stacks a chunk into one program and so needs
        it whole; here one staged batch ahead is enough, whatever the
        chunk). Returns the losses, shape ``(n_run,)``.

        ``preemption`` (a :class:`~..resilience.elastic.PreemptionHandler`)
        is read at every chunk boundary: a delivered notice raises
        :class:`~..resilience.elastic.Preempted` before the next chunk
        takes from the feed, every finished chunk counted in ``_t`` (the
        caller writes the emergency checkpoint; ``feed.flush()`` lets go of
        the batches staged ahead). The ``trainer.grads`` poison point is
        drawn once a chunk and poisons the chunk's batches."""
        from .datafeed import DeviceFeed
        chunk = int(_config.get("MXNET_DATAFEED_CHUNK") if chunk is None
                    else chunk)
        if chunk < 1:
            raise ValueError("chunk must be >= 1, got %r" % (chunk,))
        if steps is not None and steps < 0:
            raise ValueError("steps must be >= 0, got %r" % (steps,))
        owned = not isinstance(feed, DeviceFeed)
        if owned:
            feed = DeviceFeed(feed, device=self._device, mesh=self._mesh,
                              batch_axes=self._batch_axes,
                              name="step_stream.%d" % next(_stream_seq))
        losses = []
        try:
            it = iter(feed)
            remaining = None if steps is None else int(steps)
            chunk_idx = 0
            while remaining is None or remaining > 0:
                if preemption is not None and preemption.triggered():
                    from ..resilience.elastic import Preempted
                    raise Preempted(step=self._t)
                with _trace.span("trainer.chunk", feed=feed.name,
                                 chunk=chunk_idx, t0=self._t + 1) as sp:
                    try:
                        first = next(it)
                    except StopIteration:
                        sp.cancel()
                        break
                    try:
                        _chaos.point("trainer.step")
                    except BaseException:
                        feed._unget(first)
                        raise
                    poison = _chaos.poisoned("trainer.grads")
                    take = chunk if remaining is None \
                        else min(chunk, remaining)
                    n, batch = 0, first
                    while batch is not None:
                        xs, y = batch
                        losses.append(self._run(
                            xs if len(xs) > 1 else xs[0], y, lr, poison))
                        n += 1
                        batch = None
                        if n < take:
                            try:
                                batch = next(it)
                            except StopIteration:
                                pass
                    sp.set(steps=n)
                    if remaining is not None:
                        remaining -= n
                chunk_idx += 1
        finally:
            if owned:
                feed.close()
        if not losses:
            return torch.zeros((0,), device=self._device)
        return torch.stack(losses)

    def sync_back(self):
        """Write the trainer's values into the block's parameters (in the
        trainer's dtype, on each parameter's own device; gathered whole
        over a mesh), as owned copies (new storage: CachedOps drop their
        graphs)."""
        from .. import cached_op
        with torch.no_grad():
            for name, p in self._block.named_parameters():
                v = self._values[name]
                p.data = v.full(p.device) if isinstance(v, ShardedTensor) \
                    else v.detach().to(p.device, copy=True)
        cached_op.storage_rebound()

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = lr
