"""ShardedTrainer on one device: counterpart of
``mxnet_tpu/parallel/trainer.py``.

The reference compiles forward, backward, gradient all-reduce and the
optimizer update into one SPMD program over a mesh. The port trains on one
device so far: a step runs the block's forward on the trainer's own
parameter values (``torch.func.functional_call``), the loss's mean,
autograd's backward (through the CUDA flash-attention backward kernels
under every attention layer) and the in-place optimizer update, eagerly.
Meshes, parameter rules and sharding plans are not ported yet (ROADMAP
Queue A step 11) and raise ``NotImplementedError``.

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
from .functional import functional_optimizer

__all__ = ["ShardedTrainer"]

# a stats name for each feed that step_stream wraps around a plain source
_stream_seq = itertools.count()


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class ShardedTrainer:
    """Single-device trainer with the reference's interface::

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
    (CUDA when None; raises without one)."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=None, batch_axes=("dp",),
                 dtype=None, preprocess=None, plan=None, device=None):
        if mesh is not None or param_rules or plan is not None:
            raise NotImplementedError(
                "ShardedTrainer: meshes, param_rules and sharding plans are "
                "not ported yet (ROADMAP Queue A step 11); the port trains "
                "on one device")
        # batch_axes name mesh axes; on one device they shard nothing
        self._block = block
        self._loss = loss_fn
        self._preprocess = preprocess
        self._device = default_device(device)
        optimizer_params = dict(optimizer_params or {})
        self._lr = optimizer_params.get("learning_rate", 0.01)
        init_state, self._update = functional_optimizer(optimizer,
                                                        **optimizer_params)
        dtype = _torch_dtype(dtype)
        self._values = {}
        for name, p in block.named_parameters():
            v = p.detach().to(device=self._device, dtype=dtype or p.dtype,
                              copy=True)
            self._values[name] = v.requires_grad_(p.requires_grad)
        self._states = {n: init_state(v) for n, v in self._values.items()
                        if v.requires_grad}
        self._name_of = {id(v): n for n, v in self._values.items()}
        self._t = 0
        self._generator = None

    @property
    def values(self):
        """The trainer's parameter values by name. After a step each
        trainable one holds that step's gradient in ``.grad``."""
        return self._values

    def _place(self, x):
        return torch.as_tensor(x, device=self._device)

    def step(self, data, label, lr=None):
        """One step: forward, ``loss_fn(out, label).mean()``, backward and
        the optimizer update. ``data`` is one input, or a TUPLE of model
        inputs; a list is refused as ambiguous. Returns the loss, a 0-dim
        tensor on the trainer's device."""
        if isinstance(data, list):
            raise TypeError(
                "ShardedTrainer.step: pass a TUPLE for multi-input models "
                "or a single stacked array; a list is ambiguous")
        xs = tuple(self._place(x) for x in
                   (data if isinstance(data, tuple) else (data,)))
        y = self._place(label)
        if self._preprocess is not None:
            xs = tuple(self._preprocess(x) for x in xs)
        self._t += 1
        loss = self._forward_backward(xs, y)
        lr = self._lr if lr is None else lr
        for name, state in self._states.items():
            w = self._values[name]
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            self._update(w, g.to(w.dtype), state, self._t, lr)
        return loss

    def _forward_backward(self, xs, y):
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
            self._carry_aux(sink)
            with torch.enable_grad():
                if isinstance(out, (tuple, list)):
                    out = out[0]
                loss = self._loss(out, y).mean()
                loss.backward()
        finally:
            block.train(was_training)
        return loss.detach()

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
        losses = []
        for i in range(xs[0].shape[0]):
            x = tuple(a[i] for a in xs) if multi else xs[0][i]
            losses.append(self.step(x, label[i], lr))
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

        ``preemption`` handlers and the ``trainer.grads`` poison point wait
        for the resilience slice (ROADMAP Queue A item 11) and raise
        :class:`NotImplementedError`."""
        from .datafeed import DeviceFeed
        if preemption is not None:
            raise NotImplementedError(
                "ShardedTrainer.step_stream: preemption handlers are not "
                "ported yet (ROADMAP Queue A item 11)")
        chunk = int(_config.get("MXNET_DATAFEED_CHUNK") if chunk is None
                    else chunk)
        if chunk < 1:
            raise ValueError("chunk must be >= 1, got %r" % (chunk,))
        if steps is not None and steps < 0:
            raise ValueError("steps must be >= 0, got %r" % (steps,))
        owned = not isinstance(feed, DeviceFeed)
        if owned:
            feed = DeviceFeed(feed, device=self._device,
                              name="step_stream.%d" % next(_stream_seq))
        losses = []
        try:
            it = iter(feed)
            remaining = None if steps is None else int(steps)
            chunk_idx = 0
            while remaining is None or remaining > 0:
                with _trace.span("trainer.chunk", feed=feed.name,
                                 chunk=chunk_idx, t0=self._t + 1) as sp:
                    try:
                        first = next(it)
                    except StopIteration:
                        sp.cancel()
                        break
                    try:
                        _chaos.point("trainer.step")
                        if _chaos.poisoned("trainer.grads"):
                            raise NotImplementedError(
                                "ShardedTrainer.step_stream: the "
                                "trainer.grads poison point is not ported "
                                "yet (ROADMAP Queue A item 11)")
                    except BaseException:
                        feed._unget(first)
                        raise
                    take = chunk if remaining is None \
                        else min(chunk, remaining)
                    n, batch = 0, first
                    while batch is not None:
                        xs, y = batch
                        losses.append(self.step(
                            xs if len(xs) > 1 else xs[0], y, lr))
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
        trainer's dtype, on each parameter's own device), as owned copies
        (new storage: CachedOps drop their graphs)."""
        from .. import cached_op
        with torch.no_grad():
            for name, p in self._block.named_parameters():
                p.data = self._values[name].detach().to(p.device, copy=True)
        cached_op.storage_rebound()

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = lr
