"""Sharding planner: one mesh, every axis; counterpart of
``mxnet_tpu/parallel/planner.py``.

A :class:`ShardingPlan` is a concrete dp x pp x ep x sp factorization of a
device pool, scored by the reference's analytic cost model (per-axis
communication volume, gated by per-device memory feasibility), and
serializable into checkpoints. The search, the costs, the feasibility
gates, :func:`respread` and the typed errors are the reference's
arithmetic, unchanged; only :meth:`ShardingPlan.mesh`,
:meth:`ShardingPlan.batch_sharding` and :meth:`ShardingPlan.param_rules`
build the port's :mod:`~.mesh` objects.

The plan is threaded end to end: ``ShardedTrainer(plan=...)`` takes its
mesh, data axes (dp and ep jointly) and parameter rules from it,
``DeviceFeed(plan=...)`` shards batches over its data axes, and
``parallel.checkpoint`` records ``plan.to_dict()`` and raises
:class:`PlanMismatchError` naming both placements when a restore cannot
reshard.

Parameter-naming convention (what :meth:`ShardingPlan.param_rules` keys
on, shared with :class:`~mxnet_tpu_torch.models.MoETransformerLM`):

========================  =================================================
``stack_expert_*``        stage-stacked expert params, dims ``(n_stages,
                          n_experts, ...)`` -> ``P('pp', 'ep')``
``stack_*``               stage-stacked dense params, leading dim
                          ``n_stages`` -> ``P('pp')``
anything else             replicated (embeddings, heads, biases)
========================  =================================================

Knobs, with the reference's defaults: ``MXNET_PLAN_HBM_BYTES`` (per-device
memory budget of the feasibility gate; 0 = unbounded), ``MXNET_PLAN_MAX_PP``
(cap on the pipeline factor; 0 = none), ``MXNET_PLAN_FORCE`` (an explicit
``"dp=2,pp=2,ep=2"`` placement, still validated), and the serving family
``MXNET_SERVE_PLAN_HBM_BYTES``, ``MXNET_SERVE_PLAN_MAX_PP``,
``MXNET_SERVE_PLAN_FORCE`` (:func:`plan_serving`, scored by
:meth:`ShardingPlan.decode_cost`).
"""
from __future__ import annotations

import re

__all__ = ["PlanError", "PlanMismatchError", "ModelProfile", "ShardingPlan",
           "plan_sharding", "plan_serving", "respread"]

# enumeration order of the plan axes everywhere (serialization, describe,
# mesh construction); tp is carried for mesh parity but the planner keeps
# it at 1 — tensor-parallel rules stay the caller's param_rules business
PLAN_AXES = ("dp", "pp", "ep", "sp")


class PlanError(ValueError):
    """No feasible placement (or an invalid forced/constructed one)."""


class PlanMismatchError(PlanError):
    """A checkpoint written under one placement cannot be restored onto
    the current one (shape/structure reshard impossible — e.g. the saved
    model's expert count does not exist in the restoring trainer). Names
    both placements so the operator sees the topology transition, not an
    orbax traceback."""

    def __init__(self, saved, current, detail):
        self.saved = dict(saved) if saved else None
        self.current = dict(current) if current else None
        super().__init__(
            "cannot reshard checkpoint saved under %s onto current %s: %s"
            % (_describe_dict(self.saved), _describe_dict(self.current),
               detail))


def _describe_dict(d):
    if not d:
        return "<no recorded plan>"
    axes = "·".join("%s%d" % (a, int(d.get(a, 1))) for a in PLAN_AXES)
    return "%s over %s devices" % (axes, d.get("n_devices", "?"))


class ModelProfile:
    """What the cost model needs to know about one training job.

    ``dense_bytes``   — replicated parameter bytes (embeddings, heads);
    ``stage_bytes``   — stage-stacked dense parameter bytes (total across
                        stages; divided by pp);
    ``expert_bytes``  — expert parameter bytes (total; divided by pp*ep);
    ``n_stages``      — pipeline-stackable stages (pp must divide it);
    ``n_experts``     — MoE experts (ep must divide it);
    ``batch``/``seq``/``d_model``/``dtype_bytes`` — one step's activation
    geometry (token bytes drive the ep all_to_all and pp boundary
    volumes, and the activation share of per-device memory);
    ``optimizer_factor`` — bytes of param+optimizer state per param byte
    (3.0 = Adam: weight + m + v);
    ``seq_parallel``  — allow sp > 1 (ring attention over the sequence
    axis; off by default — short sequences only pay ring latency).
    """

    def __init__(self, dense_bytes=0, stage_bytes=0, expert_bytes=0,
                 n_stages=1, n_experts=1, batch=1, seq=1, d_model=1,
                 dtype_bytes=4, optimizer_factor=3.0, seq_parallel=False):
        self.dense_bytes = int(dense_bytes)
        self.stage_bytes = int(stage_bytes)
        self.expert_bytes = int(expert_bytes)
        self.n_stages = max(1, int(n_stages))
        self.n_experts = max(1, int(n_experts))
        self.batch = max(1, int(batch))
        self.seq = max(1, int(seq))
        self.d_model = max(1, int(d_model))
        self.dtype_bytes = max(1, int(dtype_bytes))
        self.optimizer_factor = float(optimizer_factor)
        self.seq_parallel = bool(seq_parallel)

    @property
    def token_bytes(self):
        """One step's activation bytes at model width (global batch)."""
        return self.batch * self.seq * self.d_model * self.dtype_bytes

    @classmethod
    def from_params(cls, params, batch, seq=1, d_model=None, **kwargs):
        """Derive the byte/stage/expert structure from a parameter list
        using the ``stack_``/``stack_expert_`` naming convention. Works
        on gluon Parameters (``.shape``/``.name``) and on anything
        shaped+named alike."""
        dense = stage = expert = 0
        n_stages = n_experts = 1
        last_dims = {}
        for p in params:
            shape = tuple(int(s) for s in p.shape)
            size = 1
            for s in shape:
                size *= s
            nbytes = size * kwargs.get("dtype_bytes", 4)
            name = p.name
            if re.search(r"stack_expert_", name):
                expert += nbytes
                n_stages = max(n_stages, shape[0])
                n_experts = max(n_experts, shape[1])
            elif re.search(r"(^|_)stack_", name):
                stage += nbytes
                n_stages = max(n_stages, shape[0])
            else:
                dense += nbytes
            if len(shape) >= 2:
                last_dims[shape[-1]] = last_dims.get(shape[-1], 0) + 1
        if d_model is None:
            # most params project back to model width, so the MODE of
            # the trailing dims is d_model (the widest would pick the
            # 3x-wide fused QKV or the FFN hidden and overstate every
            # token-volume term); pass d_model explicitly when in doubt
            d_model = max(last_dims, key=lambda d: (last_dims[d], d),
                          default=1)
        return cls(dense_bytes=dense, stage_bytes=stage, expert_bytes=expert,
                   n_stages=n_stages, n_experts=n_experts, batch=batch,
                   seq=seq, d_model=d_model, **kwargs)

    @classmethod
    def from_block(cls, block, batch, seq=1, **kwargs):
        """``from_params`` over a gluon block's collected parameters."""
        return cls.from_params(list(block.collect_params().values()),
                               batch, seq=seq, **kwargs)


class ShardingPlan:
    """One concrete placement: axis sizes over one device pool.

    Immutable value object; equality is placement equality (the
    checkpoint restore path compares the saved plan against the current
    one to decide whether a re-plan happened)."""

    def __init__(self, dp=1, pp=1, ep=1, sp=1, n_devices=None):
        self.dp, self.pp, self.ep, self.sp = (int(dp), int(pp), int(ep),
                                              int(sp))
        for a in PLAN_AXES:
            if getattr(self, a) < 1:
                raise PlanError("plan axis %s=%d must be >= 1"
                                % (a, getattr(self, a)))
        prod = self.dp * self.pp * self.ep * self.sp
        self.n_devices = prod if n_devices is None else int(n_devices)
        if self.n_devices != prod:
            raise PlanError(
                "plan %s does not cover %d devices (dp*pp*ep*sp = %d)"
                % (self.describe(), self.n_devices, prod))

    # ---- identity ---------------------------------------------------------
    def axes(self):
        return {a: getattr(self, a) for a in PLAN_AXES}

    def describe(self):
        return "·".join("%s%d" % (a, getattr(self, a)) for a in PLAN_AXES)

    def __repr__(self):
        return "ShardingPlan(%s over %d devices)" % (self.describe(),
                                                     self.n_devices)

    def __eq__(self, other):
        if not isinstance(other, ShardingPlan):
            return NotImplemented
        return (self.axes() == other.axes()
                and self.n_devices == other.n_devices)

    def __hash__(self):
        return hash((tuple(sorted(self.axes().items())), self.n_devices))

    def to_dict(self):
        d = self.axes()
        d["n_devices"] = self.n_devices
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: int(v) for k, v in d.items()
                      if k in PLAN_AXES + ("n_devices",)})

    # ---- mesh / shardings -------------------------------------------------
    @property
    def data_axes(self):
        """Mesh axes the batch dimension is sharded over. dp always; ep
        too — MoE tokens ride the expert axis (the all_to_all dataflow),
        which also multiplies the effective data sharding. A size-1 axis
        in a PartitionSpec is a no-op, so the tuple is stable across
        plans (one program shape per model, not per placement)."""
        return ("dp", "ep")

    @property
    def multi_axis(self):
        """True when any non-data axis is active (pp/ep/sp > 1) — the
        placements whose collectives the watchdog should bound."""
        return self.pp > 1 or self.ep > 1 or self.sp > 1

    def mesh(self, devices=None):
        """The plan's :class:`~.mesh.Mesh` over ``devices`` (every visible
        GPU when None)."""
        from .mesh import make_mesh
        return make_mesh(dp=self.dp, pp=self.pp, ep=self.ep, sp=self.sp,
                         devices=devices)

    def batch_sharding(self, mesh):
        from .mesh import NamedSharding, PartitionSpec
        return NamedSharding(mesh, PartitionSpec(self.data_axes))

    def param_rules(self):
        """(regex -> PartitionSpec) rules for the documented naming
        convention; prepend model-specific rules (e.g. tp) freely."""
        from .mesh import PartitionSpec as P
        return [
            (r"stack_expert_", P("pp", "ep")),
            (r"(^|_)stack_", P("pp")),
        ]

    # ---- cost model -------------------------------------------------------
    def feasible(self, profile, hbm_bytes=0):
        """None when this placement can run ``profile``; else the reason
        it cannot (divisibility or the per-device memory gate)."""
        if profile.n_stages % self.pp:
            return ("pp=%d does not divide %d stages"
                    % (self.pp, profile.n_stages))
        if self.ep > profile.n_experts or profile.n_experts % self.ep:
            return ("ep=%d does not divide %d experts"
                    % (self.ep, profile.n_experts))
        if profile.batch % (self.dp * self.ep):
            return ("batch %d not divisible over dp*ep=%d"
                    % (profile.batch, self.dp * self.ep))
        if profile.seq % self.sp:
            return ("sp=%d does not divide seq %d"
                    % (self.sp, profile.seq))
        if hbm_bytes and self.memory_per_device(profile) > hbm_bytes:
            return ("needs %d bytes/device > budget %d"
                    % (self.memory_per_device(profile), int(hbm_bytes)))
        return None

    def memory_per_device(self, profile):
        """Analytic bytes/device: params+optimizer state under this
        placement plus one step's activation shard."""
        param = (profile.dense_bytes
                 + profile.stage_bytes / self.pp
                 + profile.expert_bytes / (self.pp * self.ep))
        act = (profile.token_bytes * (profile.n_stages / self.pp)
               / (self.dp * self.ep * self.sp))
        return int(profile.optimizer_factor * param + act)

    def serving_memory_per_device(self, profile, kv_bytes=0):
        """Analytic inference bytes/device: weights only (no optimizer
        state), one decode step's activation shard, plus this device's
        slice of the KV arena. The arena's layer dim shards over pp and
        its slot dim over the data axes, so its shard divides by the
        whole mesh — ``kv_bytes`` is the GLOBAL arena size
        (:meth:`~mxnet_tpu.serving.generation.SlotKVCache.nbytes` x2
        for k+v)."""
        param = (profile.dense_bytes
                 + profile.stage_bytes / self.pp
                 + profile.expert_bytes / (self.pp * self.ep))
        act = (profile.token_bytes * (profile.n_stages / self.pp)
               / (self.dp * self.ep * self.sp))
        kv = float(kv_bytes) / (self.pp * self.dp * self.ep * self.sp)
        return int(param + act + kv)

    def serving_feasible(self, profile, hbm_bytes=0, kv_bytes=0):
        """None when this placement can SERVE ``profile``; else the
        reason. Same divisibility gates as :meth:`feasible`, but the
        memory gate uses :meth:`serving_memory_per_device` (no
        optimizer state, KV arena included)."""
        reason = self.feasible(profile)
        if reason:
            return reason
        if hbm_bytes:
            need = self.serving_memory_per_device(profile, kv_bytes)
            if need > hbm_bytes:
                return ("needs %d bytes/device > budget %d (serving: "
                        "weights + kv arena)" % (need, int(hbm_bytes)))
        return None

    def decode_cost(self, profile):
        """Latency-weighted cost of ONE decode step (lower is better) —
        the serving planner's objective, where training's volume model
        is wrong on purpose:

        - decode is HBM-bandwidth bound: the critical path reads every
          weight byte the token traverses. pp stages run SERIALLY per
          token, so pp cuts nothing off that path (dense + stage reads
          stay whole); ep genuinely divides the expert reads;
        - pp adds a serialized boundary hop per stage — decode's tokens
          are tiny, so each hop is latency- not bandwidth-priced
          (weight 8 vs the training model's 2);
        - ep pays its two all_to_alls (dispatch + combine, no backward);
        - sp rotates the K/V ring on the critical path;
        - dp moves nothing (weights replicated, no gradients) — it buys
          throughput, never latency, so it only breaks ties.
        """
        hbm = (profile.dense_bytes + profile.stage_bytes
               + profile.expert_bytes / self.ep)
        tokens_local = profile.token_bytes / (self.dp * self.ep * self.sp)
        comm = tokens_local * (8.0 * (self.pp - 1)
                               + 2.0 * (self.ep - 1) / self.ep
                               + 4.0 * (self.sp - 1))
        return hbm + comm

    def comm_cost(self, profile):
        """Analytic per-step communication volume (bytes moved per
        device, lower is better). Per axis:

        - dp: ring gradient AllReduce over the local param shard,
          2 * local * (dp-1)/dp;
        - ep: two all_to_alls each way (dispatch + combine, fwd + bwd)
          over this device's token shard, 4 * tokens_local * (ep-1)/ep;
        - pp: activations crossing each stage boundary, fwd + bwd;
        - sp: K/V blocks rotating the full ring (ring attention).
        """
        local_param = (profile.dense_bytes
                       + profile.stage_bytes / self.pp
                       + profile.expert_bytes / (self.pp * self.ep))
        tokens_local = profile.token_bytes / (self.dp * self.ep * self.sp)
        cost = 2.0 * local_param * (self.dp - 1) / self.dp
        cost += 4.0 * tokens_local * (self.ep - 1) / self.ep
        cost += 2.0 * tokens_local * (self.pp - 1)
        cost += 2.0 * 2.0 * tokens_local * (self.sp - 1)
        return cost


def _factorizations(n, seq_parallel):
    for pp in range(1, n + 1):
        if n % pp:
            continue
        rest = n // pp
        for ep in range(1, rest + 1):
            if rest % ep:
                continue
            rest2 = rest // ep
            sps = range(1, rest2 + 1) if seq_parallel else (1,)
            for sp in sps:
                if rest2 % sp:
                    continue
                yield rest2 // sp, pp, ep, sp  # dp, pp, ep, sp


def _parse_force(force):
    if isinstance(force, ShardingPlan):
        return force
    if isinstance(force, dict):
        bad = set(force) - set(PLAN_AXES + ("n_devices",))
        if bad:
            raise PlanError("bad forced-plan axes %s (want one of %s)"
                            % (sorted(bad), "/".join(PLAN_AXES)))
        return ShardingPlan(**force)
    axes = {}
    for part in str(force).split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k.strip() not in PLAN_AXES:
            raise PlanError("bad MXNET_PLAN_FORCE axis %r (want one of %s)"
                            % (k, "/".join(PLAN_AXES)))
        try:
            axes[k.strip()] = int(v)
        except (TypeError, ValueError):
            raise PlanError("bad MXNET_PLAN_FORCE value %r for axis %s "
                            "(want an integer)" % (v, k.strip())) from None
    if not axes:
        raise PlanError("empty forced plan %r" % (force,))
    return ShardingPlan(**axes)


def plan_sharding(n_devices, profile, hbm_bytes=None, max_pp=None,
                  force=None):
    """Choose the cheapest feasible placement of ``profile`` on
    ``n_devices``.

    Enumerates every dp*pp*ep(*sp) factorization, drops the infeasible
    ones (stage/expert/batch divisibility, the per-device memory budget),
    and returns the minimum :meth:`ShardingPlan.comm_cost`; ties prefer
    larger dp then smaller pp (data parallelism is the axis with the
    fewest program-shape consequences). Raises :class:`PlanError` with
    every candidate's rejection reason when NOTHING fits — the "experts
    x memory don't factor over this pool" error an operator must see.

    ``force`` (or ``MXNET_PLAN_FORCE``) bypasses the search but is still
    validated against the profile.
    """
    from .. import config as _config

    n_devices = int(n_devices)
    if n_devices < 1:
        raise PlanError("n_devices must be >= 1, got %d" % n_devices)
    if hbm_bytes is None:
        hbm_bytes = _config.get("MXNET_PLAN_HBM_BYTES")
    hbm_bytes = int(hbm_bytes or 0)
    if max_pp is None:
        max_pp = _config.get("MXNET_PLAN_MAX_PP")
    max_pp = int(max_pp or 0)
    if force is None:
        force = _config.get("MXNET_PLAN_FORCE") or None
    if force is not None:
        plan = _parse_force(force)
        if plan.n_devices != n_devices:
            raise PlanError("forced plan %s covers %d devices, pool has %d"
                            % (plan.describe(), plan.n_devices, n_devices))
        reason = plan.feasible(profile, hbm_bytes)
        if reason:
            raise PlanError("forced plan %s infeasible: %s"
                            % (plan.describe(), reason))
        return plan

    best, best_key = None, None
    rejected = []
    for dp, pp, ep, sp in _factorizations(n_devices, profile.seq_parallel):
        if max_pp and pp > max_pp:
            continue
        cand = ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        reason = cand.feasible(profile, hbm_bytes)
        if reason:
            rejected.append("%s: %s" % (cand.describe(), reason))
            continue
        key = (cand.comm_cost(profile), -dp, pp)
        if best_key is None or key < best_key:
            best, best_key = cand, key
    if best is None:
        raise PlanError(
            "no feasible placement of %d stages x %d experts (batch %d) "
            "on %d devices%s:\n  %s"
            % (profile.n_stages, profile.n_experts, profile.batch,
               n_devices,
               " under %d bytes/device" % hbm_bytes if hbm_bytes else "",
               "\n  ".join(rejected) or "<no factorization>"))
    return best


def plan_serving(n_devices, profile, hbm_bytes=None, kv_bytes=0,
                 max_pp=None, force=None):
    """Choose the lowest-LATENCY feasible placement of ``profile`` on
    ``n_devices`` for decode serving.

    Same factorization space and typed :class:`PlanError` as
    :func:`plan_sharding`, but scored by
    :meth:`ShardingPlan.decode_cost` (per-token critical path: HBM
    weight reads + latency-priced hops — prefers ep over pp, which a
    volume model would happily pick) and gated by
    :meth:`ShardingPlan.serving_feasible` (weights only, no optimizer
    state, plus the ``kv_bytes`` KV-arena shard). Ties prefer larger ep
    (shards the weight reads), then larger dp (free throughput), then
    smaller pp.

    ``profile.batch`` should be the decode slot count and
    ``profile.seq`` the arena's max sequence length — what one decode
    step actually touches. Knobs: ``MXNET_SERVE_PLAN_HBM_BYTES``,
    ``MXNET_SERVE_PLAN_MAX_PP``, ``MXNET_SERVE_PLAN_FORCE`` (an
    explicit ``"dp=1,ep=8"`` placement — still validated).
    """
    from .. import config as _config

    n_devices = int(n_devices)
    if n_devices < 1:
        raise PlanError("n_devices must be >= 1, got %d" % n_devices)
    if hbm_bytes is None:
        hbm_bytes = _config.get("MXNET_SERVE_PLAN_HBM_BYTES")
    hbm_bytes = int(hbm_bytes or 0)
    kv_bytes = int(kv_bytes or 0)
    if max_pp is None:
        max_pp = _config.get("MXNET_SERVE_PLAN_MAX_PP")
    max_pp = int(max_pp or 0)
    if force is None:
        force = _config.get("MXNET_SERVE_PLAN_FORCE") or None
    if force is not None:
        plan = _parse_force(force)
        if plan.n_devices != n_devices:
            raise PlanError("forced serving plan %s covers %d devices, "
                            "pool has %d"
                            % (plan.describe(), plan.n_devices, n_devices))
        reason = plan.serving_feasible(profile, hbm_bytes, kv_bytes)
        if reason:
            raise PlanError("forced serving plan %s infeasible: %s"
                            % (plan.describe(), reason))
        return plan

    best, best_key = None, None
    rejected = []
    for dp, pp, ep, sp in _factorizations(n_devices, profile.seq_parallel):
        if max_pp and pp > max_pp:
            continue
        cand = ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        reason = cand.serving_feasible(profile, hbm_bytes, kv_bytes)
        if reason:
            rejected.append("%s: %s" % (cand.describe(), reason))
            continue
        key = (cand.decode_cost(profile), -ep, -dp, pp)
        if best_key is None or key < best_key:
            best, best_key = cand, key
    if best is None:
        raise PlanError(
            "no feasible SERVING placement of %d stages x %d experts "
            "(%d slots) on %d devices%s:\n  %s"
            % (profile.n_stages, profile.n_experts, profile.batch,
               n_devices,
               " under %d bytes/device" % hbm_bytes if hbm_bytes else "",
               "\n  ".join(rejected) or "<no factorization>"))
    return best


def min_memory_per_device(n_devices, profile, max_pp=None):
    """The tightest bytes/device any feasible placement of ``profile``
    achieves on ``n_devices`` (divisibility gates only). Feed it back as
    ``hbm_bytes`` with a small headroom to model a job that barely fits
    — the memory-constrained regime where pipeline/expert sharding beats
    pure dp. Honors the same ``MXNET_PLAN_MAX_PP`` cap as
    :func:`plan_sharding` (a budget derived from an uncapped minimum
    would make every capped candidate infeasible). Raises
    :class:`PlanError` when nothing factors."""
    if max_pp is None:
        from .. import config as _config
        max_pp = _config.get("MXNET_PLAN_MAX_PP")
    max_pp = int(max_pp or 0)
    best = None
    for dp, pp, ep, sp in _factorizations(int(n_devices),
                                          profile.seq_parallel):
        if max_pp and pp > max_pp:
            continue
        cand = ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        if cand.feasible(profile):
            continue
        mem = cand.memory_per_device(profile)
        if best is None or mem < best:
            best = mem
    if best is None:
        raise PlanError("no feasible placement of %d stages x %d experts "
                        "on %d devices" % (profile.n_stages,
                                           profile.n_experts, n_devices))
    return best


def min_serving_memory_per_device(n_devices, profile, kv_bytes=0,
                                  max_pp=None):
    """Serving twin of :func:`min_memory_per_device`: the tightest
    bytes/device any feasible placement needs to SERVE ``profile``
    (weights + kv arena, no optimizer state). Feed it back as
    ``hbm_bytes`` with headroom to model the model-does-not-fit-one-chip
    serving regime. Honors ``MXNET_SERVE_PLAN_MAX_PP``."""
    if max_pp is None:
        from .. import config as _config
        max_pp = _config.get("MXNET_SERVE_PLAN_MAX_PP")
    max_pp = int(max_pp or 0)
    best = None
    for dp, pp, ep, sp in _factorizations(int(n_devices),
                                          profile.seq_parallel):
        if max_pp and pp > max_pp:
            continue
        cand = ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        if cand.feasible(profile):
            continue
        mem = cand.serving_memory_per_device(profile, kv_bytes)
        if best is None or mem < best:
            best = mem
    if best is None:
        raise PlanError("no feasible serving placement of %d stages x "
                        "%d experts on %d devices"
                        % (profile.n_stages, profile.n_experts,
                           n_devices))
    return best


def respread(total_devices, world_size):
    """Per-worker device count after a re-form: the supervise loop's
    post-eviction spread, delegated here so it matches what the
    worker-side planner can actually factor.

    The flat ``total // world`` the launcher used assumed a pure-dp
    world (any count factors as dp=N); a pp/ep job needs a pool the
    axis search can split, so the spread is rounded DOWN to a power of
    two — every candidate axis size the planner enumerates then has a
    matching cofactor, and a re-formed world-1 job always gets a valid
    re-placement instead of an un-factorable mesh (e.g. 8 devices over
    3 workers -> 2 each, not a 2.67-device fiction).

    The floor deliberately idles devices on non-pow2 pools (12 over 1
    world runs 8): the supervisor has no model profile, and a flat
    count like 6 or 7 can have NO feasible placement at all for the
    common pow2-shaped jobs (7 forces dp=7, which divides no pow2
    batch) — a smaller world that trains beats a bigger one that
    raises PlanError at startup. Jobs that know their profile factors
    a non-pow2 pool can pass ``--total-devices`` sized accordingly."""
    total, world = int(total_devices), int(world_size)
    if world < 1 or total < 1:
        return 1
    per = max(1, total // world)
    pow2 = 1
    while pow2 * 2 <= per:
        pow2 *= 2
    return pow2
