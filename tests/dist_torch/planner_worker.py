"""An elastic dp x pp x ep MoE worker started by ``python -m
mxnet_tpu_torch.tools.launch --supervise`` (the counterpart of
``tests/dist/planner_worker.py``): ``elastic_worker.py``'s protocol, with
the stage-stacked MoE LM (``models.moe_lm_tiny``) placed by the sharding
planner over this incarnation's ``MXTPU_LOCAL_DEVICES`` logical CPU
devices, under a memory budget 25% over the tightest placement's. After a
host loss the supervisor re-forms at world N-1 and re-spreads the pool,
the restarted worker plans another placement, and ``elastic_fit``'s
restore re-plans the dp x pp x ep state.

Environment: as ``elastic_worker.py`` (``ELASTIC_WORKDIR``,
``ELASTIC_STEPS`` (10), ``ELASTIC_CKPT_EVERY``, ``ELASTIC_FAIL_*``,
``ELASTIC_STEP_SLOW_MS``). Each generation's rank 0 writes
``out/result_gen<G>_rank0.json`` with the plan, the re-plans counted, the
step resumed from, the losses and the parameters' sha256.
"""
import json
import os
import shutil
import sys

import numpy as np

VOCAB, BATCH, SEQ = 64, 48, 64


def _batches(steps):
    rng = np.random.RandomState(4321)
    return [(rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32),
             rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.float32))
            for _ in range(steps)]


def main():
    rank = int(os.environ.get("MXTPU_PROCESS_ID", "0"))
    world = int(os.environ.get("MXTPU_NUM_PROCESSES", "1"))
    gen = int(os.environ.get("MXTPU_GENERATION", "0"))
    rdzv = os.environ.get("MXTPU_RDZV_DIR")
    workdir = os.environ["ELASTIC_WORKDIR"]
    steps = int(os.environ.get("ELASTIC_STEPS", "10"))
    ckpt_every = int(os.environ.get("ELASTIC_CKPT_EVERY", "2"))
    fail_rank = int(os.environ.get("ELASTIC_FAIL_RANK", "-1"))
    fail_step = int(os.environ.get("ELASTIC_FAIL_STEP", "0"))
    fail_kind = os.environ.get("ELASTIC_FAIL_KIND", "host_loss")
    slow_ms = float(os.environ.get("ELASTIC_STEP_SLOW_MS", "0"))

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd, parallel
    from mxnet_tpu_torch.context import num_local_cpus
    from mxnet_tpu_torch.models import moe_lm_tiny
    from mxnet_tpu_torch.parallel import planner
    from mxnet_tpu_torch.resilience import chaos, elastic
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elastic_worker import digest

    handler = elastic.PreemptionHandler().install()
    member = elastic.ElasticMember(rdzv, rank, world_size=world,
                                   generation=gen) if rdzv else None
    if fail_rank == rank and gen == 0 and fail_step > 0:
        chaos.arm("trainer.step", fail_kind, at=fail_step)
    if slow_ms > 0:
        chaos.arm("trainer.step", "slow", delay_ms=slow_ms, every=1)

    mx.random.seed(0)
    np.random.seed(0)
    with mx.cpu():
        net = moe_lm_tiny(vocab_size=VOCAB)
        net.initialize(mx.init.Xavier())
        net(nd.zeros((1, 4), dtype="int32"))
    n_dev = num_local_cpus()
    profile = net.profile(batch=BATCH, seq=SEQ)
    budget = int(planner.min_memory_per_device(n_dev, profile) * 1.25)
    plan = planner.plan_sharding(n_dev, profile, hbm_bytes=budget)
    trainer = parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, plan=plan)
    print("rank %d gen=%d devices=%d plan=%s"
          % (rank, gen, n_dev, plan.describe()), flush=True)
    ckpt_dir = os.path.join(workdir, "ckpt-rank%d" % rank)
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)
    rolling = os.path.join(ckpt_dir, "resume_ckpt")
    if os.path.exists(rolling):
        snap = os.path.join(out_dir, "restored_gen%d_rank%d" % (gen, rank))
        if not os.path.exists(snap):
            shutil.copytree(rolling, snap)
    try:
        start, losses = elastic.elastic_fit(
            trainer, _batches(steps), ckpt_dir, member=member,
            preemption=handler, ckpt_every=ckpt_every, seed=0)
    except elastic.Preempted as p:
        print("rank %d preempted: %s" % (rank, p), flush=True)
        sys.exit(elastic.EXIT_PREEMPTED)
    if rank == 0:
        with open(os.path.join(out_dir, "result_gen%d_rank0.json" % gen),
                  "w") as f:
            json.dump({"gen": gen, "world": world, "rank": rank,
                       "devices": n_dev, "plan": plan.to_dict(),
                       "plan_str": plan.describe(),
                       "replans": elastic.elastic_stats()["replans"],
                       "start_step": start, "end_step": trainer._t,
                       "losses": losses,
                       "params_sha256": digest(trainer)}, f)
    print("rank %d OK gen=%d start=%d end=%d plan=%s"
          % (rank, gen, start, trainer._t, plan.describe()), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
