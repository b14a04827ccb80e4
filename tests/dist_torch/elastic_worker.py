"""An elastic training worker started by ``python -m
mxnet_tpu_torch.tools.launch --supervise`` (the counterpart of
``tests/dist/elastic_worker.py``).

Each process is a whole replica trained deterministically from one seed
on one regenerated batch schedule, so the replicas stay bitwise equal
without collectives (``dist_sync_kvstore_worker.py`` runs those) and any
survivor's rolling checkpoint resumes the run. What it drives is the
elastic surface: membership records and per-step beats in
``MXTPU_RDZV_DIR``; a chaos ``host_loss`` (exit 137) or ``preempt`` at a
set step on a set rank of generation 0; a real SIGTERM (the supervisor's
teardown, or an outside kill) through ``PreemptionHandler`` to an
emergency checkpoint and exit 75; and the resume of a restarted
generation through ``elastic_fit``.

``ELASTIC_MODEL`` picks the replica:

- ``mlp`` (default): a 16 -> 32 -> 4 MLP under ``ShardedTrainer`` over a
  dp mesh of the launcher's ``MXTPU_LOCAL_DEVICES`` logical CPU devices
  (``--total-devices`` re-spread over the world: a re-formed generation
  restores onto another mesh, a real reshard), SGD;
- ``lm``: ``TransformerLM`` at width 768 (12 heads, vocab 32000,
  ``ELASTIC_LM_LAYERS`` layers, ``max_len`` 512) on ``cuda``, b8 x 512
  tokens a step, Adam lr 1e-4, through the flash-attention kernels.

Environment besides the launcher's ``MXTPU_*``: ``ELASTIC_WORKDIR``
(required: ``ckpt-rank<r>/`` and ``out/`` live there), ``ELASTIC_STEPS``
(12), ``ELASTIC_CKPT_EVERY`` (2), ``ELASTIC_FAIL_RANK``,
``ELASTIC_FAIL_STEP`` (the ``trainer.step`` call that fails, 1-based),
``ELASTIC_FAIL_KIND`` (``host_loss``), ``ELASTIC_FAIL_AFTER_PEER`` (1:
the failing call first waits until rank 0's record reports the step
before it, so the survivor has a checkpoint to resume from),
``ELASTIC_STEP_SLOW_MS`` (a delay a step, so that an outside SIGTERM
lands mid-run).

Each generation's rank 0 writes ``out/result_gen<G>_rank0.json``: the
step it resumed from, this generation's losses, the parameters' sha256,
the world and the devices; and copies the checkpoint it restored to
``out/restored_gen<G>_rank<r>`` (a reference replay starts from it).
"""
import hashlib
import json
import os
import shutil
import sys

import numpy as np

LM_WIDTH, LM_HEADS, LM_VOCAB, LM_SEQ, LM_BATCH = 768, 12, 32000, 512, 8


def _mlp_batches(steps):
    """The run's schedule, the same in every generation and rank."""
    rng = np.random.RandomState(1234)
    return [(rng.randn(8, 16).astype(np.float32),
             rng.randint(0, 4, size=(8,)).astype(np.float32))
            for _ in range(steps)]


def _lm_batches(steps):
    rng = np.random.RandomState(1234)
    out = []
    for _ in range(steps):
        x = rng.randint(0, LM_VOCAB, size=(LM_BATCH, LM_SEQ))
        y = np.concatenate([x[:, 1:], np.full((LM_BATCH, 1), -1)], 1)
        out.append((x.astype(np.int64), y.astype(np.float32)))
    return out


def build(kind, layers=2):
    """``(trainer, batches_fn, devices)`` of the replica ``kind``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    mx.random.seed(0)
    np.random.seed(0)
    if kind == "lm":
        import torch
        from mxnet_tpu_torch.models import TransformerLM
        torch.manual_seed(0)
        net = TransformerLM(LM_VOCAB, units=LM_WIDTH, num_layers=layers,
                            num_heads=LM_HEADS, max_len=LM_SEQ,
                            device=torch.device("cuda"))
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith(("gamma", "weight")) and p.dim() == 1:
                    p.fill_(1.0)
                elif p.dim() == 1:
                    p.zero_()
                else:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        tr = parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                                     {"learning_rate": 1e-4},
                                     device=torch.device("cuda"))
        return tr, _lm_batches, 1
    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        net(nd.zeros((1, 16)))
    mesh = parallel.make_mesh(dp=-1)
    tr = parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.05}, mesh=mesh)
    return tr, _mlp_batches, mesh.size


def wait_for_rank(rdzv, rank, step, timeout_s=300.0):
    """Block until ``rank``'s membership record in ``rdzv`` reports at
    least ``step`` (or has left)."""
    import time
    path = os.path.join(rdzv, "member-%05d.json" % rank)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            rec = {}
        if rec.get("step", 0) >= step or rec.get("status") not in \
                (None, "up"):
            return rec
        time.sleep(0.05)
    raise TimeoutError("rank %d never reached step %d" % (rank, step))


def digest(trainer):
    """sha256 of every parameter value, whole, in the trainer's order."""
    from mxnet_tpu_torch.parallel.mesh import ShardedTensor
    h = hashlib.sha256()
    for v in trainer.values.values():
        t = v.full("cpu") if isinstance(v, ShardedTensor) \
            else v.detach().cpu()
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def main():
    rank = int(os.environ.get("MXTPU_PROCESS_ID", "0"))
    world = int(os.environ.get("MXTPU_NUM_PROCESSES", "1"))
    gen = int(os.environ.get("MXTPU_GENERATION", "0"))
    rdzv = os.environ.get("MXTPU_RDZV_DIR")
    workdir = os.environ["ELASTIC_WORKDIR"]
    steps = int(os.environ.get("ELASTIC_STEPS", "12"))
    ckpt_every = int(os.environ.get("ELASTIC_CKPT_EVERY", "2"))
    fail_rank = int(os.environ.get("ELASTIC_FAIL_RANK", "-1"))
    fail_step = int(os.environ.get("ELASTIC_FAIL_STEP", "0"))
    fail_kind = os.environ.get("ELASTIC_FAIL_KIND", "host_loss")
    slow_ms = float(os.environ.get("ELASTIC_STEP_SLOW_MS", "0"))
    kind = os.environ.get("ELASTIC_MODEL", "mlp")

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.resilience import chaos, elastic

    # the eviction notice is caught from the first step on
    handler = elastic.PreemptionHandler().install()
    member = None
    if rdzv:
        member = elastic.ElasticMember(rdzv, rank, world_size=world,
                                       generation=gen)
    if fail_rank == rank and gen == 0 and fail_step > 0:
        chaos.arm("trainer.step", fail_kind, at=fail_step)
    if slow_ms > 0:
        chaos.arm("trainer.step", "slow", delay_ms=slow_ms, every=1)

    trainer, batches, devices = build(
        kind, int(os.environ.get("ELASTIC_LM_LAYERS", "2")))
    if fail_rank == rank and gen == 0 and fail_step > 0 and rdzv and \
            os.environ.get("ELASTIC_FAIL_AFTER_PEER") == "1":
        step, calls = trainer.step, [0]

        def step_after_peer(x, y, lr=None):
            calls[0] += 1
            if calls[0] == fail_step:
                wait_for_rank(rdzv, 0, fail_step - 1)
            return step(x, y, lr)
        trainer.step = step_after_peer
    ckpt_dir = os.path.join(workdir, "ckpt-rank%d" % rank)
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)
    # the state this generation resumes from, for a reference replay
    rolling = os.path.join(ckpt_dir, "resume_ckpt")
    if os.path.exists(rolling):
        snap = os.path.join(out_dir, "restored_gen%d_rank%d" % (gen, rank))
        if not os.path.exists(snap):
            shutil.copytree(rolling, snap)
    fa.reset_launches()
    try:
        start, losses = elastic.elastic_fit(
            trainer, batches(steps), ckpt_dir, member=member,
            preemption=handler, ckpt_every=ckpt_every, seed=0)
    except elastic.Preempted as p:
        print("rank %d preempted: %s" % (rank, p), flush=True)
        sys.exit(elastic.EXIT_PREEMPTED)
    if rank == 0:
        with open(os.path.join(out_dir, "result_gen%d_rank0.json" % gen),
                  "w") as f:
            json.dump({"gen": gen, "world": world, "rank": rank,
                       "devices": devices, "start_step": start,
                       "end_step": trainer._t, "losses": losses,
                       "params_sha256": digest(trainer),
                       "flash_launches": {
                           "fwd": fa.flash_attention_bshd.launches,
                           "dq": fa.flash_attention_bwd_dq.launches,
                           "dkv": fa.flash_attention_bwd_dkv.launches},
                       "elastic": elastic.elastic_stats()}, f)
    print("rank %d OK gen=%d start=%d end=%d devices=%d"
          % (rank, gen, start, trainer._t, devices), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
