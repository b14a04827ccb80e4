"""The port's restore-and-replay (``resilience.resume``), checkpoint
atomicity, membership with injected clocks, preemption accounting and
the reshard on resume, on the CPU: the counterparts of
``tests/test_resilience.py``'s checkpoint, resume and elastic cases. Meshes
are logical CPU devices; the reference's ``resumable_fit`` is held
against the port's on the same model and batches."""
import os
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.resilience import (FatalFault, ResumeGaveUp, chaos,
                                        resumable_fit)
from mxnet_tpu_torch.resilience import elastic as elastic_mod
from mxnet_tpu_torch.resilience import resume as resume_mod


@pytest.fixture(autouse=True)
def _disarm_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _net(pkg, seed):
    pkg.random.seed(seed)
    np.random.seed(seed)
    net = pkg.gluon.nn.Sequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"), pkg.gluon.nn.Dense(4))
    net.initialize(pkg.init.Xavier())
    net(pkg.nd.zeros((2, 8)))
    return net


def _make_trainer(seed=0, dp=None):
    with tmx.cpu():
        net = _net(tmx, seed)
    kw = {"device": "cpu"} if dp is None else {"mesh": parallel.make_mesh(
        dp=dp, devices=[tmx.cpu(i) for i in range(dp)])}
    return parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, **kw)


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8, 8).astype("float32"),
             rng.randint(0, 4, (8,)).astype("float32")) for _ in range(n)]


def _values(t):
    from mxnet_tpu_torch.parallel.mesh import ShardedTensor
    return [v.full("cpu") if isinstance(v, ShardedTensor) else
            v.detach().clone() for v in t.values.values()]


def _states(t):
    from mxnet_tpu_torch.parallel.mesh import ShardedTensor
    return [s.full("cpu") if isinstance(s, ShardedTensor) else s.clone()
            for st in t.states.values() for s in st]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoint atomicity
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_checkpoint_save_atomic_under_mid_save_crash(tmp_path):
    t = _make_trainer()
    for x, y in _batches(2, seed=1):
        t.step(x, y)
    ckpt = str(tmp_path / "ckpt")
    parallel.save_checkpoint(t, ckpt)
    good_vals, good_step = _values(t), t._t
    t.step(*_batches(1, seed=2)[0])
    chaos.arm("checkpoint.save", "fatal", first=1)
    with pytest.raises(FatalFault):
        parallel.save_checkpoint(t, ckpt)
    t2 = _make_trainer(seed=9)
    parallel.restore_checkpoint(t2, ckpt)
    assert t2._t == good_step
    _equal(good_vals, _values(t2))
    parallel.save_checkpoint(t, ckpt)
    t3 = _make_trainer(seed=10)
    parallel.restore_checkpoint(t3, ckpt)
    assert t3._t == t._t


def test_checkpoint_save_promotes_old_and_honors_force(tmp_path):
    t = _make_trainer()
    t.step(*_batches(1, seed=6)[0])
    ckpt = str(tmp_path / "ckpt")
    parallel.save_checkpoint(t, ckpt)
    step_saved = t._t
    os.rename(ckpt, ckpt + ".old")       # a crash between the renames
    t.step(*_batches(1, seed=7)[0])
    chaos.arm("checkpoint.save", "fatal", first=1)
    with pytest.raises(FatalFault):
        parallel.save_checkpoint(t, ckpt)
    t2 = _make_trainer(seed=11)
    parallel.restore_checkpoint(t2, ckpt)
    assert t2._t == step_saved
    with pytest.raises(FileExistsError):
        parallel.save_checkpoint(t, ckpt, force=False)
    assert not os.path.exists(ckpt + ".tmp")
    shutil.rmtree(ckpt)


# ---------------------------------------------------------------------------
# resumable_fit
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_resume_survives_fault_on_initial_checkpoint(tmp_path):
    chaos.arm("checkpoint.save", "transient", first=1)
    t = _make_trainer(seed=3)
    losses = resumable_fit(t, _batches(3, seed=8), str(tmp_path / "e"),
                           ckpt_every=2)
    assert t._t == 3 and all(l is not None for l in losses)


@pytest.mark.chaos
@pytest.mark.parametrize("dp", [None, 2])
def test_resume_equivalence_bitwise(tmp_path, dp):
    """A fault at step 5 of 8, resumed: the losses and the parameters of
    the uninterrupted run, bit for bit (one device, and over a mesh)."""
    batches = _batches(8, seed=3)
    ta = _make_trainer(seed=0, dp=dp)
    clean = resumable_fit(ta, batches, str(tmp_path / "a"), ckpt_every=2,
                          seed=123)
    before = resume_mod.resume_stats()
    chaos.arm("trainer.step", "fatal", at=5)
    tb = _make_trainer(seed=0, dp=dp)
    resumed = resumable_fit(tb, batches, str(tmp_path / "b"), ckpt_every=2,
                            seed=123)
    after = resume_mod.resume_stats()
    assert after["restores"] == before["restores"] + 1
    assert after["replayed_steps"] >= before["replayed_steps"]
    assert tb._t == ta._t == 8
    _equal(_values(ta), _values(tb))
    _equal(_states(ta), _states(tb))
    assert clean == resumed


@pytest.mark.chaos
def test_resume_survives_transient_every_n(tmp_path):
    chaos.arm("trainer.step", "transient", every=4)
    t = _make_trainer(seed=1)
    losses = resumable_fit(t, _batches(6, seed=4), str(tmp_path / "c"),
                           ckpt_every=2)
    assert t._t == 6
    assert all(l is not None and np.isfinite(l) for l in losses)


@pytest.mark.chaos
def test_resume_gives_up_after_max_restores(tmp_path):
    chaos.arm("trainer.step", "fatal", every=1)
    t = _make_trainer(seed=2)
    with pytest.raises(ResumeGaveUp):
        resumable_fit(t, _batches(3, seed=5), str(tmp_path / "d"),
                      ckpt_every=1, max_restores=2)


def test_resumable_fit_matches_reference(tmp_path):
    """The reference's resumable_fit and the port's over the same MLP,
    batches and fault: the same step count and restores, losses and
    parameters at the training tests' tolerance."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jparallel
    from mxnet_tpu.resilience import chaos as jchaos
    from mxnet_tpu.resilience import resume as jresume
    batches = _batches(6, seed=41)
    jnet = _net(jmx, 0)
    jt = jparallel.ShardedTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2},
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    jchaos.clear()
    jchaos.arm("trainer.step", "fatal", at=4)
    jbefore = jresume.resume_stats()["restores"]
    try:
        jl = jresume.resumable_fit(
            jt, [(jmx.nd.array(x), jmx.nd.array(y)) for x, y in batches],
            str(tmp_path / "j"), ckpt_every=3, seed=5)
    finally:
        jchaos.clear()
    chaos.arm("trainer.step", "fatal", at=4)
    before = resume_mod.resume_stats()["restores"]
    t = _make_trainer(seed=0)
    tl = resumable_fit(t, batches, str(tmp_path / "t"), ckpt_every=3,
                       seed=5)
    assert resume_mod.resume_stats()["restores"] - before == \
        jresume.resume_stats()["restores"] - jbefore == 1
    assert t._t == jt._t == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for a, b in zip(_values(t), jt._values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_resume_counters_reach_aggregate_rows(tmp_path):
    from mxnet_tpu_torch.resilience import aggregate_rows
    t = _make_trainer(seed=6)
    resumable_fit(t, _batches(2, seed=9), str(tmp_path / "r"), ckpt_every=1)
    rows = aggregate_rows()
    for k in ("checkpoints", "restores", "replayed_steps", "completed_runs"):
        assert "resilience.resume.%s" % k in rows
    assert rows["resilience.resume.completed_runs"][0] >= 1
    assert "resilience.elastic.resharded_restores" in rows


# ---------------------------------------------------------------------------
# membership, preemption accounting, reshard on resume
# ---------------------------------------------------------------------------

def test_elastic_membership_fake_clock(tmp_path):
    from mxnet_tpu_torch.resilience.elastic import (ElasticCoordinator,
                                                    ElasticMember)
    clk = [1000.0]

    def fake():
        return clk[0]
    d = str(tmp_path / "rdzv")
    m0 = ElasticMember(d, 0, world_size=2, clock=fake)
    m1 = ElasticMember(d, 1, world_size=2, clock=fake)
    coord = ElasticCoordinator(d, world_size=2, deadline_ms=5000, clock=fake)
    m0.register()
    m1.register()
    snap = coord.snapshot()
    assert snap[0]["alive"] and snap[1]["alive"]
    assert coord.world() == 2 and coord.dead() == []
    clk[0] += 4.0
    m0.heartbeat(step=7)
    clk[0] += 2.0
    assert coord.dead() == [1]
    assert coord.world() == 1 and coord.snapshot()[0]["step"] == 7
    m1.heartbeat(step=3)
    assert coord.dead() == [] and coord.world() == 2
    m1.leave("preempted", step=4)
    clk[0] += 60.0
    m0.heartbeat(step=9)
    assert coord.dead() == []
    assert coord.snapshot()[1]["status"] == "preempted"
    assert coord.world() == 1
    del coord


def test_elastic_preemption_never_counts_toward_giveup(tmp_path):
    """With the restore budget spent by a real fault, an eviction notice
    still gives an emergency checkpoint and Preempted (never
    ResumeGaveUp), a fault in the emergency save itself is retried, and
    the restarted run ends bitwise the uninterrupted one."""
    from mxnet_tpu_torch.resilience import Preempted, PreemptionHandler
    batches = _batches(6, seed=21)
    ph = PreemptionHandler(grace_ms=60000)
    chaos.arm("trainer.step", "fatal", at=2)
    chaos.arm("checkpoint.save", "transient", at=2)

    def on_step(step, loss):
        if step == 3:
            ph.trigger()

    t = _make_trainer(seed=4)
    with pytest.raises(Preempted) as ei:
        resumable_fit(t, batches, str(tmp_path / "p"), ckpt_every=100,
                      max_restores=1, seed=7, on_step=on_step,
                      preemption=ph)
    assert ei.value.step == t._t == 3
    ckpt = str(tmp_path / "p" / "resume_ckpt")
    assert os.path.exists(ckpt)
    chaos.clear()
    t2 = _make_trainer(seed=4)
    parallel.restore_checkpoint(t2, ckpt)
    assert t2._t == 3
    resumed = resumable_fit(t2, batches[3:], str(tmp_path / "p"),
                            ckpt_every=100, seed=7)
    tc = _make_trainer(seed=4)
    clean = resumable_fit(tc, batches, str(tmp_path / "q"), ckpt_every=100,
                          seed=7)
    assert resumed == clean[3:]
    _equal(_values(t2), _values(tc))


def test_reshard_on_resume_bitwise(tmp_path):
    """A checkpoint of a dp=4 mesh restores onto dp=2 with parameters and
    Adam state bitwise, counted as a reshard; the replay at the surviving
    size repeats bit for bit."""
    batches = _batches(8, seed=22)
    t4 = _make_trainer(seed=0, dp=4)
    resumable_fit(t4, batches[:4], str(tmp_path / "w4"), ckpt_every=100,
                  seed=5)
    ckpt = str(tmp_path / "w4" / "resume_ckpt")
    saved, saved_states = _values(t4), _states(t4)
    before = elastic_mod.elastic_stats()["resharded_restores"]
    replays = []
    for _ in range(2):
        t2 = _make_trainer(seed=1, dp=2)
        parallel.restore_checkpoint(t2, ckpt)
        assert t2._t == 4 and t2.mesh.size == 2
        _equal(saved, _values(t2))
        _equal(saved_states, _states(t2))
        losses = [float(t2.step(x, y)) for x, y in batches[4:]]
        replays.append((losses, _values(t2)))
    assert elastic_mod.elastic_stats()["resharded_restores"] >= before + 2
    assert replays[0][0] == replays[1][0]
    _equal(replays[0][1], replays[1][1])


def test_reshard_on_resume_bitwise_expert_axis(tmp_path):
    """An ep=4 plan's checkpoint of the MoE LM restores onto a dp2 pp2 ep2
    plan bitwise (parameters and Adam state), counted as a re-plan; the
    replay repeats bit for bit."""
    from mxnet_tpu_torch.models import moe_lm_tiny
    from mxnet_tpu_torch.parallel.planner import ShardingPlan

    def trainer_on(plan):
        tmx.random.seed(0)
        np.random.seed(0)
        with tmx.cpu():
            net = moe_lm_tiny()
            net.initialize(tmx.init.Xavier())
            net(tmx.nd.zeros((1, 4), dtype="int32"))
        return parallel.ShardedTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 1e-2}, plan=plan, device="cpu")

    rng = np.random.RandomState(22)
    batches = [(rng.randint(0, 64, (8, 16)).astype("int32"),
                rng.randint(0, 64, (8, 16)).astype("float32"))
               for _ in range(5)]
    t4 = trainer_on(ShardingPlan(dp=1, pp=2, ep=4))
    for x, y in batches[:3]:
        t4.step(x, y)
    ck = str(tmp_path / "ep4")
    parallel.save_checkpoint(t4, ck)
    saved, saved_states = _values(t4), _states(t4)
    before = elastic_mod.elastic_stats()["replans"]
    replays = []
    for _ in range(2):
        t2 = trainer_on(ShardingPlan(dp=2, pp=2, ep=2))
        parallel.restore_checkpoint(t2, ck)
        assert t2._t == 3
        _equal(saved, _values(t2))
        _equal(saved_states, _states(t2))
        losses = [float(t2.step(x, y)) for x, y in batches[3:]]
        replays.append((losses, _values(t2)))
    assert elastic_mod.elastic_stats()["replans"] >= before + 2
    assert replays[0][0] == replays[1][0]
    _equal(replays[0][1], replays[1][1])
