"""The port's sharding planner (``mxnet_tpu_torch.parallel.planner``) and
plan threading against the JAX package's, on the CPU: the counterparts
of ``tests/test_planner.py``'s planner, trainer, feed, checkpoint and
chaos-stall tests. Plans are held equal to the reference's and costs to
1e-12 relative; trainers built from plans run on logical CPU devices.
The reference's watchdog and supervisor tests (``GuardedStep``, the
collective deadline, the replan counter, the supervised 3D job) are in
``tests/test_torch_elastic.py``."""
import json
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.parallel import planner as jplanner
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, initializer, nd, parallel
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.models import moe_lm_tiny
from mxnet_tpu_torch.parallel import planner
from mxnet_tpu_torch.parallel.planner import (ModelProfile, PlanError,
                                              PlanMismatchError,
                                              ShardingPlan, plan_sharding,
                                              respread)
from mxnet_tpu_torch.resilience import chaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _profile(mod=planner, dense=1 << 20, stage=1 << 20, expert=1 << 24,
             stages=2, experts=4, batch=8, seq=16, d_model=32):
    return mod.ModelProfile(dense_bytes=dense, stage_bytes=stage,
                            expert_bytes=expert, n_stages=stages,
                            n_experts=experts, batch=batch, seq=seq,
                            d_model=d_model)


def _same(plan, jplan):
    assert plan.to_dict() == jplan.to_dict()


def test_plan_covers_devices_and_respects_divisibility():
    p = plan_sharding(8, _profile())
    _same(p, jplanner.plan_sharding(8, _profile(jplanner)))
    assert p.dp * p.pp * p.ep * p.sp == p.n_devices == 8
    assert 2 % p.pp == 0 and 4 % p.ep == 0 and 8 % (p.dp * p.ep) == 0


def test_memory_gate_forces_expert_sharding():
    prof = _profile(expert=1 << 26)
    budget = ShardingPlan(dp=8).memory_per_device(prof) // 2
    assert budget == jplanner.ShardingPlan(dp=8).memory_per_device(
        _profile(jplanner, expert=1 << 26)) // 2
    p = plan_sharding(8, prof, hbm_bytes=budget)
    _same(p, jplanner.plan_sharding(8, _profile(jplanner, expert=1 << 26),
                                    hbm_bytes=budget))
    assert (p.ep > 1 or p.pp > 1) and p.memory_per_device(prof) <= budget
    assert ShardingPlan(dp=8).feasible(prof, hbm_bytes=budget) is not None


def test_no_feasible_placement_is_typed_and_named():
    with pytest.raises(PlanError, match="no feasible placement"):
        plan_sharding(8, _profile(expert=1 << 30, experts=3),
                      hbm_bytes=1 << 20)


def test_cost_prefers_dp_for_dense_small_models():
    kw = dict(dense=1 << 10, stage=1 << 10, expert=1 << 10, batch=64,
              seq=128, d_model=256)
    p = plan_sharding(8, _profile(**kw))
    assert (p.dp, p.pp, p.ep) == (8, 1, 1)
    # every candidate's costs equal the reference's
    own, ref = _profile(**kw), _profile(jplanner, **kw)
    for dp, pp, ep, sp in planner._factorizations(8, True):
        a = ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        b = jplanner.ShardingPlan(dp=dp, pp=pp, ep=ep, sp=sp)
        for f in ("comm_cost", "decode_cost"):
            x, y = getattr(a, f)(own), getattr(b, f)(ref)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1.0), f
        assert a.memory_per_device(own) == b.memory_per_device(ref)
        assert a.serving_memory_per_device(own, 1 << 20) == \
            b.serving_memory_per_device(ref, 1 << 20)


def test_forced_plan_string_dict_and_env(monkeypatch):
    prof = _profile()
    p = plan_sharding(8, prof, force="dp=2,pp=2,ep=2")
    assert (p.dp, p.pp, p.ep, p.sp) == (2, 2, 2, 1)
    p2 = plan_sharding(8, prof, force={"dp": 4, "ep": 2})
    assert (p2.dp, p2.ep) == (4, 2)
    monkeypatch.setenv("MXNET_PLAN_FORCE", "dp=4,pp=2")
    p3 = plan_sharding(8, prof)
    assert (p3.dp, p3.pp) == (4, 2)
    with pytest.raises(PlanError, match="infeasible"):
        plan_sharding(8, prof, force="dp=1,pp=1,ep=8")
    with pytest.raises(PlanError, match="covers"):
        plan_sharding(8, prof, force="dp=2,pp=2")
    with pytest.raises(PlanError):
        plan_sharding(8, prof, force="qq=8")
    monkeypatch.delenv("MXNET_PLAN_FORCE")
    monkeypatch.setenv("MXNET_SERVE_PLAN_FORCE", "dp=1,ep=8")
    with pytest.raises(PlanError, match="infeasible"):
        planner.plan_serving(8, prof)
    monkeypatch.delenv("MXNET_SERVE_PLAN_FORCE")
    _same(planner.plan_serving(8, prof, kv_bytes=1 << 20),
          jplanner.plan_serving(8, _profile(jplanner), kv_bytes=1 << 20))
    assert planner.min_memory_per_device(8, prof) == \
        jplanner.min_memory_per_device(8, _profile(jplanner))
    assert planner.min_serving_memory_per_device(8, prof, 1 << 20) == \
        jplanner.min_serving_memory_per_device(8, _profile(jplanner),
                                               1 << 20)


def test_plan_serialization_roundtrip_and_equality():
    p = ShardingPlan(dp=2, pp=2, ep=2)
    d = p.to_dict()
    assert d == {"dp": 2, "pp": 2, "ep": 2, "sp": 1, "n_devices": 8}
    assert ShardingPlan.from_dict(json.loads(json.dumps(d))) == p
    assert p != ShardingPlan(dp=4, pp=2, ep=1)
    assert p.describe() == jplanner.ShardingPlan(dp=2, pp=2,
                                                 ep=2).describe()
    assert p.multi_axis and not ShardingPlan(dp=8).multi_axis
    with pytest.raises(PlanError):
        ShardingPlan(dp=0)
    with pytest.raises(PlanError):
        ShardingPlan(dp=2, pp=2, n_devices=8)
    rules = p.param_rules()
    assert [r for r, _ in rules] == [r for r, _ in
                                     jplanner.ShardingPlan().param_rules()]
    assert tuple(rules[0][1]) == ("pp", "ep")
    mesh = p.mesh(devices=[tmx.cpu(i) for i in range(8)])
    assert dict(mesh.shape) == {"dp": 2, "pp": 2, "ep": 2, "tp": 1,
                                "sp": 1}
    assert tuple(p.batch_sharding(mesh).spec) == (("dp", "ep"),)


def test_seq_parallel_axis_opt_in():
    prof = _profile(dense=1 << 28, seq=64)
    prof.seq_parallel = True
    assert plan_sharding(8, prof).sp > 1
    assert plan_sharding(8, _profile(dense=1 << 28, seq=64)).sp == 1


def test_respread_is_planner_factorable():
    for total in (1, 2, 3, 4, 6, 8, 12, 16):
        for world in (1, 2, 3, 4, 5):
            assert respread(total, world) == jplanner.respread(total, world)
    assert respread(8, 3) == 2 and respread(6, 1) == 4


def _moe_net(seed=0, **kw):
    trandom.seed(seed)
    np.random.seed(seed)
    with tmx.cpu():
        net = moe_lm_tiny(**kw)
        net.initialize(initializer.Xavier())
        net(nd.zeros((1, 4), dtype="int32"))
    return net


def test_profile_from_block_naming_convention():
    prof = _moe_net().profile(batch=8, seq=16)
    assert prof.n_stages == 2 and prof.n_experts == 4
    assert prof.expert_bytes > 0 and prof.stage_bytes > 0
    assert prof.dense_bytes > 0
    assert prof.token_bytes == 8 * 16 * 32 * 4
    # the reference's profile of the same parameters
    ref = jplanner.ModelProfile.from_params(
        list(_moe_net().collect_params().values()), 8, seq=16, d_model=32)
    assert vars(prof) == vars(ref)


def _moe_trainer(plan, seed=0, **kw):
    return parallel.ShardedTrainer(
        _moe_net(seed, **kw), gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, plan=plan, device="cpu")


def _moe_batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (8, 16)).astype("int32"),
             rng.randint(0, 64, (8, 16)).astype("float32"))
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference_moe_losses():
    """The reference's dp=8 MoE trainer over the same batches and draws."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import parallel as jparallel
    from mxnet_tpu.models.moe_transformer import moe_lm_tiny as jtiny
    jmx.random.seed(0)
    np.random.seed(0)
    net = jtiny()
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.zeros((1, 4), dtype="int32"))
    tr = jparallel.ShardedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                  "adam", {"learning_rate": 1e-2},
                                  plan=jplanner.ShardingPlan(dp=8))
    return [float(tr.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
            for x, y in _moe_batches(3)]


def test_trainer_builds_from_plan_and_matches_pure_dp(reference_moe_losses):
    t3 = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    assert t3._batch_axes == ("dp", "ep")
    assert t3.plan.describe() == "dp2·pp2·ep2·sp1"
    assert dict(t3.mesh.shape)["pp"] == 2 and dict(t3.mesh.shape)["ep"] == 2
    ref_names = list(t3._block.collect_params().keys())
    for rname, v in zip(ref_names, t3.values.values()):
        shard = v.shards[0].shape
        if "stack_expert_" in rname:
            assert shard[0] == v.shape[0] // 2 and \
                shard[1] == v.shape[1] // 2
        elif "stack_" in rname:
            assert shard[0] == v.shape[0] // 2
        else:
            assert shard == v.shape
    tdp = _moe_trainer(ShardingPlan(dp=8))
    for (x, y), want in zip(_moe_batches(3), reference_moe_losses):
        a, b = float(t3.step(x, y)), float(tdp.step(x, y))
        assert a == pytest.approx(b, rel=1e-5)
        assert a == pytest.approx(want, rel=1e-5)


def test_same_placement_replay_is_bitwise():
    a = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    b = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    la = [float(a.step(x, y)) for x, y in _moe_batches(3)]
    lb = [float(b.step(x, y)) for x, y in _moe_batches(3)]
    assert la == lb


def test_device_feed_and_step_stream_use_plan_axes():
    plan = ShardingPlan(dp=2, pp=2, ep=2)
    t = _moe_trainer(plan)
    feed = parallel.DeviceFeed(_moe_batches(4), plan=plan, name="plan_feed",
                               device="cpu")
    try:
        x, _y = next(iter(feed))
        assert tuple(x[0].spec)[0] == ("dp", "ep")
        losses = t.step_stream(feed, steps=3, chunk=2)
        assert losses.shape == (3,) and t._t == 3
    finally:
        feed.close()
    # the same batches (the peeked one was consumed) through step()
    t2 = _moe_trainer(plan)
    want = [float(t2.step(x, y)) for x, y in _moe_batches(4)[1:]]
    np.testing.assert_array_equal(losses.numpy(), want)


def test_checkpoint_roundtrip_records_plan(tmp_path):
    t = _moe_trainer(ShardingPlan(dp=1, pp=2, ep=4))
    for x, y in _moe_batches(2):
        t.step(x, y)
    ck = str(tmp_path / "ck")
    parallel.save_checkpoint(t, ck)
    with open(tmp_path / "ck" / "manifest.json") as f:
        assert json.load(f)["plan"] == t.plan.to_dict()
    cont = _moe_batches(2, seed=4)
    want = [float(t.step(x, y)) for x, y in cont]
    for plan in (ShardingPlan(dp=2, pp=2, ep=2), ShardingPlan(dp=1, pp=2,
                                                              ep=4)):
        t2 = _moe_trainer(plan, seed=9)
        parallel.restore_checkpoint(t2, ck)
        assert t2._t == 2
        got = [float(t2.step(x, y)) for x, y in cont]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        if plan == t.plan:
            assert got == want      # the same placement: bit for bit


def test_plan_checkpoint_restores_into_planless_trainer(tmp_path):
    t = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    for x, y in _moe_batches(2):
        t.step(x, y)
    ck = str(tmp_path / "ck")
    parallel.save_checkpoint(t, ck)
    mesh = parallel.make_mesh(dp=2, devices=[tmx.cpu(0), tmx.cpu(1)])
    t2 = parallel.ShardedTrainer(_moe_net(), gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adam", {"learning_rate": 1e-2}, mesh=mesh)
    parallel.restore_checkpoint(t2, ck)
    assert t2._t == 2 and t2.plan is None


def test_restore_pre_plan_checkpoint_without_metadata(tmp_path):
    """A planless checkpoint (no plan recorded) restores into a plan-built
    trainer, and the plan-stamped one back into a planless trainer."""
    mesh = parallel.make_mesh(devices=[tmx.cpu(i) for i in range(8)])
    t = parallel.ShardedTrainer(_moe_net(), gluon.loss.SoftmaxCrossEntropyLoss(),
                                "adam", {"learning_rate": 1e-2}, mesh=mesh)
    for x, y in _moe_batches(2):
        t.step(x, y)
    ck = str(tmp_path / "ck")
    parallel.save_checkpoint(t, ck)
    t2 = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    parallel.restore_checkpoint(t2, ck)
    assert t2._t == 2
    ck2 = str(tmp_path / "ck2")
    parallel.save_checkpoint(t2, ck2)
    t3 = parallel.ShardedTrainer(_moe_net(), gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adam", {"learning_rate": 1e-2}, mesh=mesh)
    parallel.restore_checkpoint(t3, ck2)
    assert t3._t == 2 and t3.plan is None
    for a, b in zip(t.values.values(), t3.values.values()):
        assert np.array_equal(a.numpy(), b.numpy())


def test_restore_mismatch_raises_typed_plan_error(tmp_path):
    t = _moe_trainer(ShardingPlan(dp=1, pp=2, ep=4))
    t.step(*_moe_batches(1)[0])
    ck = str(tmp_path / "ck")
    parallel.save_checkpoint(t, ck)
    t2 = _moe_trainer(ShardingPlan(dp=4, pp=2, ep=1), n_experts=2)
    with pytest.raises(PlanMismatchError) as ei:
        parallel.restore_checkpoint(t2, ck)
    msg = str(ei.value)
    assert "pp2" in msg and "ep4" in msg
    assert "dp4" in msg and "ep1" in msg


def test_chaos_stall_blocks_until_released():
    chaos.arm("st.p", "stall", at=2, delay_ms=30000)
    assert chaos.point("st.p") is None
    state = {"done": False}

    def blocked():
        chaos.point("st.p")
        state["done"] = True
    th = threading.Thread(target=blocked, daemon=True)
    th.start()
    time.sleep(0.1)
    assert not state["done"]
    chaos.release_stalls()
    th.join(5.0)
    assert state["done"]
    assert chaos.stats()["st.p"] == {"calls": 2, "fires": 1}


def test_chaos_stall_cap_and_spec_grammar():
    rules = chaos.arm_from_env("st.spec:stall(40):every=2")
    assert rules[0].kind == "stall" and rules[0].delay_ms == 40.0
    t0 = time.monotonic()
    chaos.point("st.spec")
    chaos.point("st.spec")
    assert 0.02 < time.monotonic() - t0 < 5.0
    with pytest.raises(ValueError):
        chaos.arm_from_env("st.bad:stall(nope)")


def test_chaos_clear_releases_parked_stalls():
    chaos.arm("st.clear", "stall", first=1, delay_ms=30000)
    th = threading.Thread(target=lambda: chaos.point("st.clear"),
                          daemon=True)
    th.start()
    time.sleep(0.05)
    chaos.clear()
    th.join(5.0)
    assert not th.is_alive()
