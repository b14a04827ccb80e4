"""The port's elastic training (``resilience.elastic``) and its launcher
(``python -m mxnet_tpu_torch.tools.launch``) on the CPU: the counterparts of
``tests/test_elastic.py`` and of the watchdog, re-plan and supervised
cases of ``tests/test_planner.py``.

In-process: the ``host_loss`` and ``preempt`` chaos kinds, the
``PreemptionHandler`` grace window, the collective watchdog (and its
kvstore, pipeline, MoE and planned-step wiring), ``DeviceFeed.flush`` and
``step_stream``'s preemption at a chunk boundary, the ``/healthz`` view.

Across processes (real workers under the launcher, gloo on the CPU): the
plain launcher kills the remaining groups on the first failure; the
supervisor spawns through the ``MXTPU_SSH`` shim; a 2-worker job that
loses a worker (``host_loss``, exit 137) re-forms at world 1 on a larger
logical-device pool and resumes bitwise equal to a restore-and-replay of
the same checkpoint; a real SIGTERM gives an emergency checkpoint, exit
75, an eviction and a completed run. The four jobs run at once in one
module fixture (each worker pays a torch import)."""
import json
import os
import shutil
import signal
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.resilience.elastic import (CollectiveTimeout,
                                                CollectiveWatchdog,
                                                EXIT_PREEMPTED, Preempted,
                                                PreemptionHandler)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"]
WORKER = os.path.join(REPO, "tests", "dist_torch", "elastic_worker.py")
PLANNER_WORKER = os.path.join(REPO, "tests", "dist_torch",
                              "planner_worker.py")


@pytest.fixture(autouse=True)
def _disarm_chaos():
    from mxnet_tpu_torch.resilience import elastic
    chaos.clear()
    elastic.clear_collective_alarm()
    yield
    chaos.clear()
    elastic.clear_collective_alarm()


# ---------------------------------------------------------------------------
# chaos kinds: host_loss and preempt
# ---------------------------------------------------------------------------

def test_chaos_host_loss_kind(monkeypatch):
    died = []
    monkeypatch.setattr(chaos, "_host_loss_action",
                        lambda msg: died.append(msg))
    chaos.arm_from_env("hl.p:host_loss:at=2")
    chaos.point("hl.p")
    assert died == []
    chaos.point("hl.p")
    assert len(died) == 1 and "host_loss" in died[0]
    chaos.point("hl.p")
    assert len(died) == 1
    assert chaos.stats()["hl.p"] == {"calls": 3, "fires": 1}


def test_chaos_preempt_kind(monkeypatch):
    sent = []
    monkeypatch.setattr(chaos, "_preempt_action",
                        lambda msg: sent.append(msg))
    chaos.arm("pr.p", "preempt", first=1)
    chaos.point("pr.p")
    assert len(sent) == 1 and "preempt" in sent[0]


def test_chaos_preempt_reaches_installed_handler():
    with PreemptionHandler(grace_ms=60000) as ph:
        chaos.arm("pr.live", "preempt", first=1)
        chaos.point("pr.live")
        for _ in range(100):
            if ph.triggered():
                break
            time.sleep(0.01)
        assert ph.triggered() and ph.signum == signal.SIGTERM


def test_chaos_spec_rejects_bad_kind():
    with pytest.raises(ValueError):
        chaos.arm_from_env("p.x:evicted")


# ---------------------------------------------------------------------------
# PreemptionHandler
# ---------------------------------------------------------------------------

def test_preemption_handler_grace_window_fake_clock():
    clk = [50.0]
    ph = PreemptionHandler(grace_ms=1000, clock=lambda: clk[0])
    assert not ph.triggered() and ph.deadline_left_ms() is None
    ph.trigger(signal.SIGUSR1)
    assert ph.triggered() and ph.signum == signal.SIGUSR1
    assert ph.deadline_left_ms() == pytest.approx(1000.0)
    clk[0] += 0.6
    assert ph.deadline_left_ms() == pytest.approx(400.0)
    ph.trigger(signal.SIGTERM)
    assert ph.signum == signal.SIGUSR1
    assert ph.deadline_left_ms() == pytest.approx(400.0)
    ph.reset()
    assert not ph.triggered() and ph.deadline_left_ms() is None


def test_preemption_handler_real_signal_and_uninstall():
    before = signal.getsignal(signal.SIGUSR1)
    ph = PreemptionHandler(grace_ms=60000,
                           signals=(signal.SIGUSR1,)).install()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if ph.triggered():
                break
            time.sleep(0.01)
        assert ph.triggered() and ph.signum == signal.SIGUSR1
    finally:
        ph.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


# ---------------------------------------------------------------------------
# the collective watchdog
# ---------------------------------------------------------------------------

def test_collective_watchdog_pass_and_error_relay():
    wd = CollectiveWatchdog(deadline_ms=5000)
    assert wd.run(lambda a, b: a + b, 2, 3) == 5
    with pytest.raises(ValueError, match="boom"):
        wd.run(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert wd.guarded == 2 and wd.timeouts == 0


def test_collective_watchdog_aborts_hung_collective():
    release = threading.Event()
    aborted = []
    wd = CollectiveWatchdog(deadline_ms=80,
                            on_abort=lambda op, d: aborted.append(op))
    t0 = time.monotonic()
    with pytest.raises(CollectiveTimeout):
        wd.run(release.wait, op="test.allreduce")
    assert time.monotonic() - t0 < 5.0
    assert aborted == ["test.allreduce"] and wd.timeouts == 1
    release.set()


def test_collective_watchdog_disabled_is_inline():
    wd = CollectiveWatchdog(deadline_ms=0)
    assert wd.run(threading.get_ident) == threading.get_ident()


def test_guard_collective_env_knob(monkeypatch):
    from mxnet_tpu_torch.resilience.elastic import guard_collective
    release = threading.Event()
    monkeypatch.delenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", raising=False)
    assert guard_collective(lambda: 7) == 7
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "60")
    with pytest.raises(CollectiveTimeout):
        guard_collective(release.wait, op="knob.test")
    release.set()


def test_kvstore_allreduce_and_barrier_guarded(monkeypatch):
    """A hung cross-process all-reduce (or barrier) surfaces from push()
    as CollectiveTimeout, not retried."""
    from mxnet_tpu_torch import kvstore as kv_mod
    from mxnet_tpu_torch.parallel import _process
    release = threading.Event()
    monkeypatch.setattr(kv_mod, "_cross_process_allreduce",
                        lambda x: release.wait() or x)
    monkeypatch.setattr(_process, "barrier", lambda: release.wait())
    monkeypatch.setattr(_process, "size", lambda: 2)
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "80")
    kv = tmx.kv.create("dist_sync")
    with tmx.cpu():
        kv.init("w", tmx.nd.ones((2,)))
        t0 = time.monotonic()
        with pytest.raises(CollectiveTimeout):
            kv.push("w", tmx.nd.ones((2,)))
    with pytest.raises(CollectiveTimeout):
        kv.barrier()
    assert time.monotonic() - t0 < 10.0
    release.set()


def _moe_trainer(plan):
    from mxnet_tpu_torch.models import moe_lm_tiny
    tmx.random.seed(0)
    np.random.seed(0)
    with tmx.cpu():
        net = moe_lm_tiny()
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((1, 4), dtype="int32"))
    return parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, plan=plan, device="cpu")


def _moe_batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (8, 16)).astype("int32"),
             rng.randint(0, 64, (8, 16)).astype("float32"))
            for _ in range(n)]


def test_pipeline_stall_raises_collective_timeout(monkeypatch):
    from mxnet_tpu_torch.parallel.pipeline import pipeline_spmd
    from mxnet_tpu_torch.resilience import elastic
    mesh = parallel.make_mesh(pp=2, devices=[tmx.cpu(0), tmx.cpu(1)])
    eye = torch.eye(4)
    params = {"w": torch.stack([eye, 2.0 * eye])}
    x = torch.ones((4, 4))

    def stage(p, a):
        return a @ p["w"]

    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "5000")
    out = pipeline_spmd(stage, params, x, mesh, n_micro=2)
    np.testing.assert_allclose(out.numpy(), 2.0 * np.ones((4, 4)))
    assert elastic.health()["status"] == "ok"
    before = elastic.elastic_stats()["collective_timeouts"]
    chaos.arm("pipeline.dispatch", "stall", first=1, delay_ms=30000)
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "100")
    t0 = time.monotonic()
    with pytest.raises(CollectiveTimeout, match="pipeline.dispatch"):
        pipeline_spmd(stage, params, x, mesh, n_micro=2)
    assert time.monotonic() - t0 < 5.0
    assert elastic.elastic_stats()["collective_timeouts"] == before + 1
    h = elastic.health()
    assert h["status"] == "degraded" and h["reason"] == "collective_timeout"
    chaos.release_stalls()
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "5000")
    pipeline_spmd(stage, params, x, mesh, n_micro=2)
    assert elastic.health()["status"] == "ok"


def test_moe_dispatch_stall_raises_collective_timeout(monkeypatch):
    from mxnet_tpu_torch.parallel.moe import (init_moe_params, moe_ffn,
                                              moe_ffn_sharded)
    mesh = parallel.make_mesh(ep=2, devices=[tmx.cpu(0), tmx.cpu(1)])
    gate, w1, w2 = init_moe_params(0, 8, 16, 4, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 8)
                         .astype("float32"))
    chaos.arm("moe.dispatch", "stall", first=1, delay_ms=30000)
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "100")
    with pytest.raises(CollectiveTimeout, match="moe.dispatch"):
        moe_ffn_sharded(x, gate, w1, w2, mesh)
    chaos.release_stalls()
    chaos.clear()
    y, _ = moe_ffn_sharded(x, gate, w1, w2, mesh, capacity_factor=100.0)
    y_ref, _ = moe_ffn(x, gate, w1, w2, capacity_factor=100.0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5)


def test_ring_dispatch_stall_raises_collective_timeout(monkeypatch):
    from mxnet_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded
    mesh = parallel.make_mesh(sp=2, devices=[tmx.cpu(0), tmx.cpu(1)])
    q = torch.randn(1, 2, 8, 4, generator=torch.Generator().manual_seed(0))
    chaos.arm("ring.dispatch", "stall", first=1, delay_ms=30000)
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "100")
    with pytest.raises(CollectiveTimeout, match="ring.dispatch"):
        ring_attention_sharded(q, q, q, mesh)
    chaos.release_stalls()


def test_trainer_3d_step_dispatch_guarded(monkeypatch):
    from mxnet_tpu_torch.parallel.planner import ShardingPlan
    t = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    x, y = _moe_batches(1)[0]
    t.step(x, y)
    chaos.arm("trainer.dispatch", "stall", first=1, delay_ms=30000)
    monkeypatch.setenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", "150")
    with pytest.raises(CollectiveTimeout):
        t.step(x, y)
    chaos.release_stalls()
    chaos.clear()
    monkeypatch.delenv("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS")
    assert torch.isfinite(t.step(x, y))


def test_guarded_step_rides_the_plan():
    from mxnet_tpu_torch.parallel.planner import ShardingPlan
    from mxnet_tpu_torch.resilience.guardrails import GuardedStep
    t = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    g = GuardedStep(t)
    try:
        for x, y in _moe_batches(2):
            loss = g.step(x, y)
        assert torch.isfinite(loss)
        assert g._plan is t.plan and g.plan is t.plan
        assert t._t == 2
    finally:
        g.close()


def test_checkpoint_roundtrip_counts_replan(tmp_path):
    from mxnet_tpu_torch.parallel.planner import ShardingPlan
    from mxnet_tpu_torch.resilience import elastic
    t = _moe_trainer(ShardingPlan(dp=1, pp=2, ep=4))
    for x, y in _moe_batches(2):
        t.step(x, y)
    ck = str(tmp_path / "ck")
    parallel.save_checkpoint(t, ck)
    before = elastic.elastic_stats()["replans"]
    t2 = _moe_trainer(ShardingPlan(dp=2, pp=2, ep=2))
    parallel.restore_checkpoint(t2, ck)
    assert t2._t == 2
    assert elastic.elastic_stats()["replans"] == before + 1
    t3 = _moe_trainer(ShardingPlan(dp=1, pp=2, ep=4))
    parallel.restore_checkpoint(t3, ck)
    assert elastic.elastic_stats()["replans"] == before + 1


# ---------------------------------------------------------------------------
# DeviceFeed.flush and step_stream's preemption
# ---------------------------------------------------------------------------

def _small_trainer():
    with tmx.cpu():
        tmx.random.seed(0)
        np.random.seed(0)
        net = gluon.nn.Sequential()
        net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((2, 8)))
    mesh = parallel.make_mesh(dp=2, devices=[tmx.cpu(0), tmx.cpu(1)])
    return parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.05}, mesh=mesh)


def _feed_batches(n, seed=13):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8, 8).astype("float32"),
             rng.randint(0, 4, (8,)).astype("float32")) for _ in range(n)]


def test_devicefeed_flush_releases_staged_batches():
    from mxnet_tpu_torch.parallel.datafeed import DeviceFeed
    t = _small_trainer()
    batches = _feed_batches(6)
    feed = DeviceFeed(batches, mesh=t.mesh, depth=3, name="flush_test")
    try:
        feed.prefill()
        n = feed.flush()
        assert n >= 1 and feed.stats()["flushed"] == n
        first = next(iter(feed))
        np.testing.assert_array_equal(first[1].full("cpu").numpy(),
                                      batches[0][1])
    finally:
        feed.close()


def test_step_stream_preemption_at_chunk_boundary():
    from mxnet_tpu_torch.parallel.datafeed import DeviceFeed

    class TriggerOnSecondCheck:
        def __init__(self):
            self.checks = 0

        def triggered(self):
            self.checks += 1
            return self.checks > 1

    t = _small_trainer()
    feed = DeviceFeed(_feed_batches(8), mesh=t.mesh, depth=4,
                      name="preempt_test")
    try:
        with pytest.raises(Preempted) as ei:
            t.step_stream(feed, steps=8, chunk=2,
                          preemption=TriggerOnSecondCheck())
        assert t._t == 2 and ei.value.step == 2
        feed.flush()
    finally:
        feed.close()


# ---------------------------------------------------------------------------
# /healthz and /metrics
# ---------------------------------------------------------------------------

def test_elastic_health_degrades_on_pending_preemption():
    from mxnet_tpu_torch.resilience import elastic
    with PreemptionHandler(grace_ms=60000) as ph:
        assert elastic.health()["status"] == "ok"
        ph.trigger()
        assert elastic.health() == {"status": "degraded",
                                    "reason": "preemption_pending"}
        assert elastic.membership_gauge()["preemption_pending"] is True
    assert elastic.health()["status"] == "ok"


def test_elastic_health_degrades_on_lost_member(tmp_path, monkeypatch):
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.elastic import (ElasticCoordinator,
                                                    ElasticMember)
    clk = [10.0]
    d = str(tmp_path / "rdzv")
    m = ElasticMember(d, 0, world_size=1, clock=lambda: clk[0])
    m.register()
    coord = ElasticCoordinator(d, world_size=1, deadline_ms=1000,
                               clock=lambda: clk[0])
    assert elastic.health()["status"] == "ok"
    clk[0] += 5.0
    h = elastic.health()
    assert h["status"] == "degraded" and h["reason"] == "members_lost"
    assert h["dead"] == [0]
    g = elastic.membership_gauge()
    assert g["membership"]["alive"] == 0 and g["membership"]["dead"] == [0]
    # a dist store of this generation counts the lost rank
    monkeypatch.setenv("MXTPU_RDZV_DIR", d)
    monkeypatch.setenv("MXNET_ELASTIC_DEADLINE_MS", "1")
    assert tmx.kv.create("dist_sync").num_dead_node == 1
    m.leave("done")
    clk[0] += 1.0
    assert elastic.health()["status"] == "ok"
    assert tmx.kv.create("dist_sync").num_dead_node == 0
    del coord


# ---------------------------------------------------------------------------
# the launcher and the supervisor, across processes
# ---------------------------------------------------------------------------

_RANK_SCRIPT = (
    "import os, sys, time\n"
    "rank = int(os.environ['MXTPU_PROCESS_ID'])\n"
    "assert os.environ['RANK'] == str(rank)\n"
    "if rank == 0:\n"
    "    time.sleep(0.3)\n"
    "    sys.exit(3)\n"
    "time.sleep(300)\n")


def _ssh_shim(tmp_path):
    shim = tmp_path / "fake_ssh"
    shim.write_text(
        "#!/bin/sh\n"
        "while true; do\n"
        "  case \"$1\" in\n"
        "    -o) shift 2;;\n"
        "    -n|-q|-T) shift;;\n"
        "    *) break;;\n"
        "  esac\n"
        "done\n"
        "host=\"$1\"; shift\n"
        "exec /bin/sh -c \"$@\"\n")
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    return shim


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _events(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


def _kill_rank1_when_stepping(rdzv, box):
    """The cloud's eviction notice: SIGTERM to rank 1 once both ranks made
    two steps (rank 0 holds a checkpoint to resume from)."""
    def record(rank):
        try:
            return json.loads((rdzv / ("member-%05d.json" % rank))
                              .read_text())
        except (OSError, ValueError):
            return {}
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        r0, r1 = record(0), record(1)
        if r1.get("status") == "up" and r1.get("step", 0) >= 2 and \
                r0.get("step", 0) >= 2:
            os.kill(r1["pid"], signal.SIGTERM)
            box["target"] = r1["pid"]
            return
        time.sleep(0.1)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Four launcher jobs at once: plain (first failure kills the rest),
    supervise over the ssh shim, a supervised host loss, a supervised
    real SIGTERM; then the host-loss run's reference replay."""
    base = tmp_path_factory.mktemp("jobs")
    out = {}
    procs = {}
    t0 = time.monotonic()
    procs["plain"] = subprocess.Popen(
        LAUNCH + ["-n", "2", "--launcher", "local", sys.executable, "-c",
                  _RANK_SCRIPT],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    hostfile = base / "hosts"
    hostfile.write_text("hostA\nhostB\n")
    procs["ssh"] = subprocess.Popen(
        LAUNCH + ["-n", "2", "--supervise", "--launcher", "ssh", "-H",
                  str(hostfile), "--event-log", str(base / "ssh.jsonl"),
                  sys.executable, "-c",
                  "import os; assert os.environ['MXTPU_RDZV_DIR']"],
        env=_env(MXTPU_SSH=_ssh_shim(base)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    loss = base / "loss"
    os.makedirs(loss)
    procs["loss"] = subprocess.Popen(
        LAUNCH + ["-n", "2", "--supervise", "--max-restarts", "0",
                  "--total-devices", "4", "--rdzv-dir", str(loss / "rdzv"),
                  "--event-log", str(loss / "events.jsonl"),
                  "--grace-ms", "20000", sys.executable, WORKER],
        env=_env(ELASTIC_WORKDIR=loss, ELASTIC_STEPS=12,
                 ELASTIC_CKPT_EVERY=2, ELASTIC_FAIL_RANK=1,
                 ELASTIC_FAIL_STEP=5, ELASTIC_FAIL_KIND="host_loss",
                 ELASTIC_FAIL_AFTER_PEER=1, ELASTIC_STEP_SLOW_MS=150),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    term = base / "term"
    os.makedirs(term / "rdzv")
    procs["term"] = subprocess.Popen(
        LAUNCH + ["-n", "2", "--supervise", "--max-restarts", "0",
                  "--total-devices", "4", "--rdzv-dir", str(term / "rdzv"),
                  "--event-log", str(term / "events.jsonl"),
                  "--grace-ms", "20000", sys.executable, WORKER],
        env=_env(ELASTIC_WORKDIR=term, ELASTIC_STEPS=12,
                 ELASTIC_CKPT_EVERY=2, ELASTIC_STEP_SLOW_MS=200),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}
    killer = threading.Thread(target=_kill_rank1_when_stepping,
                              args=(term / "rdzv", box), daemon=True)
    killer.start()
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[name] = {"rc": p.returncode, "stdout": stdout,
                         "stderr": stderr,
                         "s": time.monotonic() - t0}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    killer.join(5)
    out["term"]["killed"] = box.get("target")
    out["base"] = base
    # the reference: restore-and-replay of the snapshot gen 1 resumed
    # from, on gen 1's pool, in a fresh process
    ref = base / "ref"
    if (loss / "out" / "restored_gen1_rank0").exists():
        os.makedirs(ref / "ckpt-rank0")
        shutil.copytree(loss / "out" / "restored_gen1_rank0",
                        ref / "ckpt-rank0" / "resume_ckpt")
        rp = subprocess.run(
            [sys.executable, WORKER],
            env=_env(ELASTIC_WORKDIR=ref, ELASTIC_STEPS=12,
                     MXTPU_GENERATION=1, MXTPU_LOCAL_DEVICES=4),
            capture_output=True, text=True, timeout=240)
        out["replay"] = {"rc": rp.returncode, "stderr": rp.stderr}
    return out


def test_launch_plain_kills_group_on_first_failure(jobs):
    r = jobs["plain"]
    assert r["rc"] == 3, r["stderr"][-2000:]
    assert r["s"] < 60.0                       # the sleeper was killed
    assert '"0": 3' in r["stderr"]


def test_supervise_honors_ssh_shim(jobs):
    r = jobs["ssh"]
    assert r["rc"] == 0, r["stderr"][-2000:]
    kinds = [e["event"] for e in _events(jobs["base"] / "ssh.jsonl")]
    assert kinds[0] == "generation_start" and "run_complete" in kinds


def test_supervised_host_loss_reshard_bitwise(jobs):
    """Worker 1 dies (host_loss, exit 137) at step 5 of 12; the supervisor
    evicts it, re-forms at world 1 on the whole 4-device pool (a reshard
    2 -> 4), and the resumed run equals restore-and-replay from the same
    checkpoint bit for bit."""
    r = jobs["loss"]
    assert r["rc"] == 0, r["stderr"][-4000:]
    loss = jobs["base"] / "loss"
    evs = _events(loss / "events.jsonl")
    fail = next(e for e in evs if e["event"] == "worker_failed")
    assert fail["rank"] == 1 and fail["rc"] == 137
    assert next(e for e in evs if e["event"] == "evicted")["world"] == 1
    assert any(e["event"] == "run_complete" and e["world"] == 1
               for e in evs)
    with open(loss / "out" / "result_gen1_rank0.json") as f:
        resumed = json.load(f)
    assert resumed["devices"] == 4 and resumed["world"] == 1
    assert 0 < resumed["start_step"] < 12 and resumed["end_step"] == 12
    assert resumed["elastic"]["resharded_restores"] == 1
    assert jobs["replay"]["rc"] == 0, jobs["replay"]["stderr"][-3000:]
    with open(jobs["base"] / "ref" / "out" / "result_gen1_rank0.json") as f:
        ref = json.load(f)
    assert ref["start_step"] == resumed["start_step"]
    assert ref["losses"] == resumed["losses"]
    assert ref["params_sha256"] == resumed["params_sha256"]


def test_supervised_real_sigterm_emergency_checkpoint(jobs):
    """A real SIGTERM to worker 1: an emergency checkpoint inside the grace
    window and exit 75; the supervisor evicts, re-forms at world 1 and the
    run completes every step from a real checkpoint."""
    r = jobs["term"]
    assert jobs["term"]["killed"] is not None, "rank 1 never made progress"
    assert r["rc"] == 0, r["stderr"][-4000:]
    term = jobs["base"] / "term"
    evs = _events(term / "events.jsonl")
    fail = next(e for e in evs if e["event"] == "worker_failed")
    assert fail["reason"] == "preempted" and fail["rc"] == EXIT_PREEMPTED
    assert any(e["event"] == "evicted" and e["world"] == 1 for e in evs)
    assert any(e["event"] == "run_complete" for e in evs)
    with open(term / "out" / "result_gen1_rank0.json") as f:
        resumed = json.load(f)
    assert resumed["end_step"] == 12 and resumed["start_step"] >= 1


def test_launcher_refuses_the_telemetry_plane():
    from mxnet_tpu_torch.tools import launch
    with pytest.raises(SystemExit, match="item 11b"):
        launch.main(["-n", "2", "--telemetry-port", "9000", "true"])
    assert launch._rank_env(launch._parser().parse_args(
        ["-n", "4", "--coordinator", "10.0.0.1:999", "true"]), 3,
        hosts=["a", "b"]) == {
        "MXTPU_COORDINATOR": "10.0.0.1:999", "MXTPU_NUM_PROCESSES": "4",
        "MXTPU_PROCESS_ID": "3", "MASTER_ADDR": "10.0.0.1",
        "MASTER_PORT": "999", "RANK": "3", "WORLD_SIZE": "4",
        "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}


@pytest.mark.slow
def test_supervised_3d_host_loss_replan_bitwise(tmp_path):
    """Worker 1 of a 2-worker dp x pp x ep MoE job dies (host_loss, exit
    137); the re-formed world 1 gets the 8-device pool, plans another
    placement, restores across placements (a re-plan) and equals
    restore-and-replay of the same snapshot bit for bit."""
    from mxnet_tpu_torch.models import moe_lm_tiny
    from mxnet_tpu_torch.parallel import planner
    steps = 10
    events = tmp_path / "events.jsonl"
    proc = subprocess.run(
        LAUNCH + ["-n", "2", "--supervise", "--max-restarts", "0",
                  "--total-devices", "8", "--rdzv-dir",
                  str(tmp_path / "rdzv"), "--event-log", str(events),
                  "--grace-ms", "20000", sys.executable, PLANNER_WORKER],
        env=_env(ELASTIC_WORKDIR=tmp_path, ELASTIC_STEPS=steps,
                 ELASTIC_CKPT_EVERY=2, ELASTIC_FAIL_RANK=1,
                 ELASTIC_FAIL_STEP=4, ELASTIC_FAIL_KIND="host_loss",
                 ELASTIC_STEP_SLOW_MS=150),
        capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-4000:]
    evs = _events(events)
    fail = next(e for e in evs if e["event"] == "worker_failed")
    assert fail["rank"] == 1 and fail["rc"] == 137
    assert any(e["event"] == "evicted" and e["world"] == 1 for e in evs)
    with open(tmp_path / "out" / "result_gen1_rank0.json") as f:
        resumed = json.load(f)
    with tmx.cpu():
        prof = moe_lm_tiny().profile(batch=48, seq=64)
    gen0 = planner.plan_sharding(4, prof, hbm_bytes=int(
        planner.min_memory_per_device(4, prof) * 1.25)).to_dict()
    assert resumed["devices"] == 8 and resumed["plan"]["n_devices"] == 8
    assert resumed["plan"] != gen0
    assert resumed["replans"] >= 1
    assert 0 < resumed["start_step"] < steps == resumed["end_step"]
    ref = tmp_path / "ref"
    os.makedirs(ref / "ckpt-rank0")
    shutil.copytree(tmp_path / "out" / "restored_gen1_rank0",
                    ref / "ckpt-rank0" / "resume_ckpt")
    rp = subprocess.run([sys.executable, PLANNER_WORKER],
                        env=_env(ELASTIC_WORKDIR=ref, ELASTIC_STEPS=steps,
                                 MXTPU_GENERATION=1, MXTPU_LOCAL_DEVICES=8),
                        capture_output=True, text=True, timeout=240)
    assert rp.returncode == 0, rp.stderr[-3000:]
    with open(ref / "out" / "result_gen1_rank0.json") as f:
        refres = json.load(f)
    assert refres["plan"] == resumed["plan"]
    assert refres["losses"] == resumed["losses"]
    assert refres["params_sha256"] == resumed["params_sha256"]
