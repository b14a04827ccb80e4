"""The port's in-step guardrails (``mxnet_tpu_torch.resilience.guardrails``)
on the CPU: the counterparts of ``tests/test_guardrails.py``'s guardrails,
chaos ``nan`` and counter cases, and the reference's ``GuardedStep`` held
against the port's on the same model and batches.

The contract: a guarded clean run equals the unguarded trainer bit for bit
(with and without BatchNorm aux, with dynamic power-of-two scaling); a
poisoned step leaves every parameter, optimizer state and the optimizer's
step count bitwise (so Adam's later steps equal a run without the
poisoned batch); telemetry is read only when ready (no added sync); the
scale schedule is the reference ``LossScaler``'s. The reference's own
``test_guarded_clean_run_bitwise_with_batchnorm_aux`` and
``test_checkpoint_restores_across_wrapper_change`` fail, so their cases
here hold the port to their docstrings, not to the reference."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.resilience import (AnomalyDetector, AnomalyFault,
                                        GuardedStep, StepWatchdog, chaos,
                                        guardrails, resumable_fit)
from mxnet_tpu_torch.resilience import resume as resume_mod


@pytest.fixture(autouse=True)
def _disarm_chaos():
    chaos.clear()
    yield
    chaos.clear()


def _net(pkg, seed, with_bn=False):
    pkg.random.seed(seed)
    np.random.seed(seed)
    net = pkg.gluon.nn.Sequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"))
    if with_bn:
        net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.Dense(4))
    net.initialize(pkg.init.Xavier())
    net(pkg.nd.zeros((2, 8)))
    return net


def _make_trainer(seed=0, optimizer="adam", with_bn=False, mesh=False):
    with tmx.cpu():
        net = _net(tmx, seed, with_bn)
    kw = {"mesh": parallel.make_mesh(dp=2, devices=[tmx.cpu(0),
                                                    tmx.cpu(1)])} \
        if mesh else {"device": "cpu"}
    return parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
        {"learning_rate": 1e-2}, **kw)


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8, 8).astype("float32"),
             rng.randint(0, 4, (8,)).astype("float32")) for _ in range(n)]


def _flat(tensors):
    from mxnet_tpu_torch.parallel.mesh import ShardedTensor
    return [t.full("cpu") if isinstance(t, ShardedTensor) else
            t.detach().clone() for t in tensors]


def _values_of(t):
    return _flat(t.values.values())


def _states_of(t):
    return [_flat(st) for st in t.states.values()]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _equal(x, y)
        else:
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# clean runs: bitwise the unguarded trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [False, True])
def test_guarded_clean_run_bitwise_equals_unguarded(mesh):
    batches = _batches(6, seed=3)
    ta = _make_trainer(seed=0, mesh=mesh)
    for x, y in batches:
        ta.step(x, y)
    tb = _make_trainer(seed=0, mesh=mesh)
    g = GuardedStep(tb)
    for x, y in batches:
        g.step(x, y)
    g.flush()
    assert g.skipped_steps == 0 and int(g.opt_step) == 6
    _equal(_values_of(ta), _values_of(tb))
    _equal(_states_of(ta), _states_of(tb))


def test_guarded_clean_run_bitwise_with_batchnorm_aux():
    """BatchNorm's moving statistics ride the same guarded commit."""
    batches = _batches(4, seed=5)
    ta = _make_trainer(seed=0, with_bn=True)
    for x, y in batches:
        ta.step(x, y)
    ta.sync_back()
    tb = _make_trainer(seed=0, with_bn=True)
    g = GuardedStep(tb)
    for x, y in batches:
        g.step(x, y)
    g.sync_back()
    _equal(_values_of(ta), _values_of(tb))
    own_a = dict(ta._block.named_parameters())
    for n, p in tb._block.named_parameters():
        assert torch.equal(p, own_a[n]), n


# ---------------------------------------------------------------------------
# a poisoned step is skipped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [False, True])
def test_injected_nan_step_is_skipped_bitwise(mesh):
    """The poisoned step leaves parameters, Adam's moments and the
    optimizer's step bitwise; the host step counts it; the steps after
    equal a run that never saw the poisoned batch."""
    batches = _batches(5, seed=7)
    t = _make_trainer(seed=1, mesh=mesh)
    g = GuardedStep(t, detector=False)
    for x, y in batches[:2]:
        g.step(x, y)
    g.flush()
    vals_before, states_before = _values_of(t), _states_of(t)
    chaos.arm("trainer.grads", "nan", first=1)
    loss = g.step(*batches[2])
    g.flush()
    assert not torch.isfinite(loss)
    assert g.skipped_steps == 1 and t._t == 3 and int(g.opt_step) == 2
    _equal(vals_before, _values_of(t))
    _equal(states_before, _states_of(t))
    tel = g.telemetry()
    assert tel["ok"] is False and tel["skips"] == 1
    for x, y in batches[3:]:
        assert torch.isfinite(g.step(x, y))
    g.flush()
    ref = _make_trainer(seed=1, mesh=mesh)
    for i in (0, 1, 3, 4):
        ref.step(*batches[i])
    _equal(_values_of(ref), _values_of(t))
    _equal(_states_of(ref), _states_of(t))


@pytest.mark.chaos
def test_every_injected_nan_step_skipped_none_leak():
    chaos.arm("trainer.grads", "nan", every=3)
    t = _make_trainer(seed=2)
    g = GuardedStep(t, detector=False)
    for x, y in _batches(9, seed=11):
        g.step(x, y)
    g.flush()
    fired = chaos.stats()["trainer.grads"]["fires"]
    assert fired == 3 and g.skipped_steps == fired
    assert all(torch.isfinite(v).all() for v in _values_of(t))


def test_unguarded_trainer_absorbs_poison_motivation():
    t = _make_trainer(seed=3)
    chaos.arm("trainer.grads", "nan", first=1)
    t.step(*_batches(1, seed=12)[0])
    assert not all(torch.isfinite(v).all() for v in _values_of(t))


def test_guarded_step_adds_no_blocking_host_sync(monkeypatch):
    """Every telemetry read goes through ``_fetch``, only for entries whose
    copy is done, at most one a step; ``step`` never reads the loss."""
    fetches = {"n": 0}
    real_fetch = guardrails._fetch

    def counting_fetch(host):
        fetches["n"] += 1
        return real_fetch(host)

    monkeypatch.setattr(guardrails, "_fetch", counting_fetch)
    reads = {"n": 0}
    real_item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: (
        reads.__setitem__("n", reads["n"] + 1), real_item(self))[1])
    t = _make_trainer(seed=4)
    g = GuardedStep(t)
    for x, y in _batches(5, seed=13):
        g.step(x, y)
    assert reads["n"] == 0
    assert fetches["n"] <= 5
    assert all(guardrails._is_ready(e) for _, _, e in g._pending)


# ---------------------------------------------------------------------------
# dynamic loss scaling and clipping
# ---------------------------------------------------------------------------

def test_scale_update_matches_reference_loss_scaler_schedule():
    from mxnet_tpu.contrib.amp import LossScaler
    seq = [True, True, False, True, True, True, True, False, False, True]
    ref = LossScaler(init_scale=256.0, scale_factor=2.0, scale_window=3)
    scale, good = torch.tensor(256.0), torch.tensor(0)
    for ok in seq:
        scale, good = guardrails.scale_update(scale, good, torch.tensor(ok),
                                              2.0, 3)
        ref.update_scale(overflow=not ok)
        assert float(scale) == ref.loss_scale
    assert float(scale) == 64.0


def test_dynamic_scale_grows_and_halves_e2e():
    t = _make_trainer(seed=5)
    g = GuardedStep(t, dynamic_scale=True, init_scale=4.0, scale_window=2,
                    detector=False)
    for x, y in _batches(2, seed=14):
        g.step(x, y)
    g.flush()
    assert g.loss_scale == 8.0
    chaos.arm("trainer.grads", "nan", first=1)
    g.step(*_batches(1, seed=15)[0])
    g.flush()
    assert g.loss_scale == 4.0 and g.skipped_steps == 1


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_dynamic_scale_clean_steps_bitwise_equal_unguarded(optimizer):
    """Power-of-two scaling is exact in fp32: a clean dynamic-scale run
    equals the unguarded one, from 2^15 as the card's check runs it."""
    batches = _batches(4, seed=16)
    ta = _make_trainer(seed=0, optimizer=optimizer)
    for x, y in batches:
        ta.step(x, y)
    tb = _make_trainer(seed=0, optimizer=optimizer)
    g = GuardedStep(tb, dynamic_scale=True, init_scale=2.0 ** 15,
                    scale_window=1000, detector=False)
    for x, y in batches:
        g.step(x, y)
    g.flush()
    _equal(_values_of(ta), _values_of(tb))
    _equal(_states_of(ta), _states_of(tb))


def test_clip_norm_bounds_update_and_counts():
    t = _make_trainer(seed=6)
    g = GuardedStep(t, clip_norm=1e-4, detector=False)
    for x, y in _batches(3, seed=17):
        g.step(x, y)
    g.flush()
    assert g.stats()["clipped"] == 3
    assert g.telemetry()["grad_norm"] > 1e-4


def test_guarded_step_matches_reference_guarded_step():
    """The reference's GuardedStep and the port's on the same MLP, batches,
    poisoned step and dynamic scale: the scale trajectory, the skips and
    which losses are finite exactly; finite losses and the parameters at
    the training tests' tolerance. SGD: the reference advances its
    optimizer's step on a skip, the port does not, and SGD reads none."""
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jparallel
    from mxnet_tpu.resilience import chaos as jchaos
    from mxnet_tpu.resilience import guardrails as jguard
    import jax
    batches = _batches(6, seed=31)
    out = {}
    for pkg, ch, guard in ((jmx, jchaos, jguard), (tmx, chaos, guardrails)):
        if pkg is jmx:
            net = _net(jmx, 0)
            tr = jparallel.ShardedTrainer(
                net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1},
                mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
        else:
            with tmx.cpu():
                net = _net(tmx, 0)
            tr = parallel.ShardedTrainer(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1}, device="cpu")
        g = guard.GuardedStep(tr, dynamic_scale=True, init_scale=8.0,
                              scale_window=2, detector=False)
        ch.clear()
        ch.arm("trainer.grads", "nan", at=3)
        losses, scales, skips = [], [], []
        for x, y in batches:
            loss = g.step(pkg.nd.array(x), pkg.nd.array(y)) \
                if pkg is jmx else g.step(x, y)
            g.flush()
            losses.append(float(np.asarray(loss.asnumpy() if pkg is jmx
                                           else loss)))
            tel = g.telemetry()
            scales.append(tel["loss_scale"])
            skips.append(tel["skips"])
        ch.clear()
        vals = [np.asarray(v) for v in tr._values] if pkg is jmx else \
            [v.detach().numpy() for v in tr.values.values()]
        out[pkg.__name__] = (np.array(losses), scales, skips, vals)
        g.close()
    (jl, js, jk, jv), (tl, ts, tk, tv) = out["mxnet_tpu"], \
        out["mxnet_tpu_torch"]
    assert ts == js == [8.0, 16.0, 8.0, 8.0, 16.0, 16.0]
    assert tk == jk == [0, 0, 1, 1, 1, 1]
    np.testing.assert_array_equal(np.isfinite(tl), np.isfinite(jl))
    ok = np.isfinite(jl)
    np.testing.assert_allclose(tl[ok], jl[ok], rtol=1e-4, atol=1e-4)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# watchdog with a fake clock
# ---------------------------------------------------------------------------

def test_watchdog_flags_stall_then_recovery_fake_clock():
    clk = {"t": 0.0}
    stalls = []
    wd = StepWatchdog(deadline_ms=100, clock=lambda: clk["t"],
                      on_stall=lambda step, s: stalls.append((step, s)))
    ready = {"v": False}
    wd.watch(7, lambda: ready["v"])
    assert wd._scan() is None
    clk["t"] = 0.05
    assert wd._scan() is None and wd.stalls == 0
    clk["t"] = 0.2
    assert wd._scan() == "stall"
    assert wd.stalls == 1 and stalls == [(7, 0.2)]
    assert wd._scan() is None
    assert wd.stalled_active
    ready["v"] = True
    assert wd._scan() == "recovered"
    assert wd.recovered == 1 and not wd.stalled_active
    wd.close()


def test_watchdog_ok_step_never_stalls():
    clk = {"t": 0.0}
    wd = StepWatchdog(deadline_ms=100, clock=lambda: clk["t"])
    wd.watch(1, lambda: True)
    assert wd._scan() == "ok"
    clk["t"] = 99.0
    assert wd._scan() is None and wd.stalls == 0
    wd.close()


def test_watchdog_rejects_disabled_deadline():
    with pytest.raises(ValueError):
        StepWatchdog(deadline_ms=0)


def test_watchdog_rearms_after_close():
    clk = {"t": 0.0}
    wd = StepWatchdog(deadline_ms=10, clock=lambda: clk["t"])
    wd.watch(1, lambda: True)
    assert wd._scan() == "ok"
    wd.close()
    wd.watch(2, lambda: False)
    assert not wd._stop.is_set()
    clk["t"] = 1.0
    assert wd._scan() == "stall" and wd.stalls == 1
    wd.close()


def test_guarded_step_health_degrades_on_stall_and_storm():
    from mxnet_tpu_torch.serving import ModelServer
    clk = {"t": 0.0}
    wd = StepWatchdog(deadline_ms=10, clock=lambda: clk["t"],
                      name="health_probe")
    t = _make_trainer(seed=7)
    g = GuardedStep(t, watchdog=wd, name="health_probe")
    assert g.health()["status"] == "ok"
    wd.watch(1, lambda: False)
    clk["t"] = 1.0
    wd._scan()
    h = g.health()
    assert h["status"] == "degraded" and any("watchdog" in r
                                             for r in h["reasons"])
    assert guardrails.health()["status"] == "degraded"
    srv = ModelServer.__new__(ModelServer)   # no socket: health() only
    srv._draining = False
    srv.breaker = None
    assert srv.health()["status"] == "degraded"
    assert "guardrails" in srv.health()
    wd.close()
    g._watchdog = None
    g._detector.storm_active = True
    assert "nan_storm" in g.health()["reasons"]
    g._detector.storm_active = False
    assert guardrails.health()["status"] == "ok"
    g.close()


# ---------------------------------------------------------------------------
# anomaly detection and restore-and-replay
# ---------------------------------------------------------------------------

def test_anomaly_detector_storm_and_spike_and_reset():
    det = AnomalyDetector(window=16, spike_factor=5.0, min_history=4,
                          storm_window=6, storm_skips=3)
    for i in range(6):
        assert det.feed(1.0 + 0.01 * i, 0.5, 1.0, 0, True) is None
    assert det.feed(50.0, 0.5, 1.0, 0, True) == "spike"
    assert det.spikes == 1 and not det.storm_active
    assert det.feed(float("nan"), float("nan"), 1.0, 1, False) is None
    assert det.feed(float("nan"), float("nan"), 1.0, 2, False) is None
    assert det.feed(float("nan"), float("nan"), 1.0, 3, False) == "storm"
    assert det.storms == 1 and det.storm_active
    det.reset()
    assert not det.storm_active
    assert det.feed(float("nan"), 0.0, 1.0, 4, False) is None


def test_anomaly_detector_storm_unlatches_when_window_clears():
    det = AnomalyDetector(storm_window=4, storm_skips=2, min_history=99)
    det.feed(float("nan"), 0.0, 1.0, 1, False)
    det.feed(float("nan"), 0.0, 1.0, 2, False)
    assert det.storm_active
    det.feed(1.0, 0.1, 1.0, 2, True)
    assert det.storm_active
    det.feed(1.0, 0.1, 1.0, 2, True)
    det.feed(1.0, 0.1, 1.0, 2, True)
    assert not det.storm_active and det.storms == 1


def test_restore_resets_detector_window():
    t = _make_trainer(seed=11)
    g = GuardedStep(t, detector=AnomalyDetector(storm_window=8,
                                                storm_skips=4))
    g._detector.feed(float("nan"), 0.0, 1.0, 1, False)
    g._detector.feed(float("nan"), 0.0, 1.0, 2, False)
    g._restore_extra({k: v.item() for k, v in
                      g._checkpoint_extra().items()})
    assert sum(g._detector._recent_skips) == 0
    assert not g._detector.storm_active


@pytest.mark.chaos
def test_step_many_fires_trainer_grads_point():
    t = _make_trainer(seed=12)
    chaos.arm("trainer.grads", "nan", first=1)
    rng = np.random.RandomState(24)
    xs = rng.rand(2, 8, 8).astype("float32")
    ys = rng.randint(0, 4, (2, 8)).astype("float32")
    t.step_many(xs, ys)
    assert chaos.stats()["trainer.grads"]["fires"] == 1
    assert not all(torch.isfinite(v).all() for v in _values_of(t))


@pytest.mark.chaos
def test_nan_storm_raises_anomaly_fault():
    chaos.arm("trainer.grads", "nan", every=1)
    t = _make_trainer(seed=8)
    g = GuardedStep(t, detector=AnomalyDetector(storm_window=4,
                                                storm_skips=2))
    with pytest.raises(AnomalyFault, match="NaN storm"):
        for x, y in _batches(4, seed=18):
            g.step(x, y)


@pytest.mark.chaos
def test_resumable_fit_recovers_from_nan_storm_e2e(tmp_path):
    chaos.arm("trainer.grads", "nan", first=3)
    t = _make_trainer(seed=0)
    g = GuardedStep(t, detector=AnomalyDetector(storm_window=6,
                                                storm_skips=3))
    before = resume_mod.resume_stats()
    losses = resumable_fit(g, _batches(8, seed=19), str(tmp_path / "s"),
                           ckpt_every=5, seed=123)
    after = resume_mod.resume_stats()
    assert after["restores"] >= before["restores"] + 1
    assert g._t == 8
    assert all(l is not None and np.isfinite(l) for l in losses)
    assert all(torch.isfinite(v).all() for v in _values_of(t))


def test_close_unregisters_and_clears_stall():
    clk = {"t": 0.0}
    wd = StepWatchdog(deadline_ms=10, clock=lambda: clk["t"],
                      name="close_probe")
    t = _make_trainer(seed=13)
    g = GuardedStep(t, watchdog=wd, name="close_probe")
    wd.watch(1, lambda: False)
    clk["t"] = 1.0
    wd._scan()
    assert guardrails.health()["status"] == "degraded"
    g.close()
    assert not wd.stalled_active
    assert guardrails.health()["status"] == "ok"
    assert "close_probe" not in guardrails.all_stats()


def test_checkpoint_restores_across_wrapper_change(tmp_path):
    """A bare trainer's checkpoint restores into a GuardedStep (the scale
    stays, the optimizer's step becomes the restored one), and a guarded
    checkpoint into a bare trainer (the guard's state left out)."""
    t = _make_trainer(seed=14)
    t.step(*_batches(1, seed=25)[0])
    parallel.save_checkpoint(t, str(tmp_path / "plain"))
    g = GuardedStep(_make_trainer(seed=15), dynamic_scale=True,
                    init_scale=32.0, detector=False)
    parallel.restore_checkpoint(g, str(tmp_path / "plain"))
    assert g._t == 1 and g.loss_scale == 32.0 and int(g.opt_step) == 1
    _equal(_values_of(t), _values_of(g.trainer))
    g.step(*_batches(1, seed=26)[0])
    g.flush()
    assert g.skipped_steps == 0
    g2 = GuardedStep(_make_trainer(seed=16), detector=False)
    g2.step(*_batches(1, seed=27)[0])
    parallel.save_checkpoint(g2, str(tmp_path / "guarded"))
    t2 = _make_trainer(seed=17)
    parallel.restore_checkpoint(t2, str(tmp_path / "guarded"))
    assert t2._t == 1
    _equal(_values_of(g2.trainer), _values_of(t2))


def test_checkpoint_roundtrips_guard_state(tmp_path):
    t = _make_trainer(seed=9)
    g = GuardedStep(t, dynamic_scale=True, init_scale=8.0, scale_window=3,
                    detector=False)
    for x, y in _batches(2, seed=20):
        g.step(x, y)
    g.flush()
    parallel.save_checkpoint(g, str(tmp_path / "ck"))
    scale_saved = g.loss_scale
    for x, y in _batches(2, seed=21):
        g.step(x, y)
    g.flush()
    assert g.loss_scale != scale_saved
    parallel.restore_checkpoint(g, str(tmp_path / "ck"))
    assert g._t == 2 and g.loss_scale == scale_saved
    assert int(g.opt_step) == 2
    g.step(*_batches(1, seed=22)[0])
    g.flush()
    assert g.skipped_steps == 0


# ---------------------------------------------------------------------------
# chaos "nan" kind and the counters
# ---------------------------------------------------------------------------

def test_chaos_nan_kind_grammar_and_counters():
    rules = chaos.arm_from_env("trainer.grads:nan:every=2")
    assert len(rules) == 1 and rules[0].kind == "nan"
    assert [chaos.poisoned("trainer.grads") for _ in range(4)] == \
        [False, True, False, True]
    st = chaos.stats()["trainer.grads"]
    assert st["calls"] == 4 and st["fires"] == 2


def test_chaos_nan_never_raises_and_point_returns_marker():
    chaos.arm("p.nan", "nan", first=1)
    assert chaos.point("p.nan") == "nan"
    assert chaos.point("p.nan") is None


def test_poison_nonfinite_floats_and_int_fallback():
    xs, y = guardrails.poison_nonfinite(
        (torch.ones((2, 2)), torch.ones((2,), dtype=torch.int32)),
        torch.ones((2,)))
    assert torch.isnan(xs[0]).all()
    assert xs[1].dtype == torch.int32
    assert not torch.isnan(y).any()
    xs2, y2 = guardrails.poison_nonfinite(
        (np.ones(2, np.int32),), np.ones((2,)))
    assert torch.isnan(y2).all()


def test_guardrails_counters_reach_aggregate_rows():
    from mxnet_tpu_torch.resilience import aggregate_rows
    t = _make_trainer(seed=10)
    g = GuardedStep(t, name="agg_probe_guard", detector=False)
    chaos.arm("trainer.grads", "nan", first=1)
    for x, y in _batches(2, seed=23):
        g.step(x, y)
    g.flush()
    rows = aggregate_rows()
    assert rows["resilience.guardrails.agg_probe_guard.steps"][0] == 2
    assert rows["resilience.guardrails.agg_probe_guard.skips"][0] == 1
    g.close()


def test_poisoned_token_stream_step_is_skipped():
    """A TransformerLM's inputs are integer tokens, so the poison lands on
    the float labels: the loss is NaN (no out-of-range class read), the
    step is skipped bitwise and the scale halves, as the card's check runs
    it at full width."""
    from mxnet_tpu_torch.models import TransformerLM
    torch.manual_seed(0)
    net = TransformerLM(50, units=16, num_layers=1, num_heads=2, max_len=8,
                        device="cpu")
    tr = parallel.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adam", {"learning_rate": 1e-3},
                                 device="cpu")
    g = GuardedStep(tr, dynamic_scale=True, init_scale=2.0 ** 15,
                    detector=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 50, (4, 8)))
    y = torch.cat([x[:, 1:], torch.full((4, 1), -1)], 1).float()
    g.step(x, y)
    g.flush()
    before = _values_of(tr), _states_of(tr)
    chaos.arm("trainer.grads", "nan", first=1)
    assert torch.isnan(g.step(x, y))
    g.flush()
    assert g.skipped_steps == 1 and g.loss_scale == 2.0 ** 14
    _equal(before[0], _values_of(tr))
    _equal(before[1], _states_of(tr))
