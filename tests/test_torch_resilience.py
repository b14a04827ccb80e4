"""The port's copies of the resilience modules and the tracer, against the
JAX package's.

A few of ``tests/test_resilience.py``'s chaos, retry and breaker scenarios
(fake clocks, no real sleeps), each one test parametrised over both
packages, so the copies are held to the same behaviour as the originals.
"""
import pytest

from mxnet_tpu import resilience as jax_resilience
from mxnet_tpu.observability import tracer as jax_tracer
from mxnet_tpu_torch import resilience as torch_resilience
from mxnet_tpu_torch.observability import tracer as torch_tracer

PACKAGES = {"jax": (jax_resilience, jax_tracer),
            "torch": (torch_resilience, torch_tracer)}


@pytest.fixture(params=sorted(PACKAGES))
def res(request):
    """One package's resilience module, with chaos disarmed around the
    test (its state is process-global)."""
    mod = PACKAGES[request.param][0]
    mod.chaos.clear()
    yield mod
    mod.chaos.clear()


def _fires(res, point, n):
    out = []
    for _ in range(n):
        try:
            res.chaos.point(point)
            out.append(None)
        except res.Fault as e:
            out.append(type(e).__name__)
    return out


def test_chaos_triggers(res):
    res.chaos.arm("p.first", "transient", first=2)
    assert _fires(res, "p.first", 4) == ["TransientFault"] * 2 + [None] * 2
    res.chaos.arm("p.every", "transient", every=3)
    assert _fires(res, "p.every", 6) == [None, None, "TransientFault"] * 2
    res.chaos.arm("p.at", "fatal", at=2)
    assert _fires(res, "p.at", 3) == [None, "FatalFault", None]
    st = res.chaos.stats()
    assert st["p.first"] == {"calls": 4, "fires": 2}
    res.chaos.point("never.armed")
    assert "never.armed" not in res.chaos.stats()
    with pytest.raises(ValueError, match="never fires"):
        res.chaos.arm("p.dead", "transient", first=0)


def test_chaos_env_spec_grammar(res):
    rules = res.chaos.arm_from_env(
        "generation.step:transient:first=2;"
        "x.fatal:fatal:at=5;"
        "x.slow:slow(15):every=4;"
        "x.coin:transient:p=0.25,seed=3")
    assert [r.kind for r in rules] == ["transient", "fatal", "slow",
                                       "transient"]
    assert rules[2].delay_ms == 15.0
    assert rules[3].p == 0.25 and rules[3].seed == 3
    assert _fires(res, "generation.step", 3) == ["TransientFault"] * 2 + \
        [None]
    with pytest.raises(ValueError, match="MXNET_CHAOS_SPEC"):
        res.chaos.arm_from_env("generation.step:explode")


def test_retry_schedule_stats_and_giveup(res):
    sleeps = []
    pol = res.RetryPolicy(max_attempts=5, base_delay_ms=10, multiplier=2,
                          jitter=0.25, seed=11, sleep=sleeps.append,
                          name="t", register=False)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise res.TransientFault("boom %d" % calls["n"])
        return "ok"

    assert pol.call(flaky) == "ok"
    assert [s * 1e3 for s in sleeps] == pytest.approx(pol.schedule()[:3])
    st = pol.stats()
    assert (st["attempts"], st["retries"], st["successes"]) == (4, 3, 1)
    always = res.RetryPolicy(max_attempts=3, sleep=lambda s: None,
                             name="t2", register=False)

    def down():
        raise res.TransientFault("persistent")

    with pytest.raises(res.RetryExhausted) as ei:
        always.call(down)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.__cause__, res.TransientFault)
    with pytest.raises(ValueError):
        always.call(lambda: (_ for _ in ()).throw(ValueError("not mine")))


def test_retry_deadline_fake_clock(res):
    clk = {"t": 0.0}

    def sleep(s):
        clk["t"] += s

    pol = res.RetryPolicy(max_attempts=10, base_delay_ms=100, multiplier=1,
                          jitter=0, deadline_ms=150, sleep=sleep,
                          clock=lambda: clk["t"], name="t3", register=False)
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise res.TransientFault("x")

    with pytest.raises(res.RetryExhausted):
        pol.call(always)
    assert calls["n"] == 2


def _breaker(res, **kw):
    clk = {"t": 0.0}
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("recovery_ms", 1000)
    return res.CircuitBreaker(clock=lambda: clk["t"], register=False,
                              **kw), clk


def test_breaker_open_half_open_close(res):
    b, clk = _breaker(res)
    for _ in range(2):
        b.record_failure()
    b.record_success()
    for _ in range(3):
        b.record_failure()
    assert b.state == "open" and not b.allow()
    assert b.snapshot()["fast_fails"] == 1
    assert 0.0 < b.retry_after_s() <= 1.0
    clk["t"] = 1.2
    assert b.state == "half_open"
    probe = b.allow()
    assert probe and not b.allow()    # one probe slot
    b.record_success(probe)
    assert b.state == "closed"
    with pytest.raises(RuntimeError, match="boom"):
        b.call(lambda: (_ for _ in ()).throw(RuntimeError("boom")))


def test_breaker_stale_admission_cannot_decide_half_open(res):
    b, clk = _breaker(res, failure_threshold=1, half_open_probes=1)
    stale = b.allow()
    assert stale and not stale.probe
    b.record_failure()
    clk["t"] = 1.2
    probe = b.allow()
    assert probe and probe.probe
    b.record_success(stale)
    assert b.state == "half_open"
    b.release(stale)
    assert not b.allow()
    b.record_failure(stale)
    assert b.state == "half_open"
    b.record_success(probe)
    assert b.state == "closed"


def test_breaker_error_rate_trip_and_call_wrapper(res):
    b, _ = _breaker(res, failure_threshold=100, error_rate_threshold=0.5,
                    window=8)
    for i in range(8):
        (b.record_failure if i % 2 else b.record_success)()
    assert b.state == "open"
    with pytest.raises(res.CircuitOpen) as ei:
        b.call(lambda: 1)
    assert ei.value.retry_after_s > 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tracer_spans_link_across_threads(pkg):
    tr = PACKAGES[pkg][1].Tracer(capacity=16)
    tr.enable()
    with tr.span("generation.step", slots=2) as outer:
        with tr.span("generation.spec_verify"):
            pass
        ctx = outer.ctx
    with tr.attach(ctx):
        with tr.span("generation.prefix_hit", tokens=8):
            pass
    # records: (ph, name, ts, dur, tid, tname, span_id, parent_id,
    # trace_id, args)
    evs = [e for e in tr.events() if e[0] == "X"]
    assert [e[1] for e in evs] == ["generation.spec_verify",
                                   "generation.step",
                                   "generation.prefix_hit"]
    inner, outer_ev, attached = evs
    assert inner[7] == outer_ev[6] and attached[7] == outer_ev[6]
    assert {e[8] for e in evs} == {outer_ev[8]}
    assert attached[9] == {"tokens": 8}
    assert tr.phase_stats()["generation.step"]["count"] == 1
