"""The port's optimizers against the JAX package's.

- Every pure update rule, fed the same numpy weight, states and
  gradients, for 3 steps: the weight and every state at atol/rtol 1e-6
  (fp32; the same arithmetic, op for op; the reference takes its scalar
  hyper-parameters in float32, the port in double, which moves the last
  bits). ``_sgld`` is fed the reference's own noise (its threefry draw);
  ``_sgd_rowwise`` gets unique rows.
- Every registered class through ``create``, under an ``Updater``, with a
  ``param_dict`` of ``lr_mult``/``wd_mult``, an ``lr_scheduler`` and
  ``clip_gradient``, for 3 steps over two weights, at 1e-6 (SGLD's noise
  comes from another generator, so SGLD is held to a repeat under one
  seed instead).
- ``multi_precision`` on bf16 weights (Adam and LAMB): the fp32 master at
  1e-6 and the bf16 weights equal.
- An ``Updater`` ``get_states``/``set_states`` round trip: the restored
  updater continues bit for bit.
- ``set_wd_mult``'s exemptions, the scheduler's update count, the sparse
  ``SGD`` path.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt_pkg
from mxnet_tpu.optimizer import optimizer as jopt
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt_pkg
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.optimizer import optimizer as topt

torch.set_num_threads(1)

TOL = 1e-6
SHAPE = (5, 7)
LR, WD, RESCALE, CLIP = 0.01, 1e-3, 0.5, 0.8


def _nadam_scalars(t, b1=0.9, decay=0.004):
    mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * decay))
    mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * decay))
    return mu_t, mu_t1


def _hyper(rule, t, m_schedule):
    """The hyper-parameters after the gradient, in the reference's order."""
    if rule == "nadam":
        mu_t, mu_t1 = _nadam_scalars(t)
        return (LR, WD, 0.9, 0.999, 1e-8, m_schedule * mu_t,
                m_schedule * mu_t * mu_t1, mu_t, mu_t1, RESCALE, CLIP, t)
    return {
        "sgd": (LR, WD, RESCALE, CLIP),
        "sgd_mom": (LR, WD, 0.9, RESCALE, CLIP),
        "nag_mom": (LR, WD, 0.9, RESCALE, CLIP),
        "adam": (LR, WD, 0.9, 0.999, 1e-8, RESCALE, CLIP, t),
        "adagrad": (LR, WD, 1e-7, RESCALE, CLIP),
        "rmsprop": (LR, WD, 0.9, 1e-8, RESCALE, CLIP),
        "rmsprop_alex": (LR, WD, 0.9, 0.9, 1e-8, RESCALE, CLIP),
        "adadelta": (WD, 0.9, 1e-5, RESCALE, CLIP),
        "adamax": (LR, WD, 0.9, 0.999, RESCALE, CLIP, t),
        "ftrl": (LR, WD, 0.01, 1.0, RESCALE, CLIP),
        "signum": (LR, WD, 0.9, 0.01, RESCALE, CLIP),
        "signsgd": (LR, WD, RESCALE, CLIP),
        "ftml": (LR, WD, 0.6, 0.999, 1e-8, RESCALE, CLIP, t),
        "lars": (LR, WD, 0.9, 0.001, 0.0, RESCALE, CLIP),
        "lamb": (LR, WD, 0.9, 0.999, 1e-6, t, 0.0, float("inf"), 1.0,
                 RESCALE, CLIP),
        "lamb_bounded": (LR, WD, 0.9, 0.999, 1e-6, t, 0.5, 2.0, 0.0,
                         RESCALE, CLIP),
        "dcasgd": (LR, WD, 0.9, 0.04, RESCALE, CLIP),
    }[rule]


N_STATES = {"sgd": 0, "sgd_mom": 1, "nag_mom": 1, "adam": 2, "adagrad": 1,
            "rmsprop": 1, "rmsprop_alex": 3, "adadelta": 2, "adamax": 2,
            "nadam": 2, "ftrl": 2, "signum": 1, "signsgd": 0, "ftml": 3,
            "lars": 1, "lamb": 2, "lamb_bounded": 2, "dcasgd": 2}


def _fn(mod, rule):
    return getattr(mod, "_" + ("lamb" if rule == "lamb_bounded" else rule))


@pytest.mark.parametrize("rule", sorted(N_STATES) + ["sgd_rowwise",
                                                     "sgld"])
def test_rule_matches_reference(rule):
    rng = np.random.default_rng(sorted(N_STATES).index(rule)
                                if rule in N_STATES else 40)
    w = rng.standard_normal(SHAPE).astype("float32")
    states = [np.zeros(SHAPE, "float32")
              for _ in range(N_STATES.get(rule, 0))]
    if rule == "dcasgd":
        states[0] = w.copy()                       # the previous weight
    own = [torch.from_numpy(a.copy()) for a in [w] + states]
    ref = [w] + states
    key = jax.random.PRNGKey(3)
    m_schedule = 1.0
    for t in (1, 2, 3):
        g = (2 * rng.standard_normal(SHAPE)).astype("float32")
        if rule == "sgd_rowwise":
            idx = np.array([4, 0, 2])
            ref = [np.asarray(jopt._sgd_rowwise(
                jnp.asarray(ref[0]), jnp.asarray(g[:3]), jnp.asarray(idx),
                LR, WD, RESCALE, CLIP))]
            topt._sgd_rowwise(own[0], torch.from_numpy(g[:3]),
                              torch.from_numpy(idx), LR, WD, RESCALE, CLIP)
        elif rule == "sgld":
            _, sub = jax.random.split(key)
            noise = np.asarray(jax.random.normal(sub, SHAPE, jnp.float32))
            out = jopt._sgld(jnp.asarray(ref[0]), key, jnp.asarray(g), LR,
                             WD, RESCALE, CLIP)
            ref, key = [np.asarray(out[0])], out[1]
            topt._sgld(own[0], None, torch.from_numpy(g), LR, WD, RESCALE,
                       CLIP, noise=torch.from_numpy(noise.copy()))
        else:
            hyper = _hyper(rule, t, m_schedule)
            if rule == "nadam":
                m_schedule = hyper[5]
            out = _fn(jopt, rule)(*[jnp.asarray(a) for a in ref],
                                  jnp.asarray(g), *hyper)
            ref = [np.asarray(a) for a in
                   (out if isinstance(out, tuple) else (out,))]
            res = _fn(topt, rule)(*own, torch.from_numpy(g), *hyper)
            res = res if isinstance(res, tuple) else (res,)
            assert all(r is o for r, o in zip(res, own))   # in place
        for i, (o, r) in enumerate(zip(own, ref)):
            np.testing.assert_allclose(o.numpy(), r, atol=TOL, rtol=TOL,
                                       err_msg="%s step %d out %d"
                                       % (rule, t, i))


def test_sgld_draws_from_its_generator_state():
    w, g = torch.zeros(SHAPE), torch.zeros(SHAPE)
    gen = torch.Generator().manual_seed(5)
    key = gen.get_state()
    topt._sgld(w, key, g, 4.0, 0.0, 1.0, float("inf"))
    want = 2.0 * torch.randn(SHAPE, generator=torch.Generator()
                             .manual_seed(5))
    assert torch.equal(w, want)
    assert not torch.equal(key, torch.Generator().manual_seed(5)
                           .get_state())       # the state moved on


CLASSES = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("ccsgd", {"momentum": 0.5}),
    ("lbsgd", {"momentum": 0.9}), ("signum", {}),
    ("signum", {"momentum": 0.0}), ("ftml", {}),
    ("lars", {"momentum": 0.9, "lars_eta": 0.01}), ("dcasgd",
                                                   {"momentum": 0.9}),
    ("nag", {}), ("nag", {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
    ("rmsprop", {}), ("rmsprop", {"centered": True, "clip_weights": 0.9}),
    ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
    ("lamb", {}), ("lamb", {"lower_bound": 0.5, "upper_bound": 3.0,
                            "bias_correction": False}),
    ("adamw", {}), ("test", {})]


def _mults():
    return {0: types.SimpleNamespace(lr_mult=1.0, wd_mult=1.0),
            1: types.SimpleNamespace(lr_mult=0.5, wd_mult=0.0)}


def _weights(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype("float32") for _ in range(n)]


@pytest.mark.parametrize("name,kwargs", CLASSES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CLASSES)])
def test_class_matches_reference(name, kwargs):
    common = dict(learning_rate=0.05, wd=0.01, clip_gradient=1.5,
                  rescale_grad=0.5, param_dict=_mults())
    ref_opt = jopt_pkg.create(name, lr_scheduler=jsched.FactorScheduler(
        step=1, factor=0.7), **common, **kwargs)
    own_opt = topt_pkg.create(name, lr_scheduler=tsched.FactorScheduler(
        step=1, factor=0.7), **common, **kwargs)
    assert type(own_opt).__name__ == type(ref_opt).__name__
    ref_upd, own_upd = jopt_pkg.get_updater(ref_opt), \
        topt_pkg.get_updater(own_opt)
    ws = _weights(1)
    ref_w = [nd.array(w) for w in ws]
    own_w = [torch.from_numpy(w.copy()) for w in ws]
    for step in range(3):
        for i, g in enumerate(_weights(10 + step)):
            g = 3 * g
            ref_upd(i, nd.array(g), ref_w[i])
            own_upd(i, torch.from_numpy(g), own_w[i])
        assert own_opt.num_update == ref_opt.num_update
        assert own_opt.learning_rate == ref_opt.learning_rate
        for i in range(2):
            np.testing.assert_allclose(own_w[i].numpy(), ref_w[i].asnumpy(),
                                       atol=TOL, rtol=TOL,
                                       err_msg="%s step %d weight %d"
                                       % (name, step, i))


def test_sgld_class_repeats_under_one_seed():
    runs = []
    for _ in range(2):
        trandom.seed(4)
        upd = topt_pkg.get_updater(topt_pkg.create("sgld",
                                                   learning_rate=0.1))
        w = torch.from_numpy(_weights(1, 1)[0])
        for step in range(3):
            upd(0, torch.ones(SHAPE), w)
        runs.append(w)
    assert torch.equal(runs[0], runs[1])
    assert bool(torch.isfinite(runs[0]).all())


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_multi_precision_bf16(name):
    ref_opt = jopt_pkg.create(name, learning_rate=0.05, wd=0.01,
                              multi_precision=True)
    own_opt = topt_pkg.create(name, learning_rate=0.05, wd=0.01,
                              multi_precision=True)
    ref_upd, own_upd = jopt_pkg.get_updater(ref_opt), \
        topt_pkg.get_updater(own_opt)
    w = _weights(2, 1)[0]
    ref_w = nd.array(w).astype("bfloat16")
    own_w = torch.from_numpy(w).bfloat16()
    for step in range(3):
        g = _weights(20 + step, 1)[0]
        ref_upd(0, nd.array(g).astype("bfloat16"), ref_w)
        own_upd(0, torch.from_numpy(g).bfloat16(), own_w)
        assert own_w.dtype == torch.bfloat16
        ref_master = ref_upd.states[0][0].asnumpy()
        own_master = own_upd.states[0][0]
        assert own_master.dtype == torch.float32
        np.testing.assert_allclose(own_master.numpy(), ref_master, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(
            own_w.float().numpy(), ref_w.astype("float32").asnumpy())


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "nadam"])
def test_updater_state_round_trip(name):
    kwargs = {"momentum": 0.9} if name == "sgd" else {}

    def fresh():
        return topt_pkg.get_updater(topt_pkg.create(
            name, learning_rate=0.05, lr_scheduler=tsched.PolyScheduler(
                max_update=10, base_lr=0.05), **kwargs))

    grads = [torch.from_numpy(g) for g in _weights(30, 5)]
    a, b = fresh(), fresh()
    wa = torch.from_numpy(_weights(3, 1)[0])
    wb = wa.clone()
    for g in grads[:2]:
        a(0, g, wa)
        b(0, g, wb)
    blob = b.get_states(dump_optimizer=True)
    c = topt_pkg.get_updater(topt_pkg.create("sgd"))
    c.set_states(blob)
    assert type(c.optimizer).__name__ == type(a.optimizer).__name__
    assert c.optimizer.num_update == 2
    for g in grads[2:]:
        a(0, g, wa)
        c(0, g, wb)
    assert torch.equal(wa, wb)
    states_only = fresh()
    states_only.set_states(a.get_states())
    assert sorted(states_only.states) == [0]


def test_wd_mult_exemptions_and_lr_lookup_match_reference():
    names = {0: "fc_weight", 1: "fc_bias", 2: "ln_gamma", 3: "ln_beta"}
    ref = jopt_pkg.create("sgd", param_idx2name=names, wd=0.1)
    own = topt_pkg.create("sgd", param_idx2name=names, wd=0.1)
    for o in (ref, own):
        o.set_wd_mult({"ln_gamma": 0.5})
        o.set_lr_mult({"fc_bias": 2.0})
    assert own.wd_mult == ref.wd_mult
    assert own._get_wds([0, 1, 2, 3]) == ref._get_wds([0, 1, 2, 3])
    assert own._get_lrs([0, 1, 2, 3]) == ref._get_lrs([0, 1, 2, 3])
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        topt_pkg.create("nope")
    with pytest.raises(UserWarning):
        topt_pkg.create("sgd", lr_scheduler=tsched.FactorScheduler(
            2)).set_learning_rate(0.1)


def test_scheduler_sees_one_on_the_first_update():
    seen = []

    class Spy(tsched.LRScheduler):
        def __call__(self, num_update):
            seen.append(num_update)
            return 0.1

    upd = topt_pkg.get_updater(topt_pkg.create("sgd", lr_scheduler=Spy()))
    w = torch.zeros(3)
    for _ in range(2):
        upd(0, torch.ones(3), w)
        upd(1, torch.ones(3), w)
    assert seen == [1, 1, 2, 2]


def test_sgd_sparse_gradient_updates_its_rows_only():
    w = torch.from_numpy(_weights(5, 1)[0])
    dense = w.clone()
    idx = torch.tensor([3, 1])
    vals = torch.ones(2, SHAPE[1])
    grad = torch.sparse_coo_tensor(idx[None], vals, SHAPE,
                                   check_invariants=True)
    topt_pkg.create("sgd", learning_rate=0.1, wd=0.01).update(0, w, grad,
                                                              None)
    topt._sgd_rowwise(dense, vals, idx, 0.1, 0.01, 1.0, float("inf"))
    assert torch.equal(w, dense)
    assert torch.equal(w[0], torch.from_numpy(_weights(5, 1)[0])[0])
