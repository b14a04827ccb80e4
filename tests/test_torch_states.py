"""``.states`` files move between the packages (ROADMAP item 5b).

Each case trains two steps in the writer package, saves the optimizer
states (``gluon.Trainer.save_states`` or ``Module.save_optimizer_states``)
and the parameters, and builds a fresh trainer (or module) in the reader
package from those parameters that loads the states and takes a third
step. The writer package does the same from its own files. The two third
updates must agree within 1e-6 of each weight's largest |value|; for
``gluon.Trainer``, whose file holds the optimizer and its update counts,
the writer's resumed step must also equal its uninterrupted one.

Gradients are exact in every dtype (small integer inputs and heads), so
the steps differ only by what the files carry. The rules: SGD with
momentum, Adam, LAMB, RMSProp (tensor and tuple states), and
``multi_precision`` Adam on bf16 weights (a float32 master copy beside
each state); a per-parameter ``lr_mult`` and ``wd_mult`` travel
too. A file in the port's own format of earlier releases (a pickle of
torch tensors) still loads.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-6
RULES = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 0.01}),
    "adam": ("adam", {"learning_rate": 0.05, "wd": 0.01}),
    "lamb": ("lamb", {"learning_rate": 0.05, "wd": 0.01}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "centered": True}),
}
RNG = np.random.default_rng(0)
W0 = RNG.standard_normal((3, 4)).astype("float32")
B0 = RNG.standard_normal(3).astype("float32")
XS = [RNG.integers(-1, 3, (4, 4)).astype("float32") for _ in range(3)]
HS = [RNG.integers(-1, 2, (4, 3)).astype("float32") for _ in range(3)]


def _pkg(name):
    return jmx if name == "ref" else tmx


# ---- gluon.Trainer ----------------------------------------------------------


def _net(mx, dtype, params=None):
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=mx.cpu())
        if params is not None:
            net.load_parameters(params, ctx=mx.cpu())
        else:
            net.weight.set_data(mx.nd.array(W0))
            net.bias.set_data(mx.nd.array(B0))
        net.bias.lr_mult, net.bias.wd_mult = 0.5, 0.0
        if dtype != "float32":
            net.cast(dtype)
    return net


def _trainer(mx, net, rule, mp):
    name, kw = RULES[rule]
    return mx.gluon.Trainer(net.collect_params(), name,
                            dict(kw, multi_precision=mp))


def _step(mx, net, trainer, i, dtype):
    with mx.cpu():
        x = mx.nd.array(XS[i]).astype(dtype)
        h = mx.nd.array(HS[i]).astype(dtype)
        with mx.autograd.record():
            loss = (net(x) * h).sum()
        loss.backward()
        trainer.step(4)


def _weights(net):
    return [p.data().asnumpy().astype("float32")
            for p in net.collect_params().values()]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30)


def _trainer_third_step(mx, rule, dtype, params, states):
    net = _net(mx, dtype, params)
    tr = _trainer(mx, net, rule, dtype != "float32")
    tr.load_states(states)
    _step(mx, net, tr, 2, dtype)
    return _weights(net)


TRAINER_CASES = [(r, "float32") for r in RULES] + [("adam", "bfloat16")]


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("rule,dtype", TRAINER_CASES,
                         ids=["%s-%s" % c for c in TRAINER_CASES])
def test_trainer_states_cross_packages(rule, dtype, writer, tmp_path):
    reader = "port" if writer == "ref" else "ref"
    mx = _pkg(writer)
    net = _net(mx, dtype)
    tr = _trainer(mx, net, rule, dtype != "float32")
    for i in range(2):
        _step(mx, net, tr, i, dtype)
    params, states = str(tmp_path / "w.params"), str(tmp_path / "w.states")
    net.save_parameters(params)
    tr.save_states(states)
    _step(mx, net, tr, 2, dtype)
    uninterrupted = _weights(net)
    own = _trainer_third_step(mx, rule, dtype, params, states)
    _close(own, uninterrupted)
    other = _trainer_third_step(_pkg(reader), rule, dtype, params, states)
    _close(other, own)


# ---- Module -----------------------------------------------------------------


def _module(mx, rule, arg_params=None):
    sym = mx.sym
    fc = sym.FullyConnected(sym.var("data"), num_hidden=3, name="fc")
    loss = sym.MakeLoss(sym.sum(fc * sym.var("label")))
    mod = mx.mod.Module(loss, data_names=("data",), label_names=("label",),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 4))], label_shapes=[("label", (4, 3))])
    if arg_params is None:
        arg_params = {"fc_weight": mx.nd.array(W0), "fc_bias": mx.nd.array(B0)}
    mod.init_params(arg_params=arg_params, aux_params={})
    name, kw = RULES[rule]
    mod.init_optimizer(optimizer=name, optimizer_params=kw)
    return mod


def _mod_step(mx, mod, i):
    with mx.cpu():
        batch = mx.io.DataBatch(data=[mx.nd.array(XS[i])],
                                label=[mx.nd.array(HS[i])])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()


def _mod_weights(mod):
    args, _ = mod.get_params()
    return [args[k].asnumpy() for k in ("fc_weight", "fc_bias")]


def _module_third_step(mx, rule, weights, states):
    with mx.cpu():
        mod = _module(mx, rule, {"fc_weight": mx.nd.array(weights[0]),
                                 "fc_bias": mx.nd.array(weights[1])})
    mod.load_optimizer_states(states)
    _mod_step(mx, mod, 2)
    return _mod_weights(mod)


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("rule", ["adam", "lamb", "sgd_momentum"])
def test_module_states_cross_packages(rule, writer, tmp_path):
    reader = "port" if writer == "ref" else "ref"
    mx = _pkg(writer)
    with mx.cpu():
        mod = _module(mx, rule)
    for i in range(2):
        _mod_step(mx, mod, i)
    states = str(tmp_path / "m.states")
    mod.save_optimizer_states(states)
    weights = _mod_weights(mod)
    own = _module_third_step(mx, rule, weights, states)
    other = _module_third_step(_pkg(reader), rule, weights, states)
    _close(other, own)


def test_a_torch_pickle_of_earlier_releases_still_loads(tmp_path):
    """The port's files before the shared format: ``pickle.dumps`` of
    ``(states, optimizer)`` with torch tensors."""
    import torch
    net = _net(tmx, "float32")
    tr = _trainer(tmx, net, "adam", False)
    _step(tmx, net, tr, 0, "float32")
    upd = tr._updaters[0]
    old = pickle.dumps((upd.states, upd.optimizer))
    path = tmp_path / "old.states"
    path.write_bytes(old)
    _step(tmx, net, tr, 1, "float32")
    want = _weights(net)
    net2 = _net(tmx, "float32")
    tr2 = _trainer(tmx, net2, "adam", False)
    _step(tmx, net2, tr2, 0, "float32")
    tr2.load_states(str(path))
    assert isinstance(tr2._updaters[0].states[0][0], torch.Tensor)
    _step(tmx, net2, tr2, 1, "float32")
    _close(_weights(net2), want)


def test_written_file_names_no_port_global():
    """The shared format names only the reference's globals, numpy's and
    the standard library's: the reference reads it without the port."""
    import pickletools
    net = _net(tmx, "bfloat16")
    tr = _trainer(tmx, net, "adam", True)
    _step(tmx, net, tr, 0, "bfloat16")
    data = tr._updaters[0].get_states(dump_optimizer=True)
    mods = {arg.split(" ")[0] for op, arg, _ in pickletools.genops(data)
            if op.name == "GLOBAL"}
    assert not any(m.startswith(("mxnet_tpu_torch", "torch", "ml_dtypes"))
                   for m in mods), mods
    assert {"mxnet_tpu.ndarray.ndarray", "mxnet_tpu.optimizer.optimizer",
            "jax.numpy"} <= mods
