"""The port's symbol frontend (``mxnet_tpu_torch.symbol``) against the JAX
package's, on the CPU.

- Composition: ``list_arguments``/``list_outputs``/
  ``list_auxiliary_states``/``list_inputs`` and ``infer_shape`` equal the
  reference's for an MLP, a conv + BatchNorm + pooling net and a
  BatchNorm given its moving statistics explicitly; ``infer_type``.
- Files: ``tojson`` strings equal the reference's for explicitly named
  graphs (whole strings); each package loads the other's file; the port
  loads the independent nnvm fixture (``tests/data/ref_export-*``) and
  computes what the fixture's weights give.
- Scalar arithmetic (``_plus_scalar`` ... ``_power_scalar``, ``-x``) and
  ``add_n``: the graphs equal, their outputs and gradients within 1e-6 of
  the max; ``get_internals``, indexing by output name, ``Group``,
  ``AttrScope`` and ``attr_dict`` as the reference's.
- Executor: forward and backward in float32 within 1e-6 of each array's
  max |value| of the reference's, with ``grad_req`` write, add and null,
  after ``reshape`` and ``copy_params_from``; the training forward equals
  the inference one (both packages' executors run BatchNorm on its
  moving statistics and Dropout as the identity, in training too).
- The new ops (``SoftmaxOutput`` with ``use_ignore``/``multi_output``/
  ``grad_scale``, the three regression outputs, ``make_loss``): outputs
  and custom gradients within 1e-6 of the reference's.
- ``Monitor`` reports the same names, in the same order, as the
  reference's (the statistic within 1e-6).

Every input comes from a numpy seed, and both packages get the same
parameters.
"""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

DATA = "tests/data/ref_export"
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _reference_compiles_unoptimized():
    """The reference compiles an XLA program per executor signature and
    per eager op; without XLA's optimizations they compile faster, and
    their values stay within these tolerances. The flag is restored and
    those programs dropped after the module."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _mlp(S):
    data = S.var("data")
    net = S.FullyConnected(data, num_hidden=8, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")


def _convnet(S):
    data = S.var("data")
    net = S.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name="conv1")
    net = S.BatchNorm(net, fix_gamma=False, name="bn1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    net = S.Flatten(net, name="flat1")
    return S.FullyConnected(net, num_hidden=3, name="fc1")


def _explicit_bn(S):
    data = S.var("data")
    return S.BatchNorm(data, S.var("g"), S.var("b"), S.var("mm"),
                       S.var("mv"), eps=1e-3, name="bn")


GRAPHS = {"mlp": (_mlp, {"data": (6, 5), "softmax_label": (6,)}),
          "convnet": (_convnet, {"data": (2, 3, 8, 8)}),
          "explicit_bn": (_explicit_bn, {"data": (4, 3, 5)})}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_composition_lists_and_shapes(name):
    build, shapes = GRAPHS[name]
    ref, own = build(mx.sym), build(tmx.sym)
    for attr in ("list_arguments", "list_outputs", "list_auxiliary_states",
                 "list_inputs"):
        assert getattr(own, attr)() == getattr(ref, attr)(), attr
    want = ref.infer_shape(**shapes)
    got = own.infer_shape(**shapes)
    assert [[tuple(s) for s in part] for part in got] == \
        [[tuple(s) for s in part] for part in want]
    assert own.infer_type()[0] == ref.infer_type()[0]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_json_strings_equal_and_load_both_ways(name, tmp_path):
    build, shapes = GRAPHS[name]
    ref, own = build(mx.sym), build(tmx.sym)
    assert own.tojson() == ref.tojson()
    own.save(str(tmp_path / "own.json"))
    ref.save(str(tmp_path / "ref.json"))
    back_ref = mx.sym.load(str(tmp_path / "own.json"))
    back_own = tmx.sym.load(str(tmp_path / "ref.json"))
    assert back_ref.tojson() == back_own.tojson() == own.tojson()
    assert back_own.infer_shape(**shapes)[1] == own.infer_shape(**shapes)[1]


def test_loads_the_nnvm_fixture():
    """The fixture's plain-string attrs and 3-element entries; its
    weights (``arg:`` names in the reference's bytes) give relu(x W^T +
    b)."""
    sym = tmx.sym.load(DATA + "-symbol.json")
    assert sym.list_arguments() == ["data", "fc0_weight", "fc0_bias"]
    assert sym.list_outputs() == ["relu0_output"]
    assert sym.infer_shape(data=(2, 6))[1] == [(2, 4)]
    params = tmx.nd.load(DATA + "-0000.params", ctx=tmx.cpu())
    w = params["arg:fc0_weight"].asnumpy()
    b = params["arg:fc0_bias"].asnumpy()
    x = np.linspace(-1, 1, 12).astype("float32").reshape(2, 6)
    out = sym.eval(ctx=tmx.cpu(), data=tmx.nd.array(x, ctx=tmx.cpu()),
                   fc0_weight=params["arg:fc0_weight"],
                   fc0_bias=params["arg:fc0_bias"])[0].asnumpy()
    np.testing.assert_allclose(out, np.maximum(x @ w.T + b, 0.0),
                               rtol=1e-5, atol=1e-6)


def _scalar_graph(S):
    a, b = S.var("a"), S.var("b")
    c = (a + 1.5) * 2.0 - b / 4.0
    c = 3.0 - c
    c = c + 2.0 / (b + 5.0)
    c = c ** 2.0 + (-a)
    return S.add_n(c, a, b, name="sum3")


def test_scalar_arithmetic_and_add_n():
    ref, own = _scalar_graph(mx.sym), _scalar_graph(tmx.sym)
    assert [n["op"] for n in json.loads(own.tojson())["nodes"]] == \
        [n["op"] for n in json.loads(ref.tojson())["nodes"]]
    rng = np.random.default_rng(0)
    a = rng.random((3, 4)).astype("float32")
    b = rng.random((3, 4)).astype("float32")
    want = ref.eval(ctx=mx.cpu(), a=mx.nd.array(a), b=mx.nd.array(b))
    got = own.eval(ctx=tmx.cpu(), a=tmx.nd.array(a, ctx=tmx.cpu()),
                   b=tmx.nd.array(b, ctx=tmx.cpu()))
    assert _rel(got[0].asnumpy(), want[0].asnumpy()) <= TOL
    # and their gradients, through both executors
    ref, own = _bind_pair(_scalar_graph, {"a": (3, 4), "b": (3, 4)}, 8)
    _check_step(ref, own, [rng.standard_normal((3, 4)).astype("f")])


def test_internals_indexing_groups_and_attr_scope():
    seen = {}
    for S in (mx.sym, tmx.sym):
        with S.AttrScope(ctx_group="dev1"):
            net = _mlp(S)
        internals = net.get_internals()
        fc1 = internals["fc1_output"]
        seen[S] = (internals.list_outputs(), len(internals),
                   fc1.list_arguments(), net.attr_dict(),
                   S.Group([fc1, net]).list_outputs(),
                   net.infer_shape_partial(data=(2, 5))[1])
    assert seen[tmx.sym] == seen[mx.sym]
    assert tmx.sym.contrib.dot_product_attention.__name__ == \
        "_contrib_dot_product_attention"


def _bind_pair(build, shapes, seed, grad_req="write"):
    """Both packages' executors of ``build``'s graph on the same values."""
    ref_sym, own_sym = build(mx.sym), build(tmx.sym)
    arg_shapes, _, aux_shapes = ref_sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    args = {n: rng.standard_normal(s).astype("float32")
            for n, s in zip(ref_sym.list_arguments(), arg_shapes)}
    if "softmax_label" in args:
        args["softmax_label"] = rng.integers(
            0, 4, shapes["softmax_label"]).astype("float32")
    aux = {n: rng.random(s).astype("float32") + 0.5
           for n, s in zip(ref_sym.list_auxiliary_states(), aux_shapes)}
    grads = {n: rng.standard_normal(v.shape).astype("float32")
             for n, v in args.items()}
    ref = ref_sym.bind(mx.cpu(), {n: mx.nd.array(v) for n, v in args.items()},
                       args_grad={n: mx.nd.array(v)
                                  for n, v in grads.items()},
                       grad_req=grad_req,
                       aux_states={n: mx.nd.array(v) for n, v in aux.items()})
    cpu = tmx.cpu()
    own = own_sym.bind(cpu, {n: tmx.nd.array(v, ctx=cpu)
                             for n, v in args.items()},
                       args_grad={n: tmx.nd.array(v, ctx=cpu)
                                  for n, v in grads.items()},
                       grad_req=grad_req,
                       aux_states={n: tmx.nd.array(v, ctx=cpu)
                                   for n, v in aux.items()})
    return ref, own


def _check_step(ref, own, out_grads=None):
    want = ref.forward(is_train=True)
    got = own.forward(is_train=True)
    for w, g in zip(want, got):
        assert _rel(g.asnumpy(), w.asnumpy()) <= TOL
    ref.backward(None if out_grads is None else
                 [mx.nd.array(o) for o in out_grads])
    own.backward(None if out_grads is None else
                 [tmx.nd.array(o, ctx=tmx.cpu()) for o in out_grads])
    for n, w in ref.grad_dict.items():
        assert _rel(own.grad_dict[n].asnumpy(), w.asnumpy()) <= TOL, n


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_executor_forward_backward(grad_req):
    ref, own = _bind_pair(_convnet, GRAPHS["convnet"][1], 1, grad_req)
    cot = [np.random.default_rng(2).standard_normal((2, 3)).astype("f")]
    _check_step(ref, own, cot)
    _check_step(ref, own, cot)      # "add" sums a second pass
    inference = own.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(inference, own.outputs[0].asnumpy())


def test_executor_training_forward_uses_moving_statistics():
    _, own = _bind_pair(_explicit_bn, GRAPHS["explicit_bn"][1], 3)
    before = {n: a.asnumpy() for n, a in own.aux_dict.items()}
    train = own.forward(is_train=True)[0].asnumpy()
    own.backward()
    np.testing.assert_array_equal(train,
                                  own.forward(is_train=False)[0].asnumpy())
    for n, a in own.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), before[n])


def test_executor_reshape_and_copy_params_from():
    ref, own = _bind_pair(_mlp, GRAPHS["mlp"][1], 4)
    ref2 = ref.reshape(data=(3, 5), softmax_label=(3,))
    own2 = own.reshape(data=(3, 5), softmax_label=(3,))
    assert own2.arg_dict["fc1_weight"] is own.arg_dict["fc1_weight"]
    rng = np.random.default_rng(5)
    params = {"fc1_weight": rng.standard_normal((8, 5)).astype("f"),
              "fc2_bias": rng.standard_normal(4).astype("f")}
    ref2.copy_params_from({n: mx.nd.array(v) for n, v in params.items()})
    own2.copy_params_from({n: tmx.nd.array(v, ctx=tmx.cpu())
                           for n, v in params.items()})
    x = rng.standard_normal((3, 5)).astype("f")
    y = np.array([0, 3, 1], "f")
    for ex, nd in ((ref2, mx.nd), (own2, tmx.nd)):
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
    _check_step(ref2, own2)
    with pytest.raises(ValueError):
        own2.copy_params_from({"nope": tmx.nd.zeros((1,), ctx=tmx.cpu())})


def _loss_graph(S, op, **kwargs):
    return getattr(S, op)(S.var("data"), S.var("label"), name="loss",
                          **kwargs)


LOSSES = {
    "softmax": ("SoftmaxOutput", {}, (5, 4), (5,)),
    "softmax_scaled": ("SoftmaxOutput", {"grad_scale": 0.5}, (5, 4), (5,)),
    "softmax_ignore": ("SoftmaxOutput", {"use_ignore": True,
                                         "ignore_label": 2}, (6, 4), (6,)),
    "softmax_multi": ("SoftmaxOutput", {"multi_output": True}, (2, 3, 4),
                      (2, 4)),
    "linear": ("LinearRegressionOutput", {}, (4, 3), (4, 3)),
    "mae": ("MAERegressionOutput", {"grad_scale": 2.0}, (4, 3), (4, 3)),
    "logistic": ("LogisticRegressionOutput", {}, (4, 3), (4, 3)),
    "make_loss": ("make_loss", {"grad_scale": 0.25}, (4, 3), None),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_layers_outputs_and_gradients(name):
    op, kwargs, dshape, lshape = LOSSES[name]
    rng = np.random.default_rng(6)
    x = rng.standard_normal(dshape).astype("float32")
    if lshape is None:
        ref_sym = getattr(mx.sym, op)(mx.sym.var("data"), name="loss",
                                      **kwargs)
        own_sym = getattr(tmx.sym, op)(tmx.sym.var("data"), name="loss",
                                       **kwargs)
        args = {"data": x}
    else:
        ref_sym = _loss_graph(mx.sym, op, **kwargs)
        own_sym = _loss_graph(tmx.sym, op, **kwargs)
        label = rng.integers(0, 4, lshape).astype("float32") \
            if op == "SoftmaxOutput" else \
            rng.standard_normal(lshape).astype("float32")
        args = {"data": x, "label": label}
    ref = ref_sym.bind(mx.cpu(), {n: mx.nd.array(v) for n, v in args.items()},
                       args_grad={"data": mx.nd.zeros(dshape)},
                       grad_req={"data": "write", "label": "null"})
    cpu = tmx.cpu()
    own = own_sym.bind(cpu, {n: tmx.nd.array(v, ctx=cpu)
                             for n, v in args.items()},
                       args_grad={"data": tmx.nd.zeros(dshape, ctx=cpu)},
                       grad_req={"data": "write", "label": "null"})
    cot = rng.standard_normal(dshape).astype("float32")
    want = ref.forward(is_train=True)[0].asnumpy()
    got = own.forward(is_train=True)[0].asnumpy()
    assert _rel(got, want) <= TOL
    ref.backward([mx.nd.array(cot)])
    own.backward([tmx.nd.array(cot, ctx=cpu)])
    assert _rel(own.grad_dict["data"].asnumpy(),
                ref.grad_dict["data"].asnumpy()) <= TOL


def test_monitor_reports_the_reference_names():
    stats = {}
    for name, pkg in (("ref", mx), ("own", tmx)):
        ref, own = _bind_pair(_mlp, GRAPHS["mlp"][1], 7)
        ex = ref if name == "ref" else own
        mon = pkg.monitor.Monitor(1, pattern=".*")
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=False)
        stats[name] = mon.toc()
    assert [k for _, k, _ in stats["own"]] == [k for _, k, _ in stats["ref"]]
    for (_, k, v), (_, _, w) in zip(stats["own"], stats["ref"]):
        assert abs(float(v) - float(w)) <= TOL * max(abs(float(w)), 1.0), k


def test_executor_keeps_arrays_in_place():
    """A fed argument is written into the bound array, so a graph captured
    over it stays valid; the inference forward reads fresh values."""
    sym = _mlp(tmx.sym)
    ex = sym.simple_bind(tmx.cpu(), grad_req="null", data=(2, 5),
                         softmax_label=(2,))
    ptr = ex.arg_dict["data"]._data.data_ptr()
    x = torch.ones((2, 5))
    ex.forward(data=tmx.nd.array(x, ctx=tmx.cpu()))
    assert ex.arg_dict["data"]._data.data_ptr() == ptr
    ex.arg_dict["fc2_bias"][:] = np.arange(4, dtype="float32")
    out = ex.forward(data=tmx.nd.array(x, ctx=tmx.cpu()))[0].asnumpy()
    want = np.exp(np.arange(4)) / np.exp(np.arange(4)).sum()
    np.testing.assert_allclose(out[0], want, rtol=1e-6)
