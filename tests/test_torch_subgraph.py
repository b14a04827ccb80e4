"""The port's subgraph partitioning and ``group2ctx`` placement
(``mxnet_tpu_torch.symbol.subgraph``, ``Executor``) against the JAX
package's, on the CPU: the counterparts of ``tests/test_subgraph.py``.
A partitioned graph equals the unpartitioned one bit for bit in the port
(forward and backward), and the reference's within 1e-5. Custom
properties registered here take a ``PT_`` name (the reference's own test
registers the plain one)."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.symbol import subgraph

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tmx.cpu():
        yield


def _mlp(S=sym):
    x = S.var("data")
    w = S.var("w")
    h = S.FullyConnected(x, w, no_bias=True, num_hidden=4, name="fc")
    return S.tanh(S.relu(h + 1.0) * 2.0)


def _arrays():
    rng = onp.random.default_rng(0)
    return {"data": rng.random((2, 3)).astype("float32"),
            "w": rng.random((4, 3)).astype("float32")}


def _bind(net, arrays, pkg=tmx, **kw):
    vals = {k: pkg.nd.array(v) for k, v in arrays.items()}
    ctx = CPU if pkg is tmx else jmx.cpu()
    return net.bind(ctx, vals, **kw)


def _out(net, arrays, pkg=tmx):
    return _bind(net, arrays, pkg).forward()[0].asnumpy()


def test_partition_preserves_semantics():
    a = _arrays()
    want = _out(_mlp(), a)
    got = _out(_mlp().get_backend_symbol("TPU_ELEMWISE"), a)
    assert onp.array_equal(got, want)
    ref = _out(_mlp(jmx.sym).get_backend_symbol("TPU_ELEMWISE"), a, jmx)
    onp.testing.assert_allclose(got, ref, rtol=1e-5)


def test_partition_actually_fuses():
    fused = _mlp().get_backend_symbol("TPU_ELEMWISE")
    jfused = _mlp(jmx.sym).get_backend_symbol("TPU_ELEMWISE")
    nodes = fused._toposort()
    sub = [n for n in nodes if n._attr.get("__subgraph__")]
    assert len(sub) == 1
    ops = sub[0]._attr["__subgraph_ops__"].split(",")
    jsub = [n for n in jfused._toposort() if n._attr.get("__subgraph__")]
    assert ops == jsub[0]._attr["__subgraph_ops__"].split(",")
    assert all("FullyConnected" not in o for o in ops)
    assert sub[0]._op.name.startswith("_subgraph_TPU_ELEMWISE_")
    assert tmx.ops.registry.get_op(sub[0]._op.name) is sub[0]._op
    outside = [n for n in nodes if n._op is not None
               and not n._attr.get("__subgraph__")]
    assert [n._op.name for n in outside] == ["FullyConnected"]


def test_partition_backward_matches():
    a = _arrays()
    grads = {}
    for name, net in (("plain", _mlp()),
                      ("fused", _mlp().get_backend_symbol("TPU_ELEMWISE"))):
        g = {k: nd.zeros(v.shape) for k, v in a.items()}
        ex = _bind(net, a, args_grad=g)
        out = ex.forward(is_train=True)[0]
        ex.backward(nd.ones(out.shape))
        grads[name] = {k: v.asnumpy() for k, v in ex.grad_dict.items()}
    jg = {k: jmx.nd.zeros(v.shape) for k, v in a.items()}
    jex = _bind(_mlp(jmx.sym).get_backend_symbol("TPU_ELEMWISE"), a, jmx,
                args_grad=jg)
    jout = jex.forward(is_train=True)[0]
    jex.backward(jmx.nd.ones(jout.shape))
    for k in a:
        assert onp.array_equal(grads["fused"][k], grads["plain"][k])
        onp.testing.assert_allclose(grads["fused"][k],
                                    jex.grad_dict[k].asnumpy(), rtol=1e-5,
                                    atol=1e-6)


def test_env_knob_applies_at_bind(monkeypatch):
    a = _arrays()
    want = _out(_mlp(), a)
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_ELEMWISE")
    ex = _bind(_mlp(), a)
    assert [n for n in ex._symbol._toposort()
            if n._attr.get("__subgraph__")]
    assert onp.array_equal(ex.forward()[0].asnumpy(), want)
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "NOPE")
    ex = _bind(_mlp(), a)      # an unknown backend binds unpartitioned
    assert not [n for n in ex._symbol._toposort()
                if n._attr.get("__subgraph__")]


def test_custom_property_registration():
    class EverythingSelector(subgraph.SubgraphSelector):
        def select(self, node):
            return True

        def min_size(self):
            return 1

    class WholeGraphProperty(subgraph.SubgraphProperty):
        name = "PT_TEST_ALL"

        def create_selector(self):
            return EverythingSelector()

    subgraph.register_subgraph_property("PT_TEST_ALL", WholeGraphProperty())
    assert "PT_TEST_ALL" in subgraph.list_backends()
    assert "TPU_ELEMWISE" in tmx.sym.subgraph.list_backends()
    fused = _mlp().get_backend_symbol("PT_TEST_ALL")
    nodes = [n for n in fused._toposort() if n._op is not None]
    assert len(nodes) == 1
    assert nodes[0]._attr.get("__subgraph__") == "PT_TEST_ALL"
    a = _arrays()
    assert onp.array_equal(_out(fused, a), _out(_mlp(), a))


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        _mlp().get_backend_symbol("NOPE")


def test_binary_elemwise_fuses():
    def build(S):
        x, y = S.var("a"), S.var("b")
        return S.tanh(S.elemwise_add(S.relu(x), S.relu(y)))
    fused = build(sym).get_backend_symbol("TPU_ELEMWISE")
    subs = [n for n in fused._toposort() if n._attr.get("__subgraph__")]
    assert len(subs) == 1
    assert len(subs[0]._attr["__subgraph_ops__"].split(",")) == 4
    a = {"a": onp.array([[-1.0, 2.0]], "float32"),
         "b": onp.array([[3.0, -4.0]], "float32")}
    got = _out(fused, a)
    assert onp.array_equal(got, _out(build(sym), a))
    onp.testing.assert_allclose(
        got, _out(build(jmx.sym).get_backend_symbol("TPU_ELEMWISE"), a,
                  jmx), rtol=1e-6)


def test_non_convex_region_is_cut():
    def build(S):
        x = S.var("data")
        a = S.relu(x)
        c = S.FullyConnected(S.FullyConnected(a, num_hidden=2, name="fc1"),
                             num_hidden=2, name="fc2")
        return S.elemwise_add(a * 1.0, c)
    d = build(sym)
    fused = d.get_backend_symbol("TPU_ELEMWISE")
    outs = []
    for net, ctx, pkg in ((fused, CPU, tmx), (d, CPU, tmx),
                          (build(jmx.sym).get_backend_symbol("TPU_ELEMWISE"),
                           jmx.cpu(), jmx)):
        ex = net.simple_bind(ctx, data=(2, 2))
        for k in ex.arg_dict:
            ex.arg_dict[k][:] = 0.5
        outs.append(ex.forward()[0].asnumpy())
    assert onp.array_equal(outs[0], outs[1])
    onp.testing.assert_allclose(outs[0], outs[2], rtol=1e-5)


def test_partitioned_symbol_json_roundtrip():
    fused = _mlp().get_backend_symbol("TPU_ELEMWISE")
    back = sym.load_json(fused.tojson())
    a = _arrays()
    assert onp.array_equal(_out(back, a), _out(_mlp(), a))


def test_env_knob_positional_args_keep_original_order(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_ELEMWISE")
    a, c = sym.var("a"), sym.var("c")
    out = sym.elemwise_add(
        sym.FullyConnected(a, num_hidden=2, no_bias=True, name="fc"),
        sym.relu(c))
    vals = {"a": onp.ones((1, 2), "float32"),
            "fc_weight": onp.ones((2, 2), "float32"),
            "c": onp.zeros((1, 2), "float32")}
    ex = out.bind(CPU, [nd.array(vals[n]) for n in out.list_arguments()])
    onp.testing.assert_array_equal(ex.forward()[0].asnumpy(), [[2.0, 2.0]])


def test_env_knob_rebind_reuses_fused_ops(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_ELEMWISE")
    from mxnet_tpu_torch.ops.registry import list_ops
    net = _mlp()
    a = _arrays()
    _bind(net, a).forward()
    n_ops = len(list_ops())
    for _ in range(3):
        _bind(net, a).forward()
    assert len(list_ops()) == n_ops


def test_group2ctx_places_ops_on_devices():
    with sym.AttrScope(ctx_group="dev1"):
        a = sym.var("a")
        h = sym.relu(a)
    with sym.AttrScope(ctx_group="dev2"):
        out = sym.tanh(h * 2.0)
    ex = out.bind(CPU, {"a": nd.array(onp.array([-1.0, 1.0], "float32"))},
                  group2ctx={"dev1": tmx.cpu(1), "dev2": tmx.cpu(2)})
    got = ex.forward()[0].asnumpy()
    onp.testing.assert_allclose(got, onp.tanh(2 * onp.maximum([-1, 1], 0)),
                                rtol=1e-6)
    assert set(ex._placement.values()) == {tmx.cpu(1), tmx.cpu(2)}


def test_group2ctx_backward_crosses_devices():
    def build(S):
        with S.AttrScope(ctx_group="dev1"):
            a = S.var("a")
            h = S.FullyConnected(a, num_hidden=3, no_bias=True, name="fc")
        with S.AttrScope(ctx_group="dev2"):
            return S.sum(S.tanh(h))
    vals = {"a": onp.ones((2, 2), "float32"),
            "fc_weight": 0.1 * onp.ones((3, 2), "float32")}
    got = {}
    for tag, pkg, g2c in (
            ("placed", tmx, {"dev1": tmx.cpu(3), "dev2": tmx.cpu(4)}),
            ("plain", tmx, None),
            ("ref", jmx, {"dev1": jmx.cpu(3), "dev2": jmx.cpu(4)})):
        grads = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
        ex = _bind(build(pkg.sym), vals, pkg, args_grad=grads,
                   group2ctx=g2c)
        ex.forward(is_train=True)
        ex.backward()
        got[tag] = grads["fc_weight"].asnumpy()
    assert got["placed"].shape == (3, 2) and onp.abs(got["placed"]).sum() > 0
    assert onp.array_equal(got["placed"], got["plain"])
    onp.testing.assert_allclose(got["placed"], got["ref"], rtol=1e-5)


def test_attrscope_reentrant_and_reusable():
    s = sym.AttrScope(ctx_group="g")
    with s:
        with s:
            pass
    assert sym.AttrScope.current_attrs() == {}
    assert sym.var("after_scope").attr("ctx_group") is None
    with sym.AttrScope(lr_mult="2"):
        with s:
            pass
    with s:
        v2 = sym.var("only_group")
    assert v2.attr("ctx_group") == "g"
    assert v2.attr("lr_mult") is None


def test_fused_region_keeps_ctx_group(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_ELEMWISE")
    with sym.AttrScope(ctx_group="dev1"):
        a = sym.var("a")
        out = sym.tanh(sym.relu(a) * 2.0)
    ex = out.bind(CPU, {"a": nd.array(onp.ones((2,), "float32"))},
                  group2ctx={"dev1": tmx.cpu(1)})
    fused = [n for n in ex._symbol._toposort()
             if n._attr.get("__subgraph__")]
    assert len(fused) == 1 and ex._placement[id(fused[0])] == tmx.cpu(1)
    assert set(ex._placement.values()) == {tmx.cpu(1)}
    onp.testing.assert_allclose(ex.forward()[0].asnumpy(),
                                onp.tanh([2.0, 2.0]), rtol=1e-6)


def test_fusion_respects_group_barrier(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_ELEMWISE")
    with sym.AttrScope(ctx_group="dev1"):
        a = sym.var("a")
        h = sym.relu(a) * 2.0
    with sym.AttrScope(ctx_group="dev2"):
        out = sym.tanh(sym.exp(h))
    fused = out.get_backend_symbol("TPU_ELEMWISE")
    subs = [n for n in fused._toposort() if n._attr.get("__subgraph__")]
    assert {s._attr.get("ctx_group") for s in subs} == {"dev1", "dev2"}


def test_simple_bind_and_module_forward_group2ctx():
    with sym.AttrScope(ctx_group="g1"):
        x = sym.var("data")
        out = sym.FullyConnected(x, num_hidden=3, name="fcg")
    ex = out.simple_bind(CPU, data=(2, 4), group2ctx={"g1": tmx.cpu(5)})
    assert ex._placement
    ex2 = ex.reshape(data=(4, 4))
    assert ex2._placement
    m = tmx.mod.Module(out, data_names=("data",), label_names=None,
                       context=CPU, group2ctxs={"g1": tmx.cpu(6)})
    m.bind(data_shapes=[("data", (2, 4))], for_training=False)
    assert m._exec._placement
    m.init_params()
    m.forward(tmx.io.DataBatch([nd.ones((2, 4))], None), is_train=False)
    assert m.get_outputs()[0].shape == (2, 3)
