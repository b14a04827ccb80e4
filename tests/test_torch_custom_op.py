"""``mxnet_tpu_torch.operator`` (the ``Custom`` op, ``nd.Custom``,
``sym.Custom``) against the JAX package on the CPU.

Each case mirrors one of ``tests/test_custom_op.py``. The custom ops are
defined once (``_define``: the same source, built over each package's
``mx``) and registered in both packages under the same names (``pt_*``,
apart from the reference test's own); both run
the same seeded inputs. Values and gradients are computed in numpy by the
user code itself, so the two packages agree bit for bit (float32 in,
float32 out). The port's own rules: a hybridized block that reaches the
host op runs its signature eagerly and ``cache_stats()`` counts it under
``host_eager``; aux states take no gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ops import registry as treg


def _define(mx):
    """The custom ops of these tests over one package's ``mx``."""

    @mx.operator.register("pt_tsoftmax")
    class TSoftmaxProp(mx.operator.CustomOpProp):
        """``example/numpy-ops/custom_softmax.py``: the backward takes the
        label (``need_top_grad=False``)."""

        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TSoftmax()

    class TSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("pt_scale2")
    class Scale2Prop(mx.operator.CustomOpProp):
        """A string kwarg and a true gradient."""

        def __init__(self, factor="2.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, shapes, dtypes):
            factor = self.factor

            class _Scale(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                mx.nd.array(in_data[0].asnumpy() * factor))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                mx.nd.array(out_grad[0].asnumpy() * factor))
            return _Scale()

    @mx.operator.register("pt_statemask")
    class StateMaskProp(mx.operator.CustomOpProp):
        """State kept on ``self`` in forward, read in backward."""

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.saved_mask = (x > 0).astype(x.dtype)
                    self.assign(out_data[0], req[0],
                                mx.nd.array(x * self.saved_mask))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    g = out_grad[0].asnumpy() * self.saved_mask
                    self.assign(in_grad[0], req[0], mx.nd.array(g))
            return _Op()

    @mx.operator.register("pt_withaux")
    class WithAuxProp(mx.operator.CustomOpProp):
        """``data * aux``: an aux state takes no gradient."""

        def list_arguments(self):
            return ["data"]

        def list_auxiliary_states(self):
            return ["scale"]

        def infer_shape(self, in_shape):
            return in_shape[:1], [in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], mx.nd.array(
                        in_data[0].asnumpy() * aux[0].asnumpy()))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], mx.nd.array(
                        out_grad[0].asnumpy() * aux[0].asnumpy()))
            return _Op()

    seen = []

    @mx.operator.register("pt_trainprobe")
    class ProbeProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    seen.append(bool(is_train))
                    self.assign(out_data[0], req[0], in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])
            return _Op()

    @mx.operator.register("pt_axsplit")
    class AxProp(mx.operator.CustomOpProp):
        def __init__(self, axes="0,1"):
            super().__init__()
            self.axes = [int(a) for a in axes.split(",")]

        def create_operator(self, ctx, shapes, dtypes):
            axes = self.axes

            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                mx.nd.array(in_data[0].asnumpy()
                                            + float(len(axes))))
            return _Op()

    return seen


SEEN = {"ref": _define(jmx), "port": _define(tmx)}
RNG = np.random.default_rng(17)
X45 = RNG.standard_normal((4, 5)).astype(np.float32)
LAB = np.array([1, 0, 3, 2], np.float32)


def _np_softmax(x):
    y = np.exp(x - x.max(axis=1, keepdims=True))
    return y / y.sum(axis=1, keepdims=True)


def _both(fn):
    """``fn(mx)`` in each package (the port on the CPU) as numpy."""
    ref = fn(jmx)
    with tmx.cpu():
        own = fn(tmx)
    return ref, own


def _equal(ref, own):
    assert own.dtype == ref.dtype and own.shape == ref.shape
    np.testing.assert_array_equal(own, ref)


def test_custom_names_resolve_to_one_op():
    op = treg.get_op("Custom")
    assert op is treg.get_op("_npi_Custom") is treg.get_op("_npx_Custom")
    assert op.host_op and "Custom" in tmx.ndarray.__dict__


@pytest.mark.parametrize("by_keyword", [False, True])
def test_custom_forward(by_keyword):
    def run(mx):
        if by_keyword:
            return mx.nd.Custom(label=mx.nd.array(LAB),
                                data=mx.nd.array(X45),
                                op_type="pt_tsoftmax").asnumpy()
        return mx.nd.Custom(mx.nd.array(X45), mx.nd.array(LAB),
                            op_type="pt_tsoftmax").asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    np.testing.assert_allclose(own, _np_softmax(X45), rtol=1e-6)


def test_custom_backward_takes_the_label():
    def run(mx):
        x = mx.nd.array(X45)
        x.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Custom(x, mx.nd.array(LAB), op_type="pt_tsoftmax")
        out.backward()
        return x.grad.asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    expect = _np_softmax(X45)
    expect[np.arange(4), LAB.astype(np.int64)] -= 1.0
    np.testing.assert_allclose(own, expect, rtol=1e-6, atol=1e-7)


def test_custom_true_gradient_chain():
    def run(mx):
        x = mx.nd.array(np.float32([[1.0, -2.0, 3.0]]))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="pt_scale2", factor="3.0")
            z = (y * y).sum()
        z.backward()
        return x.grad.asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    np.testing.assert_allclose(own, 18.0 * np.float32([[1.0, -2.0, 3.0]]))


def test_custom_state_forward_to_backward():
    def run(mx):
        x = mx.nd.array(np.float32([-1.0, 2.0, -3.0, 4.0]))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="pt_statemask").sum()
        y.backward()
        return x.grad.asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    np.testing.assert_array_equal(own, np.float32([0, 1, 0, 1]))


def test_aux_state_takes_no_gradient():
    x = np.float32([[1.0, -2.0], [0.5, 3.0]])
    s = np.float32([[2.0, 3.0], [4.0, 5.0]])

    def run(mx):
        a, b = mx.nd.array(x), mx.nd.array(s)
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Custom(a, b, op_type="pt_withaux")
        out.backward()
        return out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()
    ref, own = _both(run)
    for r, o in zip(ref, own):
        _equal(r, o)
    np.testing.assert_array_equal(own[2], np.zeros_like(s))


def _net(mx, factor):
    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.fc(x), op_type="pt_scale2",
                            factor="%s" % factor)
    return Net()


def test_custom_in_hybridized_block_runs_eagerly_and_is_counted():
    x = RNG.standard_normal((2, 3)).astype(np.float32)
    jnet = _net(jmx, 2.0)
    jnet.initialize()
    ref = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        net = _net(tmx, 2.0)
        net.initialize()
        for name, p in net.collect_params().items():
            p.set_data(jnet.collect_params()[name.replace(
                net.prefix, jnet.prefix, 1)].data().asnumpy())
        y0 = net(tmx.nd.array(x)).asnumpy()
        net.hybridize()
        y1 = net(tmx.nd.array(x)).asnumpy()
        y2 = net(tmx.nd.array(x)).asnumpy()
    for y in (y0, y1, y2):
        np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6)
    (op,) = net._cached_ops.values()
    stats = op.cache_stats()
    assert stats["host_eager"] == 1 and stats["misses"] == 1 \
        and stats["hits"] == 1 and stats["graphs"] == 0


def test_a_callable_without_host_op_is_not_counted():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(4, in_units=3)
        net.initialize()
        net.hybridize()
        for _ in range(2):
            net(tmx.nd.ones((2, 3)))
    (op,) = net._cached_ops.values()
    assert op.cache_stats()["host_eager"] == 0


def test_custom_symbol_compose_and_bind():
    def run(mx):
        data = mx.sym.var("data")
        out = mx.sym.Custom(data=data, op_type="pt_scale2", factor="5.0",
                            name="sc")
        x = mx.nd.array(np.float32([[1.0, 2.0]]))
        (y,) = out.bind(mx.cpu(), {"data": x}).forward()
        return y.asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    np.testing.assert_array_equal(own, np.float32([[5.0, 10.0]]))


def test_custom_is_train_reaches_the_op_through_executor_and_module():
    for key, mx in (("ref", jmx), ("port", tmx)):
        SEEN[key].clear()
        data = mx.sym.var("data")
        out = mx.sym.Custom(data=data, op_type="pt_trainprobe")
        ex = out.bind(mx.cpu(), {"data": mx.nd.ones((2,), ctx=mx.cpu())})
        ex.forward(is_train=True)
        ex.forward(is_train=False)
        assert SEEN[key] == [True, False], key
    SEEN["port"].clear()
    with tmx.cpu():
        sym = tmx.sym.Custom(data=tmx.sym.var("data"), op_type="pt_trainprobe")
        mod = tmx.mod.Module(sym, data_names=["data"], label_names=None,
                             context=tmx.cpu())
        mod.bind(data_shapes=[("data", (2, 3))])
        mod.init_params()
        batch = tmx.io.DataBatch([tmx.nd.ones((2, 3))])
        mod.forward(batch, is_train=True)
        mod.forward(batch, is_train=False)
    assert SEEN["port"][-2:] == [True, False]


def test_custom_str_kwarg_survives_json():
    def run(mx):
        data = mx.sym.var("data")
        out = mx.sym.Custom(data=data, op_type="pt_axsplit", axes="0,1,2")
        out2 = mx.sym.load_json(out.tojson())
        (y,) = out2.bind(mx.cpu(), {"data": mx.nd.zeros((2,))}).forward()
        return y.asnumpy()
    ref, own = _both(run)
    _equal(ref, own)
    np.testing.assert_array_equal(own, np.float32([3.0, 3.0]))


def test_custom_export_roundtrip(tmp_path):
    x = RNG.standard_normal((2, 3)).astype(np.float32)
    with tmx.cpu():
        net = _net(tmx, 4.0)
        net.initialize()
        y0 = net(tmx.nd.array(x)).asnumpy()
        net.hybridize()
        net(tmx.nd.array(x))
        sf, pf = net.export(str(tmp_path / "cnet"))
        sb = tmx.gluon.SymbolBlock.imports(sf, ["data"], pf,
                                           ctx=tmx.cpu())
        np.testing.assert_array_equal(sb(tmx.nd.array(x)).asnumpy(), y0)
    # the reference reads the port's files
    jsb = jmx.gluon.SymbolBlock.imports(sf, ["data"], pf)
    np.testing.assert_allclose(jsb(jmx.nd.array(x)).asnumpy(), y0,
                               rtol=1e-6, atol=1e-6)


def test_register_op_with_a_torch_function():
    @tmx.operator.register_op(name="_test_squareplus_torch")
    def _squareplus(x, beta=1.0):
        return (x + torch.sqrt(x * x + beta)) / 2.0

    try:
        with tmx.cpu():
            x = tmx.nd.array(np.float32([-1.0, 0.0, 2.0]))
            y = tmx.nd._test_squareplus_torch(x)
            x.attach_grad()
            with tag.record():
                z = tmx.nd._test_squareplus_torch(x).sum()
            z.backward()
    finally:      # the registry gate holds the port to the reference's names
        del treg._OP_REGISTRY["_test_squareplus_torch"]
    xn = x.asnumpy()
    np.testing.assert_allclose(y.asnumpy(), (xn + np.sqrt(xn ** 2 + 1)) / 2,
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(),
                               0.5 * (1 + xn / np.sqrt(xn ** 2 + 1)),
                               rtol=1e-5)


def test_reregistration_replaces_the_prop():
    def define(mx, k):
        @mx.operator.register("pt_revop")
        class Rev(mx.operator.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes):
                class _Op(mx.operator.CustomOp):
                    def forward(self, is_train, req, in_data, out_data,
                                aux):
                        self.assign(out_data[0], req[0], mx.nd.array(
                            in_data[0].asnumpy() * k))
                return _Op()

    for k in (2, 10):
        define(jmx, k)
        define(tmx, k)
        ref, own = _both(lambda mx: mx.nd.Custom(
            mx.nd.ones((2,)), op_type="pt_revop").asnumpy())
        _equal(ref, own)
        np.testing.assert_array_equal(own, np.float32([k, k]))


def test_unregistered_op_type_raises_the_reference_message():
    msgs = []
    for mx in (jmx, tmx):
        with pytest.raises(ValueError) as e, tmx.cpu():
            mx.nd.Custom(mx.nd.ones((1,)), op_type="not_registered_here")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not registered" in msgs[1]
