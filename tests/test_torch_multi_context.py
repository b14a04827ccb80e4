"""The port's multi-context paths against the JAX package's, on the CPU:
``gluon.Trainer`` over parameters on several contexts through each
store (the counterpart of ``tests/test_parallel.py::
test_trainer_multictx_eager_steps_no_buffer_donation_clash``) and
``model.FeedForward`` over several contexts. Logical contexts
``mx.cpu(i)`` are the reference's virtual CPU devices."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CTXS = [tmx.cpu(0), tmx.cpu(1)]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tmx.cpu():
        yield


def _dense(pkg, ctx):
    net = pkg.gluon.nn.Dense(4, in_units=3)
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    return net


def _steps(pkg, net, tr, xs, n=3):
    ag = pkg.autograd
    for _ in range(n):
        losses = []
        with ag.record():
            for x in xs:
                losses.append((net(x) ** 2).mean())
        for l in losses:
            l.backward()
        tr.step(4)


@pytest.mark.parametrize("store", ["local", "device", "nccl", None])
def test_trainer_multictx_eager_steps_no_buffer_donation_clash(store):
    """Two contexts: every copy owns its buffer and ends as the
    reference's copy on its context (same draws); through a store the
    copies end equal, without one each follows its own gradients."""
    rng = np.random.default_rng(0)
    xs_np = [rng.standard_normal((2, 3)).astype("float32") for _ in range(2)]
    jmx.random.seed(0)
    np.random.seed(0)
    jnet = _dense(jmx, [jmx.cpu(0), jmx.cpu(1)])
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore=store)
    _steps(jmx, jnet, jtr, [jmx.nd.array(x, ctx=jmx.cpu(i))
                            for i, x in enumerate(xs_np)])
    tmx.random.seed(0)
    np.random.seed(0)
    net = _dense(tmx, CTXS)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore=store)
    _steps(tmx, net, tr, [tmx.nd.array(x, ctx=c)
                          for x, c in zip(xs_np, CTXS)])
    assert (tr._kvstore is None) == (store is None)
    for (name, p), jp in zip(net.collect_params().items(),
                             jnet.collect_params().values()):
        datas = p.list_data()
        ptrs = {d._data.data_ptr() for d in datas}
        assert len(ptrs) == 2, name
        if store is not None:       # summed gradients: equal copies
            np.testing.assert_array_equal(datas[0].asnumpy(),
                                          datas[1].asnumpy())
        for d, jd in zip(datas, jp.list_data()):
            np.testing.assert_allclose(d.asnumpy(), jd.asnumpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_trainer_multictx_compression_and_states(tmp_path):
    """A two-context Trainer with 2bit compression sums the compressed
    copies (bitwise the reference's), and its states file round-trips."""
    rng = np.random.default_rng(2)
    xs_np = [rng.standard_normal((2, 3)).astype("float32") for _ in range(2)]
    comp = {"type": "2bit", "threshold": 0.05}
    out = {}
    for pkg, ctxs in ((jmx, [jmx.cpu(0), jmx.cpu(1)]), (tmx, CTXS)):
        pkg.random.seed(3)
        np.random.seed(3)
        net = _dense(pkg, ctxs)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="local",
                               compression_params=comp)
        _steps(pkg, net, tr, [pkg.nd.array(x, ctx=c)
                              for x, c in zip(xs_np, ctxs)], n=2)
        out[pkg.__name__] = [p.list_data()[0].asnumpy()
                             for p in net.collect_params().values()]
        if pkg is tmx:
            tr.save_states(str(tmp_path / "t.states"))
            tr.load_states(str(tmp_path / "t.states"))
    for a, b in zip(out["mxnet_tpu_torch"], out["mxnet_tpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_feedforward_over_two_contexts():
    """``FeedForward`` over two contexts (a ``local`` store) ends where
    one context ends."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 6)).astype("float32")
    y = (x @ rng.standard_normal((6, 3))).argmax(1).astype("float32")

    def sym(S):
        net = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
        return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")
    got = {}
    for ctx in (tmx.cpu(), CTXS):
        np.random.seed(1)
        model = tmx.model.FeedForward(sym(tmx.sym), ctx=ctx, num_epoch=2,
                                      numpy_batch_size=8,
                                      learning_rate=0.1,
                                      initializer=tmx.init.Xavier())
        model.fit(x, y, kvstore="local")
        got[len(ctx) if isinstance(ctx, list) else 1] = \
            {n: v.asnumpy() for n, v in model.arg_params.items()}
        assert model.predict(x).shape == (24, 3)
    for n in got[1]:
        np.testing.assert_allclose(got[2][n], got[1][n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_a_context_call_swaps_only_the_called_blocks_own_parameters():
    """A block called on ``cpu(1)`` NDArrays runs on its own parameters'
    ``cpu(1)`` copies; another network with copies on ``cpu(1)`` keeps its
    first copies in its slots meanwhile, and every slot is back after the
    call. A nested call on the same context (a user block's child) runs on
    the copies the outermost call installed."""
    seen = {}

    class Outer(tmx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.inner = tmx.gluon.nn.Dense(4, in_units=3)

        def forward(self, x):
            seen["inner"] = self.inner._parameters["weight"]
            seen["other"] = other._parameters["weight"]
            return self.inner(x)

    outer = Outer()
    outer.initialize(tmx.init.Xavier(), ctx=CTXS)
    other = _dense(tmx, CTXS)
    w, wo = outer.inner.weight, other.weight
    x = np.ones((2, 3), "float32")
    w.tensor(CTXS[1]).data.mul_(2)
    y1 = outer(tmx.nd.array(x, ctx=CTXS[1]))
    assert seen["inner"] is w.tensor(CTXS[1])
    assert seen["other"] is wo.tensor(CTXS[0])
    assert outer.inner._parameters["weight"] is w.tensor(CTXS[0])
    y0 = outer(tmx.nd.array(x, ctx=CTXS[0]))
    assert seen["inner"] is w.tensor(CTXS[0])
    b = outer.inner.bias.data().asnumpy()
    np.testing.assert_allclose(y1.asnumpy() - b, 2 * (y0.asnumpy() - b),
                               rtol=1e-6)


def test_context_calls_from_two_threads_each_see_their_copies():
    """Two threads calling one block on its two contexts at once each get
    their own context's result: the swap of one call is never seen by the
    other."""
    import threading
    net = _dense(tmx, CTXS)
    net.weight.tensor(CTXS[1]).data.mul_(-1)
    x = np.random.default_rng(4).standard_normal((2, 3)).astype("float32")
    want = {c: net(tmx.nd.array(x, ctx=c)).asnumpy() for c in CTXS}
    assert not np.allclose(want[CTXS[0]], want[CTXS[1]])
    bad = []

    def run(ctx):
        for _ in range(200):
            with ctx:
                got = net(tmx.nd.array(x, ctx=ctx)).asnumpy()
            if not np.array_equal(got, want[ctx]):
                bad.append(ctx)
    threads = [threading.Thread(target=run, args=(c,)) for c in CTXS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


def test_the_op_layer_does_not_import_the_distribution_layer():
    """The ops reduce over a mesh step's replicas only through
    ``ops/_collective``: no op module imports ``parallel``, and no model
    imports ``parallel.replicas``."""
    import ast
    import pathlib
    root = pathlib.Path(tmx.__file__).parent
    for sub, banned in (("ops", "parallel"), ("models", "parallel.replicas")):
        for path in sorted((root / sub).glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] + [
                        ("%s.%s" % (node.module or "", a.name)).lstrip(".")
                        for a in node.names]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                assert not any(n == banned or n.startswith(banned + ".")
                               or ("." + banned) in n for n in names), \
                    (str(path), ast.dump(node))
