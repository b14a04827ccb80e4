"""The port's legacy training frontend (``mxnet_tpu_torch.module``,
``model``, ``callback``, ``visualization``) against the JAX package's, on
the CPU, as ``tests/test_module.py`` drives the reference.

- ``Module.fit`` of an MLP, 2 epochs of ``NDArrayIter`` batches from
  ``Xavier()`` (the same numpy draws) with SGD and momentum, ends with
  the reference's parameters (within 1e-5 of each array's max |value|);
  ``score`` equals the reference's and ``predict`` trims the padded last
  batch as the reference's does (outputs within 1e-5).
- ``BucketingModule`` (two buckets sharing one weight), a
  ``SequentialModule`` (feature module -> head, trained through the
  chain) and a ``PythonModule``, each held to the reference's outputs
  and parameters on the same batches.
- Checkpoints: ``save_checkpoint`` files of each package load through the
  other's ``load_checkpoint`` (and ``Module.load``), giving the same
  predictions; ``Module.load`` -> ``predict`` equals the saved module's
  bit for bit; optimizer states round-trip through the port's own file.
- ``print_summary``'s text equals the reference's; ``block_summary``
  counts a block's parameters; ``plot_network`` draws the operators (or
  raises ``ImportError`` without ``graphviz``).
- ``FeedForward.create`` (shuffled batches from the same numpy draws)
  ends with the reference's parameters; its ``predict``/``score`` and a
  ``save``/``load`` round trip.
- BatchNorm under ``Module``: as in the reference, a training step
  normalizes by the moving statistics and leaves them unchanged (the
  reference's ``BatchNorm`` op is pure and its executor binds no training
  state), so a conv + BatchNorm net's parameters after 2 steps equal the
  reference's and its moving statistics equal their initial values.
- Several contexts and stores: a Module over two contexts (data
  parallel through a local store) ends where one context ends (1e-6)
  and where the reference's two-context Module ends; ``group2ctx``
  binds; ``dist_sync``/``nccl`` stores work as a world of one and raise
  ``NotImplementedError`` naming ROADMAP item 10b over several
  processes; the contrib control flow is ported.
"""
import contextlib
import io as _io
import logging

import numpy as np
import pytest

import jax
import mxnet_tpu as mx
from mxnet_tpu_torch.base import MXNetError
import mxnet_tpu_torch as tmx

TOL = 1e-5
CPU = tmx.cpu()


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


def _mlp(S, classes=4):
    data = S.var("data")
    net = S.FullyConnected(data, num_hidden=16, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=classes, name="fc2")
    return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")


def _convbn(S):
    data = S.var("data")
    net = S.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        no_bias=True, name="conv1")
    net = S.BatchNorm(net, fix_gamma=False, name="bn1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg",
                    name="pool1")
    net = S.FullyConnected(net, num_hidden=3, name="fc1")
    return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")


def _data(n=40, d=10, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype("float32")
    y = (x @ rng.standard_normal((d, classes))).argmax(1).astype("float32")
    return x, y


def _params(mod):
    arg, aux = mod.get_params()
    return {n: v.asnumpy() for n, v in list(arg.items()) + list(aux.items())}


def _assert_params_equal(own, ref, tol=TOL):
    own, ref = _params(own), _params(ref)
    assert sorted(own) == sorted(ref)
    for n in ref:
        assert _rel(own[n], ref[n]) <= tol, n


def _fit_pair(build, x, y, batch, epochs, **fit_kwargs):
    mods = {}
    for name, pkg, ctx in (("ref", mx, mx.cpu()), ("own", tmx, CPU)):
        np.random.seed(1)
        mod = pkg.mod.Module(build(pkg.sym), context=ctx)
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch),
                num_epoch=epochs, initializer=pkg.init.Xavier(),
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                **fit_kwargs)
        mods[name] = mod
    return mods["ref"], mods["own"]


def test_fit_score_predict_match_reference():
    x, y = _data(n=24)
    ref, own = _fit_pair(_mlp, x, y, 8, 2)
    _assert_params_equal(own, ref)
    for mod, pkg in ((ref, mx), (own, tmx)):
        mod._score = mod.score(pkg.io.NDArrayIter(x, y, batch_size=8),
                               "acc")
    assert own._score == ref._score
    # 24 rows in batches of 10: the last batch is padded by 6 and trimmed
    want = ref.predict(mx.io.NDArrayIter(x, y, batch_size=10)).asnumpy()
    got = own.predict(tmx.io.NDArrayIter(x, y, batch_size=10)).asnumpy()
    assert got.shape == want.shape == (24, 4)
    assert _rel(got, want) <= TOL


def test_feedforward_matches_reference(tmp_path):
    x, y = _data(n=24)
    models = {}
    for name, pkg, ctx in (("ref", mx, mx.cpu()), ("own", tmx, CPU)):
        np.random.seed(2)
        models[name] = pkg.model.FeedForward.create(
            _mlp(pkg.sym), x, y, ctx=ctx, num_epoch=1, numpy_batch_size=8,
            initializer=pkg.init.Xavier(), learning_rate=0.1)
    ref, own = models["ref"], models["own"]
    for n, v in ref.arg_params.items():
        assert _rel(own.arg_params[n].asnumpy(), v.asnumpy()) <= TOL, n
    assert _rel(own.predict(x), ref.predict(x)) <= TOL
    assert own.score(x, y) == ref.score(x, y)
    own.save(str(tmp_path / "ff"), 1)
    back = tmx.model.FeedForward.load(str(tmp_path / "ff"), 1, ctx=CPU)
    np.testing.assert_array_equal(back.predict(x), own.predict(x))


def test_fit_callbacks_and_epoch_checkpoints(tmp_path, caplog):
    x, y = _data(n=16)
    prefix = str(tmp_path / "cb")
    seen = []
    with caplog.at_level(logging.INFO):
        np.random.seed(1)
        mod = tmx.mod.Module(_mlp(tmx.sym), context=CPU)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                batch_end_callback=[tmx.callback.Speedometer(4, 2),
                                    tmx.callback.log_train_metric(2),
                                    lambda p: seen.append(p.nbatch)],
                epoch_end_callback=[
                    tmx.callback.do_checkpoint(prefix),
                    tmx.callback.module_checkpoint(mod, prefix + "_mod")])
    assert seen == [0, 1, 2, 3] * 2
    assert "Speed" in caplog.text and "Train-accuracy" in caplog.text
    assert tmx.model.load_checkpoint(prefix + "_mod", 2, ctx=CPU)[1]
    sym, args, aux = tmx.model.load_checkpoint(prefix, 2, ctx=CPU)
    assert sorted(args) == ["fc1_bias", "fc1_weight", "fc2_bias",
                            "fc2_weight"]
    assert _rel(args["fc2_weight"].asnumpy(),
                _params(mod)["fc2_weight"]) == 0


def test_batchnorm_statistics_under_module_follow_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((8, 2, 6, 6)) * 2 + 1).astype("float32")
    y = rng.integers(0, 3, 8).astype("float32")
    ref, own = _fit_pair(_convbn, x, y, 4, 1)
    _assert_params_equal(own, ref)
    aux = own.get_params()[1]
    np.testing.assert_array_equal(aux["bn1_moving_mean"].asnumpy(),
                                  np.zeros(4, "float32"))
    np.testing.assert_array_equal(aux["bn1_moving_var"].asnumpy(),
                                  np.ones(4, "float32"))
    batch = tmx.io.DataBatch(data=[tmx.nd.array(x[:4], ctx=CPU)],
                             label=[tmx.nd.array(y[:4], ctx=CPU)])
    own.forward(batch, is_train=True)
    train = own.get_outputs()[0].asnumpy()
    own.forward(batch, is_train=False)
    np.testing.assert_array_equal(train, own.get_outputs()[0].asnumpy())


def _bucket_sym_gen(S):
    def sym_gen(key):
        data = S.var("data")
        net = S.FullyConnected(data, num_hidden=4, name="fc_shared")
        if key == 2:
            net = S.Activation(net, act_type="tanh", name="act")
        out = S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketing_module_shares_parameters():
    rng = np.random.default_rng(4)
    batches = [(k, rng.standard_normal((4, 6)).astype("float32"),
                rng.integers(0, 4, 4).astype("float32"))
               for k in (1, 2, 1, 2)]
    mods = {}
    for name, pkg, ctx in (("ref", mx, mx.cpu()), ("own", tmx, CPU)):
        np.random.seed(2)
        mod = pkg.mod.BucketingModule(_bucket_sym_gen(pkg.sym),
                                      default_bucket_key=1, context=ctx)
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(pkg.init.Xavier())
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.5),))
        outs = []
        for key, x, y in batches:
            batch = pkg.io.DataBatch(
                data=[pkg.nd.array(x, ctx=ctx)],
                label=[pkg.nd.array(y, ctx=ctx)], bucket_key=key,
                provide_data=[pkg.io.DataDesc("data", (4, 6))],
                provide_label=[pkg.io.DataDesc("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        mods[name] = (mod, outs)
    for got, want in zip(mods["own"][1], mods["ref"][1]):
        assert _rel(got, want) <= TOL
    _assert_params_equal(mods["own"][0], mods["ref"][0])


def test_sequential_module_trains_through_the_chain():
    rng = np.random.default_rng(5)
    x = rng.random((8, 4)).astype("float32")
    y = (x.sum(axis=1) > 2.0).astype("float32")
    mods = {}
    for name, pkg, ctx in (("ref", mx, mx.cpu()), ("own", tmx, CPU)):
        S = pkg.sym
        feat = S.Activation(S.FullyConnected(S.var("data"), num_hidden=16,
                                             name="fc_feat"),
                            act_type="relu", name="relu_feat")
        head = S.SoftmaxOutput(S.FullyConnected(S.var("feat_data"),
                                                num_hidden=2, name="fc_head"),
                               S.var("softmax_label"), name="softmax")
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(feat, data_names=("data",), label_names=(),
                               context=ctx))
        seq.add(pkg.mod.Module(head, data_names=("feat_data",),
                               label_names=("softmax_label",), context=ctx),
                take_labels=True)
        seq.bind(data_shapes=[("data", (8, 4))],
                 label_shapes=[("softmax_label", (8,))])
        np.random.seed(3)
        seq.init_params(pkg.init.Xavier())
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.05),))
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctx)],
                                 label=[pkg.nd.array(y, ctx=ctx)])
        for _ in range(3):
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
        seq.forward(batch, is_train=False)
        mods[name] = (seq, seq.get_outputs()[0].asnumpy())
    assert _rel(mods["own"][1], mods["ref"][1]) <= TOL
    _assert_params_equal(mods["own"][0], mods["ref"][0])


def test_python_module_compute():
    class Mean(tmx.mod.PythonModule):
        def compute(self, data, labels=None):
            return [data[0].mean(axis=1)]

    m = Mean(data_names=("data",), label_names=None)
    m.bind(data_shapes=[("data", (2, 3))])
    batch = tmx.io.DataBatch(
        data=[tmx.nd.array(np.arange(6, dtype="float32").reshape(2, 3),
                           ctx=CPU)], label=None)
    m.forward(batch)
    np.testing.assert_allclose(m.get_outputs()[0].asnumpy(), [1.0, 4.0])
    m.backward()
    assert m.get_input_grads()[0].shape == (2, 3)


def test_checkpoints_load_across_packages(tmp_path):
    x, y = _data(n=16)
    ref, own = _fit_pair(_mlp, x, y, 8, 1)
    ref.save_checkpoint(str(tmp_path / "ref"), 1)
    own.save_checkpoint(str(tmp_path / "own"), 1, save_optimizer_states=True)
    # each package's files through the other's load_checkpoint
    sym, args, aux = tmx.model.load_checkpoint(str(tmp_path / "ref"), 1,
                                               ctx=CPU)
    assert sym.tojson() == ref.symbol.tojson()
    for n, v in args.items():
        assert _rel(v.asnumpy(), _params(ref)[n]) == 0
    sym, args, aux = mx.model.load_checkpoint(str(tmp_path / "own"), 1)
    assert sym.list_arguments() == own.symbol.list_arguments()
    for n, v in args.items():
        assert _rel(v.asnumpy(), _params(own)[n]) == 0
    # Module.load -> predict gives the saved module's outputs bit for bit
    it = tmx.io.NDArrayIter(x, y, batch_size=8)
    want = own.predict(it).asnumpy()
    back = tmx.mod.Module.load(str(tmp_path / "own"), 1, context=CPU,
                               load_optimizer_states=True)
    back.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    np.testing.assert_array_equal(back.predict(it).asnumpy(), want)
    back.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    assert sorted(back._updater.states) == sorted(own._updater.states)
    from_ref = tmx.mod.Module.load(str(tmp_path / "ref"), 1, context=CPU)
    from_ref.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    assert _rel(from_ref.predict(it).asnumpy(),
                ref.predict(mx.io.NDArrayIter(x, y, batch_size=8))
                .asnumpy()) <= TOL


def test_print_summary_text_equals_reference():
    texts = []
    for pkg in (mx, tmx):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            pkg.viz.print_summary(_convbn(pkg.sym),
                                  shape={"data": (2, 2, 6, 6),
                                         "softmax_label": (2,)})
        texts.append(buf.getvalue())
    assert texts[1] == texts[0]
    assert "Total params: 105" in texts[1]
    with CPU:
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(4, in_units=3), tmx.gluon.nn.Dense(2))
        net.initialize()
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = tmx.viz.block_summary(net, tmx.nd.zeros((1, 3)))
    assert total == 3 * 4 + 4 + 4 * 2 + 2
    assert "Total params: 26" in buf.getvalue()
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tmx.viz.plot_network(_convbn(tmx.sym))
    else:
        dot = tmx.viz.plot_network(_convbn(tmx.sym))
        assert dot.source.count("->") == 6      # data -> conv1 -> ... -> softmax


def test_multi_device_and_dist_stores_raise(monkeypatch):
    # a list of contexts is data parallelism (item 10a): two contexts
    # through a local store end where one context ends, and where the
    # reference's two-context Module ends
    x, y = _data(n=24)
    mods = {}
    for name, pkg, ctx in (("ref", mx, [mx.cpu(0), mx.cpu(1)]),
                           ("one", tmx, CPU),
                           ("two", tmx, [tmx.cpu(0), tmx.cpu(1)])):
        np.random.seed(1)
        mod = pkg.mod.Module(_mlp(pkg.sym), context=ctx)
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                initializer=pkg.init.Xavier(), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        mods[name] = mod
    assert len(mods["two"]._execs) == 2
    assert mods["two"].get_outputs()[0].shape == (8, 4)
    assert len(mods["two"].get_outputs(merge_multi_context=False)[0]) == 2
    _assert_params_equal(mods["two"], mods["one"], tol=1e-6)
    _assert_params_equal(mods["two"], mods["ref"])
    # group2ctx binds (this graph has no ctx_group: nothing is placed)
    ex = _mlp(tmx.sym).simple_bind(CPU, group2ctx={"dev1": tmx.cpu(1)},
                                   data=(4, 10), softmax_label=(4,))
    assert ex._placement == {}
    # the control-flow trio is ported (item 8, step 2): the NDArray functions
    assert tmx.sym.contrib.foreach is tmx.nd.contrib.foreach
    mod = tmx.mod.Module(_mlp(tmx.sym), context=CPU)
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    # one process is a world of one (several: tests/test_torch_dist.py)
    mod.init_optimizer(kvstore="dist_sync", force_init=True)
    assert mod._kvstore.type == "dist_sync" and \
        mod._kvstore.num_workers == 1
    mod.init_optimizer(kvstore="nccl", force_init=True)
    assert mod._kvstore is None         # one device: no store to sum in
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    with pytest.raises(MXNetError, match="parallel.initialize"):
        mod.init_optimizer(kvstore="dist_sync", force_init=True)
    monkeypatch.delenv("DMLC_NUM_WORKER")
    mod.init_optimizer(kvstore="device")
    assert mod._optimizer.rescale_grad == 0.25
