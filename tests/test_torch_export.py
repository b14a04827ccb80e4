"""``HybridBlock.export``, ``SymbolBlock`` and ``InferenceEngine.load`` of
the port against the JAX package's, on the CPU.

- The port's ``resnet18_v1(classes=10)``, shapes settled at (2, 3, 32,
  32), exports the graph the reference's net exports with the same
  parameters: the same nodes in the same order (op, attrs, constant
  inputs, aux marks), ``arg_nodes`` and ``heads``, and the same
  ``arg:``/``aux:`` arrays bit for bit.
- Across packages: the reference's ``SymbolBlock.imports`` of the port's
  files gives the reference net's output (its own files' SymbolBlock,
  hybridized: one XLA program each) within 1e-6 of its max, and the
  port's ``SymbolBlock.imports`` of the reference's files gives the port
  net's output bit for bit (the same op functions in the same order) and
  the reference's within 1e-4 (float32, sums in another order).
- A user ``HybridBlock`` (``self.params.get``, ``hybrid_forward(F, ...)``
  with arithmetic and a scalar op) exports the reference's graph, and each
  package's files give the other's outputs.
- ``SymbolBlock``: hybridized replay equal to eager; fine-tuning under
  ``autograd.record()`` gives every parameter the original net's gradient
  bit for bit; a trainer step, a re-export and a re-import give the
  fine-tuned outputs; ``cast("bfloat16")`` keeps the BatchNorm inputs
  float32 and equals the original's bf16 forward bit for bit.
- ``InferenceEngine.load`` of the files serves ``predict`` (bit for bit
  the net's output at the same batch) and ``/predict`` through
  ``ModelServer`` (one row, bucket 1: within 1e-5 of its max).
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, initializer, nd, random as trandom
from mxnet_tpu_torch.gluon import SymbolBlock, Trainer
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.serving import InferenceEngine, ModelServer

CPU = tmx.cpu()


@pytest.fixture(autouse=True, scope="module")
def _reference_compiles_unoptimized():
    """The reference compiles one XLA program per hybridized signature;
    without XLA's optimizations that costs less and leaves the values
    within these tolerances. Restored, and the programs dropped, after
    the module."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _graph(path):
    """The exported graph without its names (auto-names count per
    process): nodes, arg_nodes and heads."""
    d = json.load(open(path))
    nodes = [(n["op"], n["inputs"], n.get("attrs"), n.get("const_inputs"),
              n.get("node_attrs")) for n in d["nodes"]]
    return nodes, d["arg_nodes"], d["heads"]


@pytest.fixture(scope="module")
def resnet18(tmp_path_factory):
    """The port's net (Xavier, eval-mode output on x) and its files; the
    reference's net given the same values, and its files."""
    tmp = tmp_path_factory.mktemp("export")
    x = np.random.default_rng(1).random((2, 3, 32, 32)).astype("float32")
    trandom.seed(0)
    with CPU:
        port = tvision.resnet18_v1(classes=10)
        port.initialize(initializer.Xavier())
        got = port(nd.array(x)).asnumpy()
    port_files = port.export(str(tmp / "port"))
    # the reference's net under the port's prefix: block prefixes count per
    # process and package, and other test files make resnets too
    ref = jvision.resnet18_v1(classes=10, prefix=port.prefix)
    ref.initialize()
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        p.set_data(mx.nd.array(q.data().asnumpy()))
        p._finish_deferred_init()
    ref_files = ref.export(str(tmp / "ref"))
    return x, port, got, port_files, ref_files


def test_resnet18_graph_and_params_equal_reference(resnet18):
    _, _, _, port_files, ref_files = resnet18
    assert _graph(port_files[0]) == _graph(ref_files[0])
    ops = [n[0] for n in _graph(port_files[0])[0]]
    assert {k: ops.count(k) for k in set(ops)} == {
        "null": 103, "Convolution": 20, "BatchNorm": 20, "Activation": 17,
        "add": 8, "Pooling": 2, "FullyConnected": 1}
    own, ref = tmx.nd.load(port_files[1], ctx=CPU), mx.nd.load(ref_files[1])
    assert list(own) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(own[k].asnumpy(), ref[k].asnumpy(),
                                      err_msg=k)


def test_files_cross_between_packages(resnet18):
    x, _, got, port_files, ref_files = resnet18
    outs = []
    for files in (ref_files, port_files):
        block = mx.gluon.SymbolBlock.imports(files[0], ["data"], files[1])
        block.hybridize()
        outs.append(block(mx.nd.array(x)).asnumpy())
    want, cross = outs
    assert _rel(cross, want) <= 1e-6
    own = SymbolBlock.imports(ref_files[0], ["data"], ref_files[1], ctx=CPU)
    with CPU:
        mine = own(nd.array(x)).asnumpy()
    np.testing.assert_array_equal(mine, got)
    assert _rel(mine, want) <= 1e-4


class _UserBlock:
    """The same user block body for both packages' ``HybridBlock``."""

    @staticmethod
    def make(pkg):
        class Net(pkg.gluon.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.weight = self.params.get("weight", shape=(5, 4))
                    self.bias = self.params.get("bias", shape=(5,))

            def hybrid_forward(self, F, x, weight, bias):
                h = F.FullyConnected(x, weight, bias, num_hidden=5)
                h = F.Activation(h, act_type="tanh")
                return h * 2.0 + F.sigmoid(h)
        return Net(prefix="user_")


def test_user_hybrid_forward_block_exports_and_imports(tmp_path):
    x = np.random.default_rng(2).standard_normal((3, 4)).astype("float32")
    np.random.seed(5)
    ref = _UserBlock.make(mx)
    ref.initialize(mx.init.Xavier())
    want = ref(mx.nd.array(x)).asnumpy()
    own = _UserBlock.make(tmx)
    own.initialize(initializer.Xavier(), ctx=CPU)
    for p, q in zip(ref.collect_params().values(),
                    own.collect_params().values()):
        q.set_data(tmx.nd.array(p.data().asnumpy(), ctx=CPU))
    got = own(nd.array(x, ctx=CPU)).asnumpy()
    assert _rel(got, want) <= 1e-6
    ref_files = ref.export(str(tmp_path / "ref"))
    own_files = own.export(str(tmp_path / "own"))
    assert _graph(own_files[0]) == _graph(ref_files[0])
    back_ref = mx.gluon.SymbolBlock.imports(own_files[0], "data",
                                            own_files[1])
    back_own = SymbolBlock.imports(ref_files[0], "data", ref_files[1],
                                   ctx=CPU)
    assert _rel(back_ref(mx.nd.array(x)).asnumpy(), want) <= 1e-6
    assert _rel(back_own(nd.array(x, ctx=CPU)).asnumpy(), want) <= 1e-6


def test_symbolblock_hybridizes_finetunes_and_reexports(resnet18, tmp_path):
    x, port, got, port_files, _ = resnet18
    block = SymbolBlock.imports(port_files[0], ["data"], port_files[1],
                                ctx=CPU)
    with CPU:
        eager = block(nd.array(x)).asnumpy()
        block.hybridize()
        np.testing.assert_array_equal(block(nd.array(x)).asnumpy(), eager)
    np.testing.assert_array_equal(eager, got)
    # the same training step's gradients, parameter by parameter
    label = nd.array(np.array([1, 7], "float32"), ctx=CPU)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    grads = []
    for net in (port, block):
        with autograd.record():
            loss = loss_fn(net(nd.array(x, ctx=CPU)), label)
        loss.backward()
        grads.append({n: p.grad().asnumpy()
                      for n, p in net.collect_params().items()
                      if p.grad_req != "null"})
    assert sorted(grads[0]) == sorted(grads[1])
    for n in grads[0]:
        np.testing.assert_array_equal(grads[1][n], grads[0][n], err_msg=n)
    # batch statistics of 2 rows at 1x1 make these gradients large
    Trainer(block.collect_params(), "sgd", {"learning_rate": 1e-5}).step(2)
    with CPU:
        tuned = block(nd.array(x)).asnumpy()
    assert np.abs(tuned - eager).max() > 0
    files = block.export(str(tmp_path / "tuned"))
    again = SymbolBlock.imports(files[0], ["data"], files[1], ctx=CPU)
    with CPU:
        np.testing.assert_array_equal(again(nd.array(x)).asnumpy(), tuned)


def test_symbolblock_bfloat16_keeps_batchnorm_float32(resnet18):
    x, _, _, port_files, _ = resnet18
    trandom.seed(0)
    with CPU:
        net = tvision.resnet18_v1(classes=10)
        net.initialize(initializer.Xavier())
        net(nd.array(x))
    files = net.export(port_files[0][:-len("-symbol.json")] + "_bf16")
    block = SymbolBlock.imports(files[0], ["data"], files[1], ctx=CPU)
    net.cast("bfloat16")
    block.cast("bfloat16")
    kept = {n for n, p in block.collect_params().items()
            if p.dtype == torch.float32}
    assert kept and all("batchnorm" in n for n in kept)
    assert len(kept) == 4 * 20
    xb = torch.from_numpy(x).bfloat16()
    with CPU:
        want = net(nd.array(xb))
        got = block(nd.array(xb))
    assert got._data.dtype == torch.bfloat16
    assert torch.equal(got._data, want._data)


def test_inference_engine_load_serves_predict(resnet18):
    x, _, want, port_files, _ = resnet18
    prefix = port_files[0][:-len("-symbol.json")]
    engine = InferenceEngine.load(prefix, ctx=CPU, buckets=(1, 2, 4))
    np.testing.assert_array_equal(engine.predict(x).asnumpy(), want)
    srv = ModelServer(engine, port=0).start()
    try:
        body = json.dumps({"data": x[0].tolist()}).encode()
        req = urllib.request.Request(srv.url + "/predict", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        reply = json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        srv.stop()
    # one row runs at batch 1, whose convolutions sum in another order
    assert _rel(np.asarray(reply["output"], "float32"), want[:1]) <= 1e-5
    assert engine.stats()["buckets_seen"] == [1, 2]
