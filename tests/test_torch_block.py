"""The port's ``gluon.Block``/``HybridBlock``, ``Parameter`` and
``CachedOp`` against the JAX package.

- A user ``HybridBlock`` written once (``SRC``) and run in both packages,
  with a deferred-shape parameter and a child block: ``collect_params``
  names and order, ``initialize(Xavier())`` bit for bit after the same
  seed, the forward and its gradients at 1e-5 (fp32, sums in another
  order), hybridized equal to eager bit for bit (on the CPU a CachedOp
  runs the same function), ``cast``, ``Constant``, and
  ``save_parameters``/``load_parameters`` bytes both ways.
- ``cache_stats`` hits, misses and LRU evictions under
  ``MXNET_CACHED_OP_CAPACITY``, and a signature recorded under
  ``autograd.record()``.
- ``nd._contrib_dot_product_attention`` in both layouts, with and without
  a key mask, causal or not: the forward and the gradients of q, k and v
  at 1e-5.
- ``bert_tiny`` and a 2-layer ``TransformerLM`` as ``HybridBlock``s over
  the reference's weights, hybridized, called with NDArrays: outputs at
  1e-4 (as ``tests/test_torch_bert.py``: two layers of sums in another
  order), their parameter names, and ``save_parameters`` read by the
  reference's ``load_parameters`` (BERT's structural layer names).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import transformer as jtrans
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import cached_op
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.cached_op import cache_stats, reset_cache_stats
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import transformer as ttrans

torch.set_num_threads(1)
TOL = 1e-5
MODEL_TOL = 1e-4

SRC = '''
class Inner(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.w = self.params.get("weight", shape=(3, 4))

    def hybrid_forward(self, F, x, w):
        return F.dot(x, w.T)


class Net(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(4, 0),
                                          allow_deferred_init=True)
            self.bias = self.params.get("bias", shape=(4,), init="zeros")
            self.inner = Inner()

    def infer_shape(self, x):
        self.weight.shape = (4, x.shape[1])

    def hybrid_forward(self, F, x, weight, bias):
        h = F.FullyConnected(x, weight, bias, num_hidden=4)
        return F.tanh(self.inner(F.LeakyReLU(h, act_type="gelu")))
'''


def _make(gluon):
    ns = {"gluon": gluon}
    exec(SRC, ns)
    return ns["Net"](prefix="usernet_")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _x(seed=0, shape=(5, 6)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _pair(x=None):
    """Both nets initialized from the same seed; the deferred weight is
    drawn at the first call, which follows each package's initialize."""
    x = _x() if x is None else x
    mx.random.seed(3)
    jnet = _make(jgluon)
    jnet.initialize(mx.init.Xavier())
    jnet(jnd.array(x))
    trandom.seed(3)
    tnet = _make(tgluon)
    tnet.initialize(tinit.Xavier())
    tnet(tnd.array(x))
    return jnet, tnet


def test_user_block_names_init_forward_and_grads():
    jnet, tnet = _pair()
    x = _x()
    ref = jnet(jnd.array(x))
    own = tnet(tnd.array(x))
    assert list(tnet.collect_params()) == list(jnet.collect_params()) == [
        "usernet_weight", "usernet_bias", "usernet_inner0_weight"]
    for (k, jp), tp in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jp.data().asnumpy(), err_msg=k)
    np.testing.assert_allclose(own.asnumpy(), ref.asnumpy(), atol=TOL,
                               rtol=TOL)
    assert list(tnet.collect_params(".*inner.*")) == \
        list(jnet.collect_params(".*inner.*"))
    grads = []
    for net, F, ag in ((jnet, jnd, jag), (tnet, tnd, tag)):
        with ag.record():
            loss = (net(F.array(x)) ** 2).sum()
        loss.backward()
        grads.append([p.grad().asnumpy()
                      for p in net.collect_params().values()])
    for own_g, ref_g in zip(grads[1], grads[0]):
        np.testing.assert_allclose(own_g, ref_g, atol=TOL, rtol=TOL)
    # the block is a torch module whose parameters are its tensors
    assert [n for n, _ in tnet.named_parameters()] == [
        "weight", "bias", "inner.w"]


def test_hybridized_equals_eager():
    _, tnet = _pair()
    x = tnd.array(_x(1))
    eager = tnet(x).asnumpy()
    tnet.hybridize()
    for _ in range(2):
        np.testing.assert_array_equal(tnet(x).asnumpy(), eager)
    op = next(iter(tnet._cached_ops.values()))
    assert op.cache_stats()["misses"] == 1 and \
        op.cache_stats()["hits"] == 1
    with tag.record():
        y = tnet(x)
    y.backward()
    assert op.cache_stats()["misses"] == 2     # train mode: a new signature
    assert float(tnet.weight.grad().abs().sum().asscalar()) > 0


def test_cache_stats_and_lru_evictions(monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_OP_CAPACITY", "2")
    _, tnet = _pair()
    tnet.hybridize()
    reset_cache_stats()
    for n in (1, 2, 3, 3, 1):
        tnet(tnd.array(_x(n, (n, 6))))
    op = next(iter(tnet._cached_ops.values()))
    st = op.cache_stats()
    assert (st["misses"], st["hits"], st["evictions"], st["size"],
            st["capacity"]) == (4, 1, 2, 2, 2)
    assert cache_stats() == {"hits": 1, "misses": 4, "evictions": 2}
    tnet.cast("float16")
    assert tnet._cached_ops == {}
    assert tnet.weight.data().dtype == np.float16


def test_a_storage_rebind_bumps_the_graph_epoch():
    """What gives a parameter new storage bumps the count at which every
    CachedOp drops its captured graphs (held on the card by
    ``tests/test_torch_cached_op_cuda.py``); what keeps the storage does
    not."""
    _, tnet = _pair()
    weight = tnet.collect_params()["usernet_weight"]

    def bumps(change):
        before = cached_op._STORAGE_EPOCH[0]
        change()
        return cached_op._STORAGE_EPOCH[0] - before

    assert bumps(lambda: weight.cast("float32")) == 0     # its own dtype
    assert bumps(lambda: weight.reset_ctx(tmx.cpu())) == 0
    assert bumps(lambda: weight.set_data(weight.data() * 2)) == 0
    assert bumps(lambda: weight.cast("float16")) == 1
    assert bumps(lambda: tnet.collect_params().reset_ctx(
        [tmx.cpu(0), tmx.cpu(1)])) == 3                  # new copies
    assert bumps(lambda: tnet.to(torch.float64)) >= 1
    assert weight.tensor().dtype == torch.float64


def test_save_and_load_parameters_across_packages(tmp_path):
    jnet, tnet = _pair()
    x = _x(2)
    tnet.save_parameters(str(tmp_path / "own.params"))
    jnet.save_parameters(str(tmp_path / "ref.params"))
    assert (tmp_path / "own.params").read_bytes() == \
        (tmp_path / "ref.params").read_bytes()
    for p in tnet.collect_params().values():
        p.set_data(p.data() * 0)
    tnet.load_parameters(str(tmp_path / "ref.params"))
    for (k, jp), tp in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jp.data().asnumpy(), err_msg=k)
    jnet2 = _make(jgluon)
    jnet2.load_parameters(str(tmp_path / "own.params"))
    np.testing.assert_allclose(jnet2(jnd.array(x)).asnumpy(),
                               tnet(tnd.array(x)).asnumpy(), atol=TOL,
                               rtol=TOL)
    with pytest.raises(AssertionError, match="incompatible"):
        tgluon.nn.Dense(2, 3, device="cpu").load_parameters(
            str(tmp_path / "ref.params"))


def test_constant_and_parameter_lifecycle():
    for gluon, F in ((jgluon, jnd), (tgluon, tnd)):
        c = gluon.Constant("const", np.arange(3.0))
        c.initialize()
        np.testing.assert_array_equal(c.data().asnumpy(), [0.0, 1.0, 2.0])
        assert c.data().dtype == np.float32
        assert c.grad_req == "null"
        p = gluon.Parameter("p_weight", shape=(2, 0),
                            allow_deferred_init=True)
        p.initialize(mx.init.One() if F is jnd else tinit.One())
        with pytest.raises(gluon.DeferredInitializationError):
            p.data()
        p.shape = (2, 3)
        p._finish_deferred_init()
        np.testing.assert_array_equal(p.data().asnumpy(), np.ones((2, 3)))
        assert p.list_grad()[0].shape == (2, 3)
    p.reset_ctx(tmx.cpu())
    assert p.list_ctx() == [tmx.cpu()]


@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_contrib_attention_op(layout, masked, causal):
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 8, 2, 4
    shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
    q, k, v = (rng.standard_normal(shape).astype("float32")
               for _ in range(3))
    mask = (np.arange(S)[None] < np.array([[S], [5]])).astype("float32") \
        .reshape(B, 1, 1, S) if masked else None
    out = []
    for F, ag in ((jnd, jag), (tnd, tag)):
        qs = [F.array(a) for a in (q, k, v)]
        for a in qs:
            a.attach_grad()
        with ag.record():
            o = F._contrib_dot_product_attention(
                *qs, mask=None if mask is None else F.array(mask),
                causal=causal, layout=layout)
            loss = (o * o).sum()
        loss.backward()
        out.append([o] + [a.grad for a in qs])
    for own, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(own.asnumpy(), ref.asnumpy(), atol=TOL,
                                   rtol=TOL)


def _bert_pair():
    mx.random.seed(0)
    jnet = jbert.bert_tiny(vocab_size=50, max_length=16)
    jnet.initialize(mx.init.Xavier())
    tnet = tbert.bert_tiny(vocab_size=50, max_length=16, device="cpu")
    convert.load_mxnet_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    return jnet, tnet


def test_bert_hybridized_matches_reference(tmp_path):
    jnet, tnet = _bert_pair()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 50, (3, 16)).astype("float32")
    segments = np.zeros((3, 16), "float32")
    lens = np.array([16, 9, 4], "float32")
    ref = jnet(jnd.array(tokens), jnd.array(segments), jnd.array(lens))
    tnet.hybridize()
    with tag.predict_mode():
        own = tnet(tnd.array(tokens), tnd.array(segments), tnd.array(lens))
        again = tnet(tnd.array(tokens), tnd.array(segments),
                     tnd.array(lens))
    for o, a, r in zip(own, again, ref):
        np.testing.assert_allclose(o.asnumpy(), r.asnumpy(),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        np.testing.assert_array_equal(a.asnumpy(), o.asnumpy())
    strip = [k[len(tnet.prefix):] for k in tnet.collect_params()]
    assert strip == [k[len(jnet.prefix):] for k in jnet.collect_params()]
    tnet.save_parameters(str(tmp_path / "bert.params"))
    jnet2 = jbert.bert_tiny(vocab_size=50, max_length=16)
    jnet2.load_parameters(str(tmp_path / "bert.params"))
    for (k, a), b in zip(jnet.collect_params().items(),
                         jnet2.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(),
                                      b.data().asnumpy(), err_msg=k)
    jnet.save_parameters(str(tmp_path / "ref.params"))
    tnet2 = tbert.bert_tiny(vocab_size=50, max_length=16, device="cpu")
    tnet2.load_parameters(str(tmp_path / "ref.params"))
    for a, b in zip(tnet.parameters(), tnet2.parameters()):
        assert torch.equal(a, b)


def test_transformer_lm_hybridized_matches_reference():
    mx.random.seed(1)
    jnet = jtrans.TransformerLM(40, units=32, num_layers=2, num_heads=2,
                                max_len=16)
    jnet.initialize(mx.init.Xavier())
    tnet = ttrans.TransformerLM(40, units=32, num_layers=2, num_heads=2,
                                max_len=16, device="cpu")
    convert.load_mxnet_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    x = np.random.default_rng(2).integers(0, 40, (2, 16)).astype("int32")
    ref = jnet(jnd.array(x))
    tnet.hybridize()
    own = tnet(tnd.array(x))
    np.testing.assert_allclose(own.asnumpy(), ref.asnumpy(),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    # the Gluon loop over NDArrays: gradients into the module's tensors
    with tag.record():
        loss = tnd.log_softmax(tnet(tnd.array(x)), axis=-1).mean()
    loss.backward()
    assert all(p.grad is not None for p in tnet.parameters())
