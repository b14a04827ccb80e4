"""The symbolic frontend on a card. Every test here is marked ``cuda`` and
skips where no CUDA device is present; the module imports neither JAX
nor the JAX package (the CPU side is held to the reference in
``tests/test_torch_symbol.py``, ``test_torch_module.py`` and
``test_torch_export.py``):

    python -m pytest --noconftest -q tests/test_torch_symbol_cuda.py

- An executor's inference forward (its ``CachedOp``: a CUDA graph)
  equals the eager forward of the same graph bit for bit, one graph a
  signature, and a fed batch of another size captures a second graph.
- A small conv + BatchNorm net's ``Module`` step (SGD, momentum) on the
  card equals the same step on the CPU within 1e-5 of each weight's
  largest |value| (TF32 off; sums in another order).
- ``sym._contrib_dot_product_attention`` (BHSD, causal) through an
  executor launches the flash forward, dQ and dK/dV kernels once each a
  training call, and its output and gradients match the plain path
  (``MXNET_FLASH_ATTENTION=0``) within 2e-4 (fp32) / 2e-2 (bf16) of their
  max.
- A zoo net's ``SymbolBlock`` on the card: the imported forward equals
  the original's bit for bit, and its hybridized replay its eager one;
  ``InferenceEngine.load`` serves the files.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.symbol.symbol import evaluate_graph

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx.gpu(0)


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _convnet(S=mx.sym):
    data = S.var("data")
    net = S.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    net = S.BatchNorm(net, fix_gamma=False, name="bn1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg",
                    name="pool1")
    net = S.FullyConnected(net, num_hidden=5, name="fc1")
    return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")


@pytest.mark.cuda
def test_executor_inference_replay_equals_eager(card):
    ex = _convnet().simple_bind(card, grad_req="null", data=(4, 3, 16, 16),
                                softmax_label=(4,))
    rng = np.random.default_rng(0)
    for n, a in ex.arg_dict.items():
        a[:] = rng.standard_normal(a.shape).astype("float32")
    for n, a in ex.aux_dict.items():
        a[:] = rng.random(a.shape).astype("float32") + 0.5
    x = nd.array(rng.standard_normal((4, 3, 16, 16)).astype("float32"),
                 ctx=card)
    ex.forward(data=x)                           # the capture
    replay = ex.forward(data=x)[0]._data
    with torch.no_grad():
        eager = evaluate_graph(ex._symbol, ex._bindings())[0]
    assert torch.equal(replay, eager)
    op = next(iter(ex._cached_ops.values()))
    assert op.cache_stats()["graphs"] == 1
    wide = ex.reshape(data=(8, 3, 16, 16), softmax_label=(8,))
    x8 = nd.array(rng.standard_normal((8, 3, 16, 16)).astype("float32"),
                  ctx=card)
    wide.forward(data=x8)
    out = wide.forward(data=x8)[0]._data
    with torch.no_grad():
        assert torch.equal(out, evaluate_graph(wide._symbol,
                                               wide._bindings())[0])


def _module_step(ctx, x, y, seed):
    np.random.seed(seed)
    m = mx.mod.Module(_convnet(), context=ctx)
    m.bind(data_shapes=[("data", x.shape)],
           label_shapes=[("softmax_label", y.shape)])
    m.init_params(mx.init.Xavier())
    m.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    batch = mx.io.DataBatch(data=[nd.array(x, ctx=ctx)],
                            label=[nd.array(y, ctx=ctx)])
    for _ in range(2):
        m.forward_backward(batch)
        m.update()
    return {n: a._data for n, a in m.get_params()[0].items()}


@pytest.mark.cuda
def test_module_step_on_card_equals_cpu(card):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 3, 16, 16)).astype("float32")
    y = rng.integers(0, 5, 8).astype("float32")
    on_card = _module_step(card, x, y, 3)
    on_cpu = _module_step(mx.cpu(), x, y, 3)
    assert sorted(on_card) == sorted(on_cpu)
    for n in on_cpu:
        assert on_card[n].is_cuda
        assert _rel(on_card[n], on_cpu[n]) <= 1e-5, n


def _launches():
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_symbol_launches_the_kernels(card, dtype):
    B, H, S, D = 2, 2, 128, 64
    att = mx.sym._contrib_dot_product_attention(
        mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v"), causal=True)
    ex = att.simple_bind(card, type_dict=dict.fromkeys("qkv", dtype),
                         q=(B, H, S, D), k=(B, H, S, D), v=(B, H, S, D))
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .to(dt) for _ in range(4))

    def run():
        ex.forward(is_train=True, q=nd.NDArray(q), k=nd.NDArray(k),
                   v=nd.NDArray(v))
        ex.backward([nd.NDArray(do)])
        return [ex.outputs[0]._data.clone()] + [
            ex.grad_dict[n]._data.clone() for n in "qkv"]

    before = _launches()
    got = run()
    assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1]
    os.environ["MXNET_FLASH_ATTENTION"] = "0"
    try:
        before = _launches()
        ref = run()
        assert _launches() == before
    finally:
        del os.environ["MXNET_FLASH_ATTENTION"]
    tol = 2e-4 if dtype == "float32" else 2e-2
    for a, r in zip(got, ref):
        assert a.dtype == dt
        assert _rel(a, r) <= tol


@pytest.mark.cuda
def test_symbolblock_and_engine_on_card(card, tmp_path):
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.serving import InferenceEngine
    x = torch.rand((4, 3, 64, 64), generator=torch.Generator()
                   .manual_seed(2)).to("cuda")
    with card:
        net = vision.resnet18_v1(classes=10)
        net.initialize(mx.init.Xavier())
        xn = nd.NDArray(x)
        with autograd.predict_mode():
            want = net(xn)._data
    files = net.export(str(tmp_path / "r18"))
    block = SymbolBlock.imports(files[0], ["data"], files[1], ctx=card)
    with autograd.predict_mode():
        eager = block(xn)._data
        assert torch.equal(eager, want)
        block.hybridize()
        block(xn)
        assert torch.equal(block(xn)._data, eager)
    engine = InferenceEngine.load(str(tmp_path / "r18"), ctx=card,
                                  buckets=(4,))
    assert torch.equal(engine.predict(xn)._data, want)
