"""The RNN family on a card: the cuDNN path against the plain per-step
path, the card as the default context, and ``CachedOp`` replays.

Every test here is marked ``cuda`` and skips where no CUDA device is
present; the module imports neither JAX nor the JAX package (the plain
path is held to the reference on the CPU in ``tests/test_torch_rnn.py``):

    python -m pytest --noconftest -q tests/test_torch_rnn_cuda.py

Every mode (LSTM, GRU, Elman tanh and relu), uni- and bidirectional, one
and two layers: the outputs, the new states and every gradient (input,
initial states, each parameter) of the cuDNN path within ``OUT_TOL`` and
``GRAD_TOL`` (1e-4 of each one's largest |value|) of the plain path on
the same card in float32, TF32 off. cuDNN's cell kernels take their own
sigmoid and tanh, and over 12 steps the outputs drift 1.1e-5 to 2.6e-5
of their max from the plain path's torch ops on the H100 (while the
full-width LM's loss agrees to 1e-5 in ``chip_smoke.py``). In
bfloat16 both paths are held against float32 on float32 copies of the
same bf16 values: the cuDNN path's distance at most ``BF16_FACTOR`` (2x)
the plain path's for the same output or gradient (the plain distance
floored at ``BF16_FLOOR``, 2^-8), each distance the norm of the
difference over the norm of the float32 value. The largest element's
distance is too noisy a measure there: bf16 Elman
relu gradients lie 8–31% of their max from float32 on either path, and
that ratio ran 0.25–1.66 over 16 draws on the H100 (above 2 in one
more), the norm's 0.54–1.37. Weights come from ``random.seed``. ``begin_state``, ``nd.zeros`` and the ``Estimator`` take
the card by default; a hybridized ``LSTM`` and ``RNNModel`` replay
(``CachedOp``, a CUDA graph) equal eager bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.ops import rnn as orn

torch.set_num_threads(1)
OUT_TOL, GRAD_TOL = 1e-4, 1e-4
BF16_FACTOR, BF16_FLOOR = 2.0, 2.0 ** -8
T, B, I, H = 12, 16, 48, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _norm_rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _layer(mode, bidir, layers):
    kw = dict(bidirectional=bidir, input_size=I)
    if mode == "lstm":
        return gluon.rnn.LSTM(H, layers, **kw)
    if mode == "gru":
        return gluon.rnn.GRU(H, layers, **kw)
    return gluon.rnn.RNN(H, layers, activation=mode[4:], **kw)


def _run(layer, x, states, dtype, plain):
    """Outputs and gradients of ``sum(out * cot) + sum(states^2)`` over
    copies in ``dtype``; the path forced plain or left to the card."""
    import contextlib
    from torch.func import functional_call
    vals = {n: p.detach().to(dtype).clone().requires_grad_()
            for n, p in layer.named_parameters()}
    xs = x.detach().to(dtype).clone().requires_grad_()
    st = [s.detach().to(dtype).clone().requires_grad_() for s in states]
    g = torch.Generator(device=x.device).manual_seed(3)
    with orn.force_plain() if plain else contextlib.nullcontext():
        out, new = functional_call(layer, vals, (xs, st))
    cot = torch.randn(out.shape, generator=g, device=x.device).to(dtype)
    loss = (out * cot).float().sum() + sum((s.float() ** 2).sum()
                                           for s in new)
    loss.backward()
    grads = [xs.grad, *[s.grad for s in st], *[v.grad for v in vals.values()]]
    return [out, *new], grads


def _inputs(cuda, mode, bidir, layers, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    D = 2 if bidir else 1
    x = torch.randn(T, B, I, generator=g, device=cuda)
    states = [torch.randn(layers * D, B, H, generator=g, device=cuda) * 0.5
              for _ in range(2 if mode == "lstm" else 1)]
    return x, states


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_cudnn_against_plain_fp32(cuda, mode, bidir, layers):
    mx.random.seed(0)
    with mx.gpu():
        layer = _layer(mode, bidir, layers)
        layer.initialize(mx.init.Xavier())
    x, states = _inputs(cuda, mode, bidir, layers)
    before = orn.path_counts()
    outs_c, grads_c = _run(layer, x, states, torch.float32, False)
    outs_p, grads_p = _run(layer, x, states, torch.float32, True)
    took = {k: v - before[k] for k, v in orn.path_counts().items()}
    D = 2 if bidir else 1
    assert took == {"cudnn": layers * D, "native": 0, "plain": layers * D}
    out_err = [_rel(c, p) for c, p in zip(outs_c, outs_p)]
    grad_err = [_rel(c, p) for c, p in zip(grads_c, grads_p)]
    assert max(out_err) <= OUT_TOL and max(grad_err) <= GRAD_TOL, \
        (out_err, grad_err)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
def test_cudnn_against_plain_bf16(cuda, mode, bidir):
    mx.random.seed(0)
    with mx.gpu():
        layer = _layer(mode, bidir, 2)
        layer.initialize(mx.init.Xavier())
    x, states = _inputs(cuda, mode, bidir, 2, seed=1)
    x = x.bfloat16().float()
    states = [s.bfloat16().float() for s in states]
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(p.bfloat16().float())
    truth_o, truth_g = _run(layer, x, states, torch.float32, True)
    card_o, card_g = _run(layer, x, states, torch.bfloat16, False)
    plain_o, plain_g = _run(layer, x, states, torch.bfloat16, True)
    assert card_o[0].dtype == torch.bfloat16
    for what, card, plain, truth in (("out", card_o, plain_o, truth_o),
                                     ("grad", card_g, plain_g, truth_g)):
        for i, (c, p, t) in enumerate(zip(card, plain, truth)):
            dc, dp = _norm_rel(c, t), _norm_rel(p, t)
            assert dc <= BF16_FACTOR * max(dp, BF16_FLOOR), (what, i, dc, dp)


@pytest.mark.cuda
def test_the_card_is_the_default(cuda):
    layer = gluon.rnn.LSTM(H, 2, input_size=I)
    assert all(s.ctx.device_type == "gpu" for s in layer.begin_state(4))
    cell = gluon.rnn.GRUCell(H, input_size=I)
    assert cell.begin_state(4)[0]._data.is_cuda
    assert nd.zeros((2, 3))._data.is_cuda
    layer.initialize()
    assert layer.l0_i2h_weight.data()._data.is_cuda
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    est = Estimator(layer, gluon.loss.L2Loss())
    assert est.context == [mx.gpu(0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybridized_lstm_replay_equals_eager(cuda, dtype):
    layer = gluon.rnn.LSTM(H, 2, input_size=I, bidirectional=True)
    layer.initialize()
    layer.cast(dtype)
    x, states = _inputs(cuda, "lstm", True, 2)
    x = nd.NDArray(x.to(getattr(torch, dtype)))
    states = [nd.NDArray(s.to(getattr(torch, dtype))) for s in states]
    with autograd.predict_mode():
        eager_out, eager_st = layer(x, states)
        layer.hybridize()
        for _ in range(3):
            out, st = layer(x, states)
            assert torch.equal(out._data, eager_out._data)
            for a, b in zip(st, eager_st):
                assert torch.equal(a._data, b._data)
    cache = next(iter(layer._cached_ops.values())).cache_stats()
    assert cache["graphs"] == 1 and cache["hits"] == 2


@pytest.mark.cuda
def test_rnn_model_trains_on_the_card(cuda):
    from mxnet_tpu_torch.models import RNNModel
    net = RNNModel("lstm", 50, 32, 32, 2, dropout=0.2)
    net.initialize(mx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = nd.array(rng.integers(0, 50, (T, 8)).astype("float32"))
    y = nd.array(rng.integers(0, 50, (T * 8,)).astype("float32"))
    hidden = net.begin_state(batch_size=8)
    losses = []
    for _ in range(5):
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            out, hidden = net(x, hidden)
            L = loss_fn(out.reshape((-1, 50)), y).mean()
        L.backward()
        trainer.step(1)
        losses.append(float(L.asscalar()))
    assert losses[-1] < losses[0]
    net.hybridize()
    with autograd.predict_mode():
        a, _ = net(x, hidden)
        b, _ = net(x, hidden)
    assert torch.equal(a._data, b._data)
