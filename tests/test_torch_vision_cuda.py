"""The vision ops on a card against the same ops on the CPU.

Every test here is marked ``cuda`` and skips where no CUDA device is
present; the module imports neither JAX nor the JAX package (the CPU ops
are held to the reference in ``tests/test_torch_vision_ops.py``):

    python -m pytest --noconftest -q tests/test_torch_vision_cuda.py

At ResNet-50's shapes (the stem: a 7x7/2 convolution of (8, 3, 224, 224)
and the 3x3/2 max pool after its ReLU; a bottleneck of stage 2: 1x1,
3x3/2 and 1x1 convolutions and the projection), forward and gradients of
``Convolution`` (cuDNN, TF32 off), ``Pooling`` and ``BatchNorm`` (training
and inference) on the card within 1e-4 of each output's largest |value|
of the CPU's in float32 (sums in another order), and within 2e-2 in
bfloat16 of the CPU's float32 result on the same bfloat16 inputs. Max
pooling on the card gives each window's gradient to the same element as
on the CPU, bit for bit, on tied windows too. The ``BatchNorm`` layer's
moving statistics on the card follow the momentum rule.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as ops

torch.set_num_threads(1)
F32_TOL = 1e-4
BF16_TOL = 2e-2


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


def _card_vs_cpu(cuda, fn, arrays, dtype):
    """``fn`` and every input's gradient on the card (in ``dtype``) and on
    the CPU (float32 on the same rounded inputs)."""
    g = torch.Generator().manual_seed(1)
    card = [a.to(cuda, dtype).requires_grad_() for a in arrays]
    host = [a.to(dtype).float().requires_grad_() for a in arrays]
    out_c, out_h = fn(*card), fn(*host)
    cot = torch.randn(out_h.shape, generator=g)
    out_c.backward(cot.to(cuda, dtype))
    out_h.backward(cot.to(dtype).float())
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(out_c, out_h) <= tol
    for c, h in zip(card, host):
        if h.grad is not None:
            assert _rel(c.grad, h.grad) <= tol


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


CONVS = [
    ("stem", (8, 3, 224, 224), (64, 3, 7, 7), dict(stride=2, pad=3)),
    ("bottleneck_1x1", (8, 256, 56, 56), (128, 256, 1, 1), {}),
    ("bottleneck_3x3s2", (8, 128, 56, 56), (128, 128, 3, 3),
     dict(stride=2, pad=1)),
    ("bottleneck_1x1_up", (8, 128, 28, 28), (512, 128, 1, 1), {}),
    ("projection", (8, 256, 56, 56), (512, 256, 1, 1), dict(stride=2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,xs,ws,kw", CONVS, ids=[c[0] for c in CONVS])
def test_convolution_on_card(cuda, dtype, name, xs, ws, kw):
    k = ws[2:]
    _card_vs_cpu(cuda, lambda x, w: ops.Convolution(
        x, w, kernel=k, no_bias=True, **kw),
        [_randn(*xs), _randn(*ws, seed=1) * 0.05], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
], ids=["stem_max", "global_avg", "avg_full"])
def test_pooling_on_card(cuda, dtype, kw):
    x = torch.relu(_randn(8, 64, 112, 112))
    _card_vs_cpu(cuda, lambda a: ops.Pooling(a, **kw), [x], dtype)


@pytest.mark.cuda
def test_max_pool_ties_on_card_equal_cpu_bitwise(cuda):
    x = torch.relu(_randn(8, 64, 112, 112))      # about half zeros
    x[:, :, :16, :16] = 0.0
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")
    card = x.to(cuda).requires_grad_()
    host = x.clone().requires_grad_()
    out_c, out_h = ops.Pooling(card, **kw), ops.Pooling(host, **kw)
    cot = _randn(*out_h.shape, seed=2)
    out_c.backward(cot.to(cuda))
    out_h.backward(cot)
    assert torch.equal(out_c.cpu(), out_h)
    assert torch.equal(card.grad.cpu(), host.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(8, 64, 112, 112), (8, 512, 28, 28)],
                         ids=["stem", "stage2"])
def test_batch_norm_on_card(cuda, dtype, train, shape):
    c = shape[1]
    rm, rv = _randn(c, seed=3), torch.rand(c) + 0.5

    def fn(x, g, b):
        return ops.BatchNorm(x, g, b, rm.to(x.device), rv.to(x.device),
                             eps=1e-5, fix_gamma=False, train=train)
    # gamma and beta stay float32, as the layer keeps them under cast
    g, b = _randn(c, seed=4), _randn(c, seed=5)
    card = [_randn(*shape).to(cuda, dtype).requires_grad_(),
            g.to(cuda).requires_grad_(), b.to(cuda).requires_grad_()]
    host = [card[0].detach().cpu().float().requires_grad_(),
            g.clone().requires_grad_(), b.clone().requires_grad_()]
    out_c, out_h = fn(*card), fn(*host)
    cot = _randn(*shape, seed=6)
    out_c.backward(cot.to(cuda, dtype))
    out_h.backward(cot.to(dtype).float())
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(out_c, out_h) <= tol
    for x, y in zip(card, host):
        assert _rel(x.grad, y.grad) <= tol


@pytest.mark.cuda
def test_batch_norm_layer_moving_stats_on_card(cuda):
    from mxnet_tpu_torch import context
    with context.gpu(0):
        layer = nn.BatchNorm(in_channels=64)
        layer.initialize()
    x = _randn(8, 64, 56, 56).to(cuda) * 2.0 + 1.0
    layer.train()
    layer(x)
    mean = x.double().mean(dim=(0, 2, 3))
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    got_m = layer.running_mean.tensor().double()
    got_v = layer.running_var.tensor().double()
    assert torch.allclose(got_m, 0.1 * mean, rtol=1e-5, atol=1e-6)
    assert torch.allclose(got_v, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
