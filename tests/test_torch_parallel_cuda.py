"""Distribution inside one process on a card. Every test here is marked
``cuda`` and skips where no CUDA device is present; the module imports
neither JAX nor the JAX package (the CPU side is held to the reference in
``tests/test_torch_{mesh,kvstore,moe_ring_pipeline,planner,
sharded_checkpoint,subgraph,multi_context}.py``):

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py

- A dp=2 x tp=2 mesh of four positions on one card trains a small
  ``TransformerLM`` (``tp_rules()``) as the one-device trainer does
  (losses to 1e-5 relative), each replica's attention through the flash
  kernels (2 replicas x steps x layers launches of each, all on the
  (B, S, H, D) layout), every shard in its own buffer.
- A BatchNorm net under dp=4 on the card equals its CPU run (moments over
  the replicas) within 1e-5.
- Ring attention over sp=4 on the card against float64 attention.
- A partitioned symbol's inference bind (a CUDA graph through
  ``CachedOp``) equals the unpartitioned bind bit for bit.
- A 2bit ``device`` kvstore on the card equals the CPU's bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, parallel
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx.gpu(0)


def test_dp_tp_mesh_on_one_card_matches_one_device(card):
    from mxnet_tpu_torch.models import TransformerLM, tp_rules
    from mxnet_tpu_torch.ops import flash_attention as fa
    torch.manual_seed(0)
    net = TransformerLM(512, units=128, num_layers=2, num_heads=2,
                        max_len=128, device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 512, (8, 128))).cuda()
    y = torch.cat([x[:, 1:], torch.full((8, 1), -1, device="cuda")], 1)
    one = parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                                  {"learning_rate": 1e-3}, device="cuda")
    want = [float(one.step(x, y)) for _ in range(3)]
    mesh = parallel.make_mesh(dp=2, tp=2, devices=[card] * 4)
    tr = parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                                 {"learning_rate": 1e-3}, mesh=mesh,
                                 param_rules=tp_rules())
    fa.reset_launches()
    got = [float(tr.step(x, y)) for _ in range(3)]
    assert fa.flash_attention_bshd.launches == 2 * 3 * 2
    assert fa.flash_attention_bwd_dq.launches == 2 * 3 * 2
    assert fa.flash_attention_bwd_dkv.launches == 2 * 3 * 2
    for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        assert w.launches_by_layout == {"BSHD": 2 * 3 * 2, "BHSD": 0}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ptrs = [s.data_ptr() for v in tr.values.values() for s in v.shards]
    assert len(set(ptrs)) == len(ptrs)


def test_batchnorm_moments_over_replicas_on_the_card(card):
    from mxnet_tpu_torch import initializer, random as trandom
    from mxnet_tpu_torch.gluon import nn
    rng = np.random.default_rng(3)
    X = rng.standard_normal((16, 3, 8, 8)).astype("float32")
    Y = rng.integers(0, 4, 16).astype("float32")
    losses = {}
    for dev in (card, mx.cpu()):
        trandom.seed(0)
        with dev:
            net = nn.HybridSequential()
            net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                    nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                    nn.GlobalAvgPool2D(), nn.Dense(4, in_units=8))
            net.initialize(initializer.Xavier())
        mesh = parallel.make_mesh(dp=4, devices=[dev] * 4)
        tr = parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     {"learning_rate": 0.05}, mesh=mesh)
        losses[str(dev)] = [float(tr.step(X, Y)) for _ in range(2)]
    np.testing.assert_allclose(losses["gpu(0)"], losses["cpu(0)"],
                               rtol=1e-5)


def test_ring_attention_on_the_card(card):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 512, 64), generator=g).cuda()
               for _ in range(3))
    mesh = parallel.make_mesh(dp=1, sp=4, devices=[card] * 4)
    for causal in (False, True):
        got = parallel.ring_attention_sharded(q, k, v, mesh, causal=causal)
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / 8.0
        if causal:
            s = s.masked_fill(~torch.ones(512, 512, dtype=torch.bool,
                                          device="cuda").tril(), -np.inf)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                            v.double())
        assert (got.double() - want).abs().max().item() < 1e-4


def test_partitioned_bind_replays_bitwise(card, monkeypatch):
    S = mx.sym
    data = S.var("data")
    net = S.Activation(S.FullyConnected(data, num_hidden=64, name="fc"),
                       act_type="relu")
    net = S.tanh(net * 2.0 + 1.0)
    rng = np.random.default_rng(1)
    args = {"data": rng.standard_normal((32, 16)).astype("float32"),
            "fc_weight": rng.standard_normal((64, 16)).astype("float32"),
            "fc_bias": rng.standard_normal(64).astype("float32")}
    outs = {}
    for tag in ("plain", "TPU_ELEMWISE"):
        if tag != "plain":
            monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", tag)
        ex = net.bind(card, {k: nd.array(v, ctx=card)
                             for k, v in args.items()}, grad_req="null")
        xn = nd.array(args["data"], ctx=card)
        first = ex.forward(data=xn)[0]._data.clone()
        outs[tag] = ex.forward(data=xn)[0]._data.clone()
        assert torch.equal(first, outs[tag])
    assert torch.equal(outs["plain"], outs["TPU_ELEMWISE"])


def test_2bit_device_kvstore_card_equals_cpu(card):
    g = torch.Generator().manual_seed(2)
    pushes = [[torch.randn(256, 256, generator=g) * 0.1 for _ in range(2)]
              for _ in range(3)]
    pulled = []
    for ctx in (card, mx.cpu()):
        kv = mx.kvstore.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.05})
        with ctx:
            kv.init(0, nd.zeros((256, 256), ctx=ctx))
            got = []
            for copies in pushes:
                kv.push(0, [nd.NDArray(c.to(ctx.torch_device))
                            for c in copies])
                o = nd.zeros((256, 256), ctx=ctx)
                kv.pull(0, out=o)
                got.append(o._data.cpu())
        pulled.append(torch.stack(got))
    assert torch.equal(pulled[0], pulled[1])
