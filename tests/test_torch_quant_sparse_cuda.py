"""Item 8 steps 5-6 (the Custom op, the INT8 family, sparse storage and
the graph ops) on a card. Every test here is marked ``cuda`` and skips
where no CUDA device is present; the module imports neither JAX nor the
JAX package (the CPU side is held to the reference in
``tests/test_torch_{custom_op,quantization,sparse}.py``):

    python -m pytest --noconftest -q tests/test_torch_quant_sparse_cuda.py

``chip_smoke.py``'s quant and sparse phases at small sizes (their
functions, with their tolerances), then: the int8 GEMM against its plain
version at shapes that need ``torch._int_mm``'s padding; the Custom op in
a hybridized block runs its signature eagerly and is counted, while a
host read outside a host op still fails its capture; sparse ``dot``
repeats bit for bit on the card.
"""
import os
import sys
import types

import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = {"VISION_BATCH": 4, "VISION_IMAGE": 64, "SPARSE_FEATURES": 15001,
         "SPARSE_BATCH": 512, "SPARSE_STEPS": 4, "GRAPH_VERTICES": 2000,
         "GRAPH_PAIRS": 200, "GRAPH_SUBSET": 100, "GRAPH_SEEDS": 8,
         "RRELU_SHAPE": (8, 64, 56, 56), "QUANT_CPU_ROWS": 2}
DEV = torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = {k: getattr(cs, k) for k in SMALL}
    for k, v in SMALL.items():
        setattr(cs, k, v)
    yield types.SimpleNamespace(seed=0, profile=False)
    for k, v in saved.items():
        setattr(cs, k, v)


def test_quant_phase(small, tmp_path):
    net, custom = cs.quant_custom(small, torch, str(tmp_path))
    assert custom["served"]["host_eager"] == 1
    assert custom["other_capture_raises"]
    res = cs.quant_int8(small, torch, str(tmp_path), net)
    assert res["accumulators_bitwise"] == cs.QUANT_LAYERS
    assert res["range_set_in_place"]
    assert res["params_round_trip_bitwise"]
    assert cs.quant_names(small, torch)["names"] == 26


def test_sparse_phase(small):
    res = cs.sparse_phase(small, torch)
    assert res["linear"]["untouched_unchanged"]
    assert res["linear"]["payload_matches_dense"]
    assert res["linear"]["repeat_bitwise"]
    assert res["graph"]["names"] == 7


@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (20, 9, 3), (64, 576, 64),
                                   (32, 2048, 1000)])
def test_int8_matmul_equals_its_plain_version(small, m, k, n):
    from mxnet_tpu_torch.ops import quantized_ops as qo
    g = torch.Generator(DEV).manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=DEV,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=DEV,
                      dtype=torch.int8)
    got = qo.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, qo.int8_matmul_plain(a, b))
    assert torch.equal(got.cpu(), qo.int8_matmul(a.cpu(), b.cpu()))


@pytest.mark.parametrize("cin,hw,cout,k,stride,pad", [
    (3, 30, 64, 7, 2, 3), (64, 14, 64, 3, 1, 1), (256, 14, 512, 1, 2, 0),
    (5, 9, 3, 3, 2, 0)])
def test_int8_conv_equals_a_float64_convolution(small, cin, hw, cout, k,
                                                stride, pad):
    from mxnet_tpu_torch.ops import quantized_ops as qo
    g = torch.Generator(DEV).manual_seed(cin * hw + k)
    x = torch.randint(-127, 128, (2, cin, hw, hw), generator=g, device=DEV,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      device=DEV, dtype=torch.int8)
    geo = ((stride, stride), (pad, pad), (1, 1))
    got = qo.int8_conv(x, w, *geo)
    assert got.dtype == torch.int32
    assert torch.equal(got, cs._int8_conv_plain(torch, x, w, *geo))


def test_a_range_set_in_place_reaches_the_replay(small):
    """A hybridized int8 net captured on the card, then ``set_data`` of a
    narrower calibrated range: the replay quantizes in it."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    g = torch.Generator(DEV).manual_seed(5)
    with mx.gpu(0):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                                activation="relu"),
                gluon.nn.Flatten(), gluon.nn.Dense(10))
        net.initialize(mx.init.Xavier())
        calib = [nd.NDArray(torch.randn(8, 1, 12, 12, generator=g,
                                        device=DEV)) for _ in range(2)]
        net(calib[0])
        quantize_net(net, calib_data=calib, calib_mode="naive")
    x = nd.NDArray(torch.randn(8, 1, 12, 12, generator=g, device=DEV))
    net.hybridize()
    with autograd.predict_mode():
        net(x)
        before = net(x)._data.clone()
        assert cs._range_set_in_place(torch, net, x, before)


def test_custom_block_is_eager_and_other_captures_raise(small):
    cs._register_custom_softmax(mx)

    class Head(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x * 2, op_type="chip_softmax_infer")

    class Syncs(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(x.sum().asscalar())

    head, syncs = Head(), Syncs()
    head.hybridize()
    syncs.hybridize()
    x = nd.NDArray(torch.randn(4, 10, device=DEV))
    with autograd.predict_mode():
        outs = [head(x)._data for _ in range(3)]
        with pytest.raises(Exception):
            syncs(x)
    torch.cuda.synchronize()
    (op,) = head._cached_ops.values()
    stats = op.cache_stats()
    assert stats["host_eager"] == 1 and stats["graphs"] == 0
    assert all(torch.equal(o, outs[0]) for o in outs)
    torch.testing.assert_close(outs[0].sum(1), torch.ones(4, device=DEV))
    # an Executor's inference forward through its CachedOp, eagerly
    ex = mx.sym.Custom(data=mx.sym.var("data"),
                       op_type="chip_softmax_infer").bind(
        mx.gpu(0), {"data": x})
    first = ex.forward()[0]._data.clone()
    assert torch.equal(ex.forward()[0]._data, first)
    (eop,) = ex._cached_ops.values()
    assert eop.cache_stats()["host_eager"] == 1


def test_sparse_dot_repeats_on_the_card(small):
    from mxnet_tpu_torch.ndarray import sparse
    g = torch.Generator(DEV).manual_seed(3)
    dense = torch.randn(300, 700, generator=g, device=DEV)
    dense[torch.rand(300, 700, generator=g, device=DEV) > 0.05] = 0
    csr = nd.NDArray(dense).tostype("csr")
    rhs = nd.NDArray(torch.randn(700, 16, generator=g, device=DEV))
    rhs_t = nd.NDArray(torch.randn(300, 16, generator=g, device=DEV))
    outs = [(sparse.dot(csr, rhs)._data,
             sparse.dot(csr, rhs_t, transpose_a=True)._data)
            for _ in range(3)]
    for a, b in outs[1:]:
        assert torch.equal(a, outs[0][0]) and torch.equal(b, outs[0][1])
    truth = dense.double() @ rhs._data.double()
    tol = 1e-6 * truth.abs().max().item()
    assert (outs[0][0].double() - truth).abs().max().item() <= tol
    with mx.cpu():
        cpu = sparse.dot(nd.NDArray(dense.cpu()).tostype("csr"),
                         nd.NDArray(rhs._data.cpu()))._data
    assert (cpu.double() - outs[0][0].cpu().double()).abs().max() <= tol
