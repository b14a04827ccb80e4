"""The first part of the op corpus on a card. Every test here is marked
``cuda`` and skips where no CUDA device is present; the module imports
neither JAX nor the JAX package (the CPU side is held to the reference in
``tests/test_torch_ops_core.py``, ``test_torch_ops_tensor_extra.py``,
``test_torch_random_ops.py`` and ``test_torch_states.py``):

    python -m pytest --noconftest -q tests/test_torch_ops_cuda.py

- Every name this slice registers, through ``test_utils.check_consistency``
  (the CPU against ``gpu(0)``) at small shapes, with the inputs and
  families of ``chip_smoke.py``'s ops phase: bit for bit (``exact``),
  rtol 1e-6 / atol 1e-7 (``float``; atol 1e-6 for ``lgamma``; rtol 2e-6
  for ``gamma`` and 3e-5 for the densities), or within 1e-5 of each
  output's largest |value| (``linalg``, ``reduce``). A
  sampler draws on the card, and a seed repeats its draw there.
- ``mx.random.seed`` repeats the graph replays of a hybridized sampling
  block that follow it, and two replays draw different numbers.
- A ``gluon.Trainer`` Adam ``.states`` file written on the card and loaded
  by a fresh trainer resumes the third step bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, test_utils
from mxnet_tpu_torch.ops.registry import get_op

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = {"OPS_LOGITS": (4, 320), "OPS_GEMM": (6, 8, 4),
         "OPS_SPD": (3, 16, 16), "OPS_ACT": (2, 64, 8, 64),
         "OPS_DRAWS": (4, 3, 100, 100), "BERT_VOCAB": 100}


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(SMALL, _bert_param_shapes=lambda: [torch.empty(3, 5),
                                                    torch.empty(7)])
    saved = {k: getattr(cs, k) for k in small}
    for k, v in small.items():
        setattr(cs, k, v)
    yield cs._ops_arrays(0), cs._ops_cases()
    for k, v in saved.items():
        setattr(cs, k, v)


def _tolerance(family, cpu_outs):
    if family == "exact":
        return 0.0, 0.0
    if family in ("float", "lgamma"):
        return 1e-6, 1e-6 if family == "lgamma" else 1e-7
    if family in ("gamma", "density"):
        return (cs.OPS_GAMMA_RTOL if family == "gamma"
                else cs.OPS_DENSITY_RTOL), 1e-6
    scale = max(float(np.abs(np.asarray(o, np.float64)).max())
                for o in cpu_outs)
    return 0.0, 1e-5 * scale


_CASES = cs._ops_cases()
DETERMINISTIC = [n for n in cs.OPS_NEW_NAMES if get_op(n).name in _CASES]
SAMPLERS = [n for n in cs.OPS_NEW_NAMES if n not in DETERMINISTIC]


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_consistency_cpu_against_card(small, name):
    arrays, cases = small
    args, kw, family = cases[get_op(name).name]
    inputs = []
    for a in args:
        v = cs._ops_array(arrays, a) if isinstance(a, str) else a
        v = v if isinstance(v, list) else [v]
        for x in v:
            if isinstance(x, tuple):          # ("bf16", array)
                inputs.append(nd.array(x[1]).astype("bfloat16"))
            else:
                inputs.append(nd.array(x, dtype=x.dtype.name))
    outs = test_utils.check_consistency(
        lambda *xs: getattr(nd, name)(*xs, **kw), inputs,
        ctxs=[mx.cpu(0)], rtol=0, atol=0)
    rtol, atol = _tolerance(family, outs[0])
    cpu, card = test_utils.check_consistency(
        lambda *xs: getattr(nd, name)(*xs, **kw), inputs,
        ctxs=[mx.cpu(0), mx.gpu(0)],
        rtol=rtol, atol=atol if family != "hist" else 1e-6)
    assert len(cpu) == len(card)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_draws_on_the_card_and_repeats(small, name):
    op = get_op(name)
    draws = cs._ops_samplers(nd, mx)
    if op.name in draws:
        draw = draws[op.name][0]
    elif op.name == "_sample_multinomial":
        def draw():
            return nd._sample_multinomial(
                nd.array(np.array([[0.2, 0.8]], np.float32), ctx=mx.gpu(0)),
                shape=(100,))
    elif op.name == "_sample_unique_zipfian":
        def draw():
            with mx.gpu(0):
                return nd._sample_unique_zipfian(range_max=100,
                                                 shape=(2, 50))[0]
    else:                                     # the shuffles
        def draw():
            return getattr(nd, name)(nd.array(np.arange(64.0),
                                              ctx=mx.gpu(0)))
    mx.random.seed(3)
    a = draw()
    mx.random.seed(3)
    b = draw()
    assert a._data.is_cuda
    assert torch.equal(a._data, b._data)


class _Noisy(gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x + F._random_normal_like(x)


def test_seed_repeats_graph_replays_and_replays_differ(small):
    net = _Noisy()
    net.hybridize()
    x = nd.zeros((4, 256), ctx=mx.gpu(0))
    runs = []
    with autograd.predict_mode():
        net(x)                      # the capture: the seeded calls replay
        for _ in range(2):
            mx.random.seed(5)
            runs.append([net(x)._data.clone() for _ in range(3)])
    stats = [op.cache_stats() for op in
             net.__dict__["_cached_ops"].values()]
    assert any(s["graphs"] for s in stats)
    assert not torch.equal(runs[0][1], runs[0][2])
    assert all(torch.equal(p, q) for p, q in zip(*runs))


def test_states_round_trip_on_the_card(small, tmp_path):
    rng = np.random.default_rng(0)
    x, h = (nd.array(rng.integers(-1, 3, (4, 4)).astype("float32"),
                     ctx=mx.gpu(0)) for _ in range(2))

    def make():
        with mx.gpu(0):
            net = gluon.nn.Dense(4, in_units=4)
            net.initialize(ctx=mx.gpu(0))
            net.weight.set_data(nd.array(np.eye(4, dtype="float32")))
            net.bias.set_data(nd.zeros((4,)))
        return net, gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.1})

    def step(net, tr):
        with autograd.record():
            loss = (net(x) * h).sum()
        loss.backward()
        tr.step(4)

    net, tr = make()
    step(net, tr)
    step(net, tr)
    net.save_parameters(str(tmp_path / "p.params"))
    tr.save_states(str(tmp_path / "p.states"))
    step(net, tr)
    net2, tr2 = make()
    net2.load_parameters(str(tmp_path / "p.params"), ctx=mx.gpu(0))
    tr2.load_states(str(tmp_path / "p.states"))
    step(net2, tr2)
    for p, q in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        assert p.data()._data.is_cuda and q.data()._data.is_cuda
        assert torch.equal(p.data()._data, q.data()._data)
