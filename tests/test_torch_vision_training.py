"""The port's ``ShardedTrainer`` and ``functionalize`` against the JAX
package's on a narrow ResNet v1.

``ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
thumbnail=True)``, 10 classes, batch 4 at 32x32, ``SoftmaxCrossEntropyLoss``
and SGD (lr 0.1, momentum 0.9, wd 1e-4), the configuration of
``bench.py``'s ``resnet50_train`` at narrow width. Both trainers start from
the same values (the port's ``Xavier()`` draws, carried into the
reference) and run 3 steps on the same batch:

- float32: every loss within 1e-5 relative; every parameter and moving
  statistic within 1e-4 of its largest |value| after ``sync_back``; the
  moving statistics of the block equal the trainer's after each step (the
  reference writes them back every step) and are never touched by the
  weight decay (a BatchNorm's statistics follow the momentum rule from
  the batch's own mean and variance).
- bfloat16 (the net cast first, as ``bench.py`` does; BatchNorm stays
  float32): the first loss within one bfloat16 ulp; later losses within
  5e-2 relative (bfloat16 weights after an lr-0.1 step round differently);
  the port's parameters no further from the float32 reference run than
  1.5x the reference's own bfloat16 run is (worst parameter, relative to
  its largest |value|), since both round differently from float32 at
  every step.
- ``functionalize``: the outputs and the aux values (the moving
  statistics) of the pure function in training and in inference mode
  within 1e-5 of the reference's, and its aux handles name the same
  parameters.
- ``ShardedTrainer.forward`` equals the block's inference forward, and
  ``bench_span`` runs steps on batches made on the device from the
  trainer's own generator.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.parallel.functional import functionalize as jfunctionalize
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.gluon.nn import BatchNorm
from mxnet_tpu_torch.parallel import ShardedTrainer, functionalize

torch.set_num_threads(1)

SPEC = ([1, 1, 1, 1], [8, 8, 16, 32, 64])
HYPER = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
BF16_LOSS_RTOL = 5e-2
BF16_FACTOR = 1.5
STEPS = 3


def _batch():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, (4,)).astype(np.float32))


def _nets(dtype=None):
    """The port's net from ``Xavier()`` (shapes settled by one call) and
    the reference's given its values; both cast to ``dtype``."""
    trandom.seed(0)
    with tmx.cpu():
        port = tres.ResNetV1(tres.BasicBlockV1, *SPEC, classes=10,
                             thumbnail=True)
        port.initialize(tinit.Xavier())
        port(tnd.zeros((1, 3, 32, 32)))
    ref = jres.ResNetV1(jres.BasicBlockV1, *SPEC, classes=10, thumbnail=True)
    ref.initialize()
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        p.set_data(mx.nd.array(q.data().asnumpy()))
        p._finish_deferred_init()
    if dtype is not None:
        ref.cast(dtype)
        port.cast(dtype)
    return ref, port


def _values(net):
    """``{name after the prefix: float64 values}`` (converted on the
    host)."""
    return {n[len(net.prefix):]: np.asarray(
        p.data().asnumpy() if isinstance(net, jgluon.Block)
        else p.tensor().detach().double().numpy(), np.float64)
        for n, p in net.collect_params().items()}


def _train(dtype=None):
    """3 steps in each package; their losses and their values after
    ``sync_back``."""
    ref, port = _nets(dtype)
    x, y = _batch()
    jtr = jparallel.ShardedTrainer(
        ref, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(HYPER),
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    ttr = ShardedTrainer(port, SoftmaxCrossEntropyLoss(), "sgd", dict(HYPER),
                         device="cpu")
    jx = jnp.asarray(x, jnp.bfloat16) if dtype else x
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype else x
    bn = [m for m in port.modules() if isinstance(m, BatchNorm)]
    jl, tl, moved = [], [], []
    for _ in range(STEPS):
        jl.append(float(jtr.step(jx, y).asnumpy()))
        before = [m.running_mean.data().asnumpy().copy() for m in bn]
        tl.append(float(ttr.step(tx, y)))
        # the block's moving statistics follow the trainer's every step
        for m in bn:
            name = [n for n, t in port.named_parameters()
                    if t is m.running_mean.tensor()][0]
            np.testing.assert_array_equal(
                m.running_mean.data().asnumpy(),
                ttr.values[name].detach().float().numpy())
        moved.append(any(not np.array_equal(b, m.running_mean.data()
                                            .asnumpy())
                         for b, m in zip(before, bn)))
    assert all(moved)
    jtr.sync_back()
    ttr.sync_back()
    return jl, tl, _values(ref), _values(port)


@pytest.fixture(scope="module")
def fp32_run():
    return _train()


def _worst(got, want):
    return max((np.abs(got[k] - want[k]).max()
                / max(np.abs(want[k]).max(), 1e-12), k) for k in want)


def test_sgd_momentum_steps_match_reference_fp32(fp32_run):
    jl, tl, jv, tv = fp32_run
    assert all(np.isfinite(tl))
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    assert list(tv) == list(jv)
    worst, name = _worst(tv, jv)
    assert worst <= PARAM_TOL, name


def test_sgd_momentum_steps_bf16_as_close_to_fp32_as_reference(fp32_run):
    jl, tl, jv, tv = _train("bfloat16")
    ulp = 2.0 ** (np.floor(np.log2(abs(jl[0]))) - 7)
    assert abs(tl[0] - jl[0]) <= ulp
    for a, b in zip(tl[1:], jl[1:]):
        assert abs(a - b) <= BF16_LOSS_RTOL * abs(b)
    truth = fp32_run[2]
    port_dist, name = _worst(tv, truth)
    ref_dist, _ = _worst(jv, truth)
    assert port_dist <= BF16_FACTOR * ref_dist, (name, port_dist, ref_dist)


def test_batch_norm_stats_follow_the_momentum_rule():
    """One step: a BatchNorm's new moving statistics are ``0.9 * old +
    0.1 * batch`` of its own input's batch mean and (biased) variance,
    with no weight decay on them."""
    _, port = _nets()
    bn = next(m for m in port.modules() if isinstance(m, BatchNorm))
    seen = []
    hook = bn.register_forward_hook(lambda blk, args, out: seen.append(
        args[0].detach().double()))
    trainer = ShardedTrainer(port, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(HYPER, wd=0.5), device="cpu")
    old_m = bn.running_mean.data().asnumpy().astype(np.float64)
    old_v = bn.running_var.data().asnumpy().astype(np.float64)
    x, y = _batch()
    trainer.step(x, y)
    hook.detach()
    a = seen[0]
    mean = a.mean(dim=(0, 2, 3)).numpy()
    var = a.var(dim=(0, 2, 3), unbiased=False).numpy()
    np.testing.assert_allclose(bn.running_mean.data().asnumpy(),
                               0.9 * old_m + 0.1 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.data().asnumpy(),
                               0.9 * old_v + 0.1 * var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_functionalize_matches_reference(train):
    ref, port = _nets()
    x, _ = _batch()
    jpure, jparams = jfunctionalize(ref, train=train)
    (jout,), jaux = jax.jit(lambda v, a: jpure(jax.random.PRNGKey(0), v, a))(
        [p.data()._data for p in jparams], jnp.asarray(x))
    tpure, tparams = functionalize(port, train=train)
    assert [p.name[len(port.prefix):] for p in tparams] == \
        [p.name[len(ref.prefix):] for p in jparams]
    with torch.no_grad():
        (tout,), taux = tpure(0, [p.tensor() for p in tparams],
                              torch.from_numpy(x))
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= \
        1e-5 * np.abs(np.asarray(jout)).max()
    n_bn = sum(isinstance(m, BatchNorm) for m in port.modules())
    assert len(taux) == len(jaux) == (2 * n_bn if train else 0)
    jnames = {id(d): p.name[len(ref.prefix):] for p in jparams
              for d in p._data}
    assert [tparams[i].name[len(port.prefix):] for i in tpure.aux_index] \
        == [jnames[id(h)] for h in jpure.aux_handles]
    for a, b in zip(taux, jaux):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    # the pure function wrote nothing into the block
    for p, q in zip(jparams, tparams):
        np.testing.assert_array_equal(q.data().asnumpy(),
                                      np.asarray(p.data()._data))


def test_trainer_forward_and_bench_span():
    _, port = _nets()
    trainer = ShardedTrainer(port, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(HYPER), device="cpu")
    x, _ = _batch()
    with tmx.cpu():
        want = port(tnd.array(x)).asnumpy()
    np.testing.assert_array_equal(trainer.forward(x).numpy(), want)
    trandom.seed(5)
    losses = trainer.bench_span(2, (4, 3, 32, 32), 10)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert trainer._t == 2
    xs = []
    losses = trainer.bench_span_fn(
        1, lambda g: (xs.append(torch.rand((4, 3, 32, 32), generator=g))
                      or (xs[-1],), torch.zeros(4)))
    assert losses.shape == (1,) and xs[0].shape == (4, 3, 32, 32)
