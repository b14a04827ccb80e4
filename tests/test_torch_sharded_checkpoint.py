"""The port's checkpoints of a mesh ``ShardedTrainer``
(``mxnet_tpu_torch.parallel.checkpoint``) on the CPU: the counterparts of
``tests/test_sharded_checkpoint.py``. Parity is held by trajectories: a
resumed run equals the uninterrupted run in the port bit for bit, and
the port's trajectory follows the reference's dp=8 trainer on the same
draws and batches (losses to 1e-5 relative). The reference writes Orbax
directories; the port writes its own (``.params``, ``.states``, a JSON
manifest), so files are not compared."""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, initializer, parallel
from mxnet_tpu_torch import random as trandom

CPUS = [tmx.cpu(i) for i in range(8)]


def _net(pkg, seed):
    pkg.random.seed(seed)
    np.random.seed(seed)
    net = pkg.gluon.nn.Sequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"),
            pkg.gluon.nn.Dense(4))
    net.initialize(pkg.init.Xavier())
    net(pkg.nd.zeros((2, 8)))
    return net


def _make_trainer(seed=0, mesh=None):
    with tmx.cpu():
        net = _net(tmx, seed)
    return parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2},
        mesh=mesh or parallel.make_mesh(devices=CPUS))


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8, 8).astype("float32"),
             rng.randint(0, 4, (8,)).astype("float32")) for _ in range(n)]


@pytest.fixture(scope="module")
def reference_losses():
    net = _net(jmx, 0)
    tr = jparallel.ShardedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                  "adam", {"learning_rate": 1e-2},
                                  mesh=jparallel.make_mesh())
    return [float(tr.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
            for x, y in _batches(3, 1) + _batches(3, 2)]


def test_checkpoint_resume_reproduces_trajectory(tmp_path, reference_losses):
    t1 = _make_trainer()
    warm = [float(t1.step(x, y)) for x, y in _batches(3, seed=1)]
    ckpt = str(tmp_path / "ckpt")
    parallel.save_checkpoint(t1, ckpt)
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "states.states",
                                        "values.params"]
    step_at_save = t1._t
    cont = _batches(3, seed=2)
    losses_a = [float(t1.step(x, y)) for x, y in cont]
    np.testing.assert_allclose(warm + losses_a, reference_losses, rtol=1e-5)
    # a fresh trainer from other draws, on another mesh: the same steps
    for mesh in (None, parallel.make_mesh(dp=2, devices=CPUS[:2]),
                 parallel.make_mesh(dp=1, tp=4, devices=[CPUS[0]] * 4)):
        t2 = _make_trainer(seed=99, mesh=mesh)
        parallel.restore_checkpoint(t2, ckpt)
        assert t2._t == step_at_save
        losses_b = [float(t2.step(x, y)) for x, y in cont]
        if mesh is None:
            assert losses_b == losses_a          # bit for bit
        np.testing.assert_allclose(losses_b, losses_a, rtol=1e-6)
    # a one-device trainer restores the same directory
    with tmx.cpu():
        net = _net(tmx, 5)
    one = parallel.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  "adam", {"learning_rate": 1e-2},
                                  device="cpu")
    parallel.restore_checkpoint(one, ckpt)
    np.testing.assert_allclose([float(one.step(x, y)) for x, y in cont],
                               losses_a, rtol=1e-6)


def test_checkpoint_preserves_shardings(tmp_path):
    mesh = parallel.make_mesh(dp=2, tp=4, devices=CPUS)
    rules = [(r"dense0_weight$", parallel.PartitionSpec("tp", None))]
    with tmx.cpu():
        nets = [_net(tmx, s) for s in (0, 5)]
    t1, t2 = (parallel.ShardedTrainer(n, gluon.loss.SoftmaxCrossEntropyLoss(),
                                      "adam", {"learning_rate": 1e-2},
                                      mesh=mesh, param_rules=rules)
              for n in nets)
    for x, y in _batches(2, seed=3):
        t1.step(x, y)
    ckpt = str(tmp_path / "ckpt2")
    parallel.save_checkpoint(t1, ckpt)
    with open(os.path.join(ckpt, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 2 and man["world"] == 8 and man["plan"] is None
    parallel.restore_checkpoint(t2, ckpt)
    for (n, a), b in zip(t1.values.items(), t2.values.values()):
        assert np.array_equal(a.numpy(), b.numpy()), n
        assert b.sharding.is_equivalent_to(a.sharding, a.ndim)
        assert {s.data_ptr() for s in b.shards}.isdisjoint(
            s.data_ptr() for s in a.shards)
    for n in t1._states:
        for a, b in zip(t1._states[n], t2._states[n]):
            assert np.array_equal(a.numpy(), b.numpy())
    # a crash between staging and publishing keeps the last checkpoint
    from mxnet_tpu_torch.resilience import chaos
    chaos.arm("checkpoint.save", "fatal", first=1)
    try:
        with pytest.raises(Exception):
            parallel.save_checkpoint(t2, ckpt)
    finally:
        chaos.clear()
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f)["step"] == 2


def test_bench_span_runs_real_steps():
    t = _make_trainer()
    before = [v.numpy().copy() for v in t.values.values()]
    losses = t.bench_span(4, (8, 8), 4)
    assert losses.shape == (4,)
    assert np.isfinite(losses.numpy()).all()
    assert t._t == 4
    moved = sum(float(np.abs(v.numpy() - b).sum())
                for v, b in zip(t.values.values(), before))
    assert moved > 0
    t.bench_span(4, (8, 8), 4)
    assert t._t == 8

    def make_batch(gen):
        x = torch.rand((8, 8), generator=gen)
        return (x,), torch.randint(0, 4, (8,), generator=gen).float()
    assert t.bench_span_fn(2, make_batch, tag="lm").shape == (2,)
    assert t._t == 10
