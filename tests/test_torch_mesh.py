"""The port's meshes, collectives and mesh ``ShardedTrainer``
(``mxnet_tpu_torch.parallel``) against the JAX package's, on the CPU: the
counterparts of ``tests/test_parallel.py``'s mesh and trainer tests.

The port's mesh holds logical devices: ``[mx.cpu(i) for i in range(8)]``
is the reference's 8 virtual CPU devices. Both packages start from the
same numpy draws (``random.seed`` then ``Xavier``); fp32 parameters after
the steps agree to the reference's own tolerance (rtol 1e-4, atol 1e-5),
the port's dp=8 run and its one-device run to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import PartitionSpec as P
from mxnet_tpu_torch.parallel import mesh as tmesh

CPUS = [tmx.cpu(i) for i in range(8)]
TOL = dict(rtol=1e-4, atol=1e-5)


def _mesh(**axes):
    n = int(np.prod(list(axes.values()))) if axes else 8
    return tparallel.make_mesh(devices=CPUS[:n] if axes.get("dp", 1) != -1
                               else CPUS, **axes)


def test_mesh_creation():
    mesh = tparallel.make_mesh(dp=4, tp=2, devices=CPUS)
    assert dict(mesh.shape) == {"dp": 4, "pp": 1, "ep": 1, "tp": 2, "sp": 1}
    assert dict(tparallel.make_mesh(devices=CPUS).shape)["dp"] == 8
    jm = jparallel.make_mesh(dp=4, tp=2)
    assert dict(jm.shape) == dict(mesh.shape)
    with pytest.raises(ValueError):
        tparallel.make_mesh(dp=3, devices=CPUS)
    # one physical device at several positions
    assert tparallel.make_mesh(dp=2, tp=2,
                               devices=[tmx.cpu(0)] * 4).size == 4


@pytest.mark.parametrize("name", ["all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "ppermute"])
def test_collectives_match_jax(name):
    """Each collective over the tp axis of a dp=2 x tp=4 mesh against the
    same collective in ``jax.shard_map`` on the reference's mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from jax import lax
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4, 6)).astype("float32")  # one row a position
    mesh = tparallel.make_mesh(dp=2, tp=4, devices=CPUS)
    shards = [torch.from_numpy(x[p]) for p in range(8)]
    perm = [(i, (i + 1) % 4) for i in range(4)]
    own = {"all_reduce": lambda: tmesh.all_reduce(shards, mesh, "tp"),
           "all_gather": lambda: tmesh.all_gather(shards, mesh, "tp", 0),
           "reduce_scatter": lambda: tmesh.reduce_scatter(shards, mesh,
                                                          "tp", 0),
           "all_to_all": lambda: tmesh.all_to_all(shards, mesh, "tp", 0, 0),
           "ppermute": lambda: tmesh.ppermute(shards, mesh, "tp", perm)}
    fns = {"all_reduce": lambda v: lax.psum(v, "tp"),
           "all_gather": lambda v: lax.all_gather(v, "tp", axis=0,
                                                  tiled=True),
           "reduce_scatter": lambda v: lax.psum_scatter(
               v, "tp", scatter_dimension=0, tiled=True),
           "all_to_all": lambda v: lax.all_to_all(v, "tp", 0, 0,
                                                  tiled=True),
           "ppermute": lambda v: lax.ppermute(v, "tp", perm)}
    jm = jparallel.make_mesh(dp=2, tp=4)
    spec = JP(("dp", "pp", "ep", "tp", "sp"))
    run = shard_map(lambda v: fns[name](v[0])[None], mesh=jm,
                    in_specs=spec, out_specs=spec)
    want = np.asarray(jax.jit(run)(jax.device_put(
        x, NamedSharding(jm, spec))))
    got = np.stack([t.numpy() for t in own[name]()])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # sums repeat bit for bit, and every shard owns its storage
    again = np.stack([t.numpy() for t in own[name]()])
    assert np.array_equal(got, again)
    ptrs = [t.data_ptr() for t in own[name]()]
    assert len(set(ptrs)) == len(ptrs)


def test_sharded_tensor_places_and_gathers():
    mesh = tparallel.make_mesh(dp=2, tp=4, devices=CPUS)
    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for spec, shard in ((P(), (8, 12)), (P("tp", None), (2, 12)),
                        (P(None, "tp"), (8, 3)), (P(("dp", "tp")), (1, 12)),
                        (P("dp", "tp"), (4, 3))):
        st = tparallel.ShardedTensor.place(
            w, tparallel.NamedSharding(mesh, spec))
        assert all(s.shape == shard for s in st.shards)
        assert torch.equal(st.full(), w)
        ptrs = {s.data_ptr() for s in st.shards}
        assert len(ptrs) == 8 and w.data_ptr() not in ptrs


def _dense_net(pkg, init, ctx):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=10),
                nn.Dense(4, in_units=16))
    net.initialize(init.Xavier(), ctx=ctx)
    return net


@pytest.fixture(scope="module")
def dp_reference():
    """The reference's dp=8 ShardedTrainer (3 SGD steps) and its eager
    one-device Trainer on the same draws: their final parameters."""
    np.random.seed(0)
    jmx.random.seed(0)
    X = np.random.randn(32, 10).astype("float32")
    Y = np.random.randint(0, 4, 32)
    net = _dense_net(jmx, jmx.init, None)
    init = [p.data().asnumpy() for p in net.collect_params().values()]
    st = jparallel.ShardedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.1},
                                  mesh=jparallel.make_mesh(dp=8))
    for _ in range(3):
        st.step(jmx.nd.array(X), jmx.nd.array(Y))
    st.sync_back()
    return X, Y, init, [p.data().asnumpy()
                        for p in net.collect_params().values()]


def test_sharded_trainer_dp_matches_single_device(dp_reference):
    X, Y, init, want = dp_reference
    nets = []
    for _ in range(2):
        with tmx.cpu():
            net = _dense_net(tmx, tinit, tmx.cpu())
        for p, v in zip(net.collect_params().values(), init):
            p.set_data(v)
        nets.append(net)
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    one = tparallel.ShardedTrainer(nets[0], loss_fn, "sgd",
                                   {"learning_rate": 0.1}, device="cpu")
    dp8 = tparallel.ShardedTrainer(nets[1], loss_fn, "sgd",
                                   {"learning_rate": 0.1},
                                   mesh=_mesh(dp=8))
    for _ in range(3):
        a, b = one.step(X, Y), dp8.step(X, Y)
        assert abs(float(a) - float(b)) <= 1e-6
    for tr in (one, dp8):
        tr.sync_back()
    for p1, p2, w in zip(nets[0].collect_params().values(),
                         nets[1].collect_params().values(), want):
        np.testing.assert_allclose(p2.data().asnumpy(), p1.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p2.data().asnumpy(), w, **TOL)


def test_sharded_trainer_loss_decreases():
    np.random.seed(1)
    trandom.seed(1)
    X = np.random.randn(64, 8).astype("float32")
    Y = (X @ np.random.randn(8, 4).astype("float32")).argmax(1)
    with tmx.cpu():
        net = tnn.HybridSequential()
        with net.name_scope():
            net.add(tnn.Dense(32, activation="relu", in_units=8),
                    tnn.Dense(4, in_units=32))
        net.initialize(tinit.Xavier())
    st = tparallel.ShardedTrainer(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                                  "adam", {"learning_rate": 0.01},
                                  mesh=_mesh(dp=8))
    losses = [float(st.step(X, Y.astype("float32"))) for _ in range(20)]
    assert losses[-1] < losses[0] * 0.5


def _convbn(pkg, init, ctx):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(4, in_units=8))
    net.initialize(init.Xavier(), ctx=ctx)
    return net


def test_step_many_matches_repeated_step_and_accumulates_bn_stats():
    """dp=8 step_many equals 4 dp=8 steps, which equal 4 one-device steps:
    BatchNorm's batch moments and moving statistics are the global
    batch's (the reference's SPMD semantics)."""
    np.random.seed(3)
    trandom.seed(3)
    X = np.random.randn(4, 16, 3, 8, 8).astype("float32")
    Y = np.random.randint(0, 4, (4, 16)).astype("float32")
    with tmx.cpu():
        nets = [_convbn(tmx, tinit, tmx.cpu()) for _ in range(3)]
    for other in nets[1:]:
        for p1, p2 in zip(nets[0].collect_params().values(),
                          other.collect_params().values()):
            p2.set_data(p1.data())
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    kw = dict(optimizer_params={"learning_rate": 0.05})
    st0 = tparallel.ShardedTrainer(nets[0], loss_fn, "sgd", device="cpu",
                                   **kw)
    st1 = tparallel.ShardedTrainer(nets[1], loss_fn, "sgd",
                                   mesh=_mesh(dp=8), **kw)
    st2 = tparallel.ShardedTrainer(nets[2], loss_fn, "sgd",
                                   mesh=_mesh(dp=8), **kw)
    l0 = [float(st0.step(X[i], Y[i])) for i in range(4)]
    l1 = [float(st1.step(X[i], Y[i])) for i in range(4)]
    l2 = st2.step_many(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
    for st in (st0, st1, st2):
        st.sync_back()
    for (n, p0), p1, p2 in zip(nets[0].collect_params().items(),
                               nets[1].collect_params().values(),
                               nets[2].collect_params().values()):
        assert np.array_equal(p1.data().asnumpy(), p2.data().asnumpy()), n
        np.testing.assert_allclose(p1.data().asnumpy(), p0.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        if n.endswith("running_mean"):
            assert np.abs(p2.data().asnumpy()).max() > 1e-6, n
        if n.endswith("running_var"):
            assert np.abs(p2.data().asnumpy() - 1.0).max() > 1e-6, n


def test_step_many_twice_then_eval_and_sync_back():
    np.random.seed(4)
    trandom.seed(4)
    X = np.random.randn(2, 8, 3, 8, 8).astype("float32")
    Y = np.random.randint(0, 4, (2, 8)).astype("float32")
    with tmx.cpu():
        net = _convbn(tmx, tinit, tmx.cpu())
    st = tparallel.ShardedTrainer(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.05},
                                  mesh=_mesh(dp=8))
    before = {n: t.detach().clone() for n, t in net.named_parameters()}
    st.step_many(torch.from_numpy(X), torch.from_numpy(Y))
    st.step_many(torch.from_numpy(X), torch.from_numpy(Y))
    # the block's trainable tensors wait for sync_back
    for n, t in net.named_parameters():
        if t.requires_grad:
            assert torch.equal(t, before[n]), n
    st.sync_back()
    with tmx.cpu():
        out = net(tmx.nd.array(X[0]))
    assert np.isfinite(out.asnumpy()).all()
    ev = st.forward(torch.from_numpy(X[0]))
    np.testing.assert_allclose(ev.numpy(), out.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    st.step_many(torch.from_numpy(X), torch.from_numpy(Y))
    for p in net.collect_params().values():
        assert np.isfinite(p.data().asnumpy()).all()


def test_tensor_parallel_transformer_step():
    """dp=4 x tp=2 over ``tp_rules()``: each rule's parameter reports its
    spec and holds 1/tp a position; the steps equal the reference's
    (same draws, dropout 0) and the port's one-device run."""
    from mxnet_tpu.models import transformer_lm_tiny as jtiny
    from mxnet_tpu_torch.models import TransformerLM, tp_rules
    np.random.seed(0)
    tokens = np.random.randint(0, 64, (8, 16))
    jmx.random.seed(0)
    np.random.seed(0)
    jnet = jtiny(vocab_size=64)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(tokens.astype("int32")))

    class _ShiftLoss(jgluon.loss.Loss):
        def __init__(self):
            super().__init__(None, 0)
            self._ce = jgluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, logits, tokens):
            return self._ce(logits[:, :-1].reshape((-3, 0)),
                            tokens[:, 1:].reshape((-1,)))

    jst = jparallel.ShardedTrainer(jnet, _ShiftLoss(), "adam",
                                   {"learning_rate": 1e-3},
                                   mesh=jparallel.make_mesh(dp=4, tp=2),
                                   param_rules=jmx.models.tp_rules())
    jt = jmx.nd.array(tokens.astype("int32"))
    want = [float(jst.step(jt, jt).asnumpy()) for _ in range(2)]
    ref_params = {n: p.data().asnumpy()
                  for n, p in jnet.collect_params().items()}

    def shift_loss(logits, toks):
        ce = tgluon.loss.SoftmaxCrossEntropyLoss()
        return ce(logits[:, :-1].reshape(-1, logits.shape[-1]),
                  toks[:, 1:].reshape(-1))

    runs = {}
    for kind in ("one", "mesh"):
        net = TransformerLM(64, units=64, num_layers=2, num_heads=4,
                            max_len=256, device="cpu")
        params = tmx.gluon.collect_params(net)
        for (n, p), v in zip(params.items(), ref_params.values()):
            p.set_data(v)
        kw = {"device": "cpu"} if kind == "one" else {
            "mesh": tparallel.make_mesh(dp=4, tp=2, devices=CPUS),
            "param_rules": tp_rules()}
        st = tparallel.ShardedTrainer(net, shift_loss, "adam",
                                      {"learning_rate": 1e-3}, **kw)
        t = torch.from_numpy(tokens)
        runs[kind] = (st, [float(st.step(t, t)) for _ in range(2)])
    st, got = runs["mesh"]
    np.testing.assert_allclose(got, runs["one"][1], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] < got[0]
    ref_names = list(tmx.gluon.collect_params(st._block).keys())
    for (name, v), rname in zip(st.values.items(), ref_names):
        if rname.endswith("qkv_weight"):
            assert v.spec in (P("tp", None), P("tp"))
        if rname.endswith("proj_weight"):
            assert v.spec == P(None, "tp")
        if v.spec.normalized():
            for s in v.shards:
                assert s.numel() * 2 == int(np.prod(v.shape)), rname
    st.sync_back()
    one = runs["one"][0]
    one.sync_back()
    for (n, a), b in zip(st._block.named_parameters(),
                         one._block.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_sharded_trainer_init_owns_param_buffers():
    trandom.seed(0)
    np.random.seed(0)
    with tmx.cpu():
        net = tnn.Sequential()
        net.add(tnn.Dense(4, in_units=8))
        net.initialize(tinit.Xavier())
    x = np.random.rand(8, 8).astype("float32")
    y = np.random.randint(0, 4, (8,)).astype("float32")
    block_ptrs = {t.data_ptr() for t in net.parameters()}
    before = [t.detach().clone() for t in net.parameters()]
    for kw in ({"device": "cpu"}, {"mesh": _mesh(dp=8)},
               {"mesh": _mesh(dp=8), "dtype": "float32"}):
        tr = tparallel.ShardedTrainer(
            net, tgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, **kw)
        assert np.isfinite(float(tr.step(x, y)))
        for t, b in zip(net.parameters(), before):
            assert torch.equal(t, b)        # the block's are untouched
        if "mesh" in kw:
            ptrs = [s.data_ptr() for v in tr.values.values()
                    for s in v.shards]
            assert len(set(ptrs)) == len(ptrs)
            assert not set(ptrs) & block_ptrs
    with tmx.cpu():
        out = net(tmx.nd.array(x))
    assert np.isfinite(out.asnumpy()).all()


def test_batchnorm_and_syncbatchnorm_moments_over_replicas():
    """Inside a mesh step's replicas, BatchNorm's and SyncBatchNorm's
    moments are the global batch's (SyncBatchNorm: over ``comm_axis``
    when the step's data axes hold it, local otherwise); the replica
    group runs in lock step and refuses replicas that diverge."""
    from mxnet_tpu_torch.ops import nn as tops
    from mxnet_tpu_torch.ops import spatial_ops
    from mxnet_tpu_torch.parallel.replicas import ReplicaGroup
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 4, 4, generator=g)
    gamma, beta = torch.rand(3, generator=g), torch.rand(3, generator=g)
    mm, mv = torch.zeros(3), torch.ones(3)
    mesh = tparallel.make_mesh(dp=4, devices=CPUS[:4])

    def run(fn):
        group = ReplicaGroup(mesh, ("dp",), [torch.device("cpu")] * 4)
        return group.run([lambda r=r: fn(x[2 * r:2 * r + 2])
                          for r in range(4)])
    bn = dict(fix_gamma=False, train=True, output_mean_var=True)
    whole = tops.BatchNorm(x, gamma, beta, mm, mv, **bn)
    parts = run(lambda xs: tops.BatchNorm(xs, gamma, beta, mm, mv, **bn))
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), whole[0],
                               rtol=1e-6, atol=1e-6)
    for p in parts:
        torch.testing.assert_close(p[1], whole[1], rtol=1e-6, atol=1e-7)
    sbn = dict(fix_gamma=False, output_mean_var=True)
    whole = spatial_ops.SyncBatchNorm.fn(x, gamma, beta, mm, mv, **sbn)
    parts = run(lambda xs: spatial_ops.SyncBatchNorm.fn(
        xs, gamma, beta, mm, mv, comm_axis="dp", **sbn))
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), whole[0],
                               rtol=1e-5, atol=1e-5)
    local = run(lambda xs: spatial_ops.SyncBatchNorm.fn(
        xs, gamma, beta, mm, mv, comm_axis="tp", **sbn))
    for r, p in enumerate(local):
        own = spatial_ops.SyncBatchNorm.fn(x[2 * r:2 * r + 2], gamma, beta, mm,
                                        mv, **sbn)
        assert torch.equal(p[1], own[1])
    with pytest.raises(RuntimeError, match="different collectives"):
        # only replica 0 reaches the collective
        run(lambda xs: tops.BatchNorm(xs, gamma, beta, mm, mv, **bn)
            if xs.data_ptr() == x.data_ptr() else xs)


def test_replica_group_runs_one_replica_at_a_time():
    """16 replicas (more than the cores) with a short switch interval
    bump a shared counter without a lock between 30 exchanges each: one
    replica runs at a time, so no update is lost, and every exchange
    hands back the replicas' values in replica order."""
    import sys
    import threading
    from mxnet_tpu_torch.parallel.replicas import ReplicaGroup, current
    n, rounds = 16, 30
    mesh = tparallel.make_mesh(dp=n, devices=[tmx.cpu(0)] * n)
    counter = [0]
    seen = []

    def body():
        rep = current()
        for k in range(rounds):
            v = counter[0]
            counter[0] = v + 1          # a read-modify-write, unlocked
            got = rep.exchange((k, rep.index))
            assert got == [(k, r) for r in range(n)]
        seen.append(rep.index)
        return rep.index
    result = {}
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        group = ReplicaGroup(mesh, ("dp",), [torch.device("cpu")] * n)
        th = threading.Thread(target=lambda: result.setdefault(
            "out", group.run([body] * n)))
        th.start()
        th.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not th.is_alive()
    assert result["out"] == list(range(n))
    assert counter[0] == n * rounds and seen == list(range(n))


def test_exports_resolve_as_in_the_reference():
    """``mx.parallel``, ``mx.models``, ``mx.kvstore`` and ``mx.sym``'s
    subgraph surface carry the reference's names (``initialize``,
    ``rank`` and ``size`` are several processes: ROADMAP item 10b)."""
    import mxnet_tpu.models as jmodels
    import mxnet_tpu.symbol.subgraph as jsub
    names = [n for n in dir(jparallel) if not n.startswith("_")
             and n not in ("initialize", "rank", "size", "Mesh")
             and not isinstance(getattr(jparallel, n), type(jparallel))]
    assert len(names) >= 24
    for n in names:
        assert hasattr(tparallel, n), n
    assert tparallel.Mesh is tmesh.Mesh
    for n in ("tp_rules", "MoETransformerLM", "moe_lm_tiny"):
        assert hasattr(jmodels, n) and hasattr(tmx.models, n), n
    for n in jsub.__all__:
        assert hasattr(tmx.sym.subgraph, n), n
    assert tmx.kv.create is tmx.kvstore.create
    assert tmx.parallel.ShardedTrainer is \
        tmx.parallel.trainer.ShardedTrainer
