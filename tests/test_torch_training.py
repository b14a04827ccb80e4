"""The port's training path against the JAX package.

- The Dropout op's keep mask must equal the reference's ``_hash_keep_mask``
  bit for bit when both get the same two key words, and the op's output
  must match.
- ``SoftmaxCrossEntropyLoss`` and the Adam/SGD update rules must match the
  reference at atol/rtol 1e-6 (fp32; the same arithmetic, op for op).
- The port's single-device ``ShardedTrainer`` with Adam (and NAG, LAMB)
  must follow the JAX ``ShardedTrainer`` (``make_mesh(dp=1)`` over one
  device) on a small
  TransformerLM (units 64, 2 layers, 2 heads, vocab 64, batch 4, seq 16,
  dropout 0, lr 1e-3, fp32) over 5 steps: losses and the parameters after
  ``sync_back`` at atol 1e-4 (summation order only). Both take their plain
  attention path on the CPU; the flash backward is held against the Pallas
  one in ``tests/test_torch_flash_backward.py``.
- The same 5 steps with ``dtype="bfloat16"`` on both sides: bf16 losses
  within one bf16 ulp, the parameters within the drift that Adam allows
  (see ``test_trainer_follows_reference_adam_bf16``).
- ``MXTPU_DROPOUT_THREEFRY=1`` is refused by name wherever dropout would
  run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.optimizer import optimizer as jopt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.nn import Dropout as DropoutLayer
from mxnet_tpu_torch.models import TransformerLM
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.optimizer import optimizer as topt
from mxnet_tpu_torch.parallel import ShardedTrainer, functional_optimizer

torch.set_num_threads(1)

VOCAB, UNITS, LAYERS, HEADS, BATCH, SEQ = 64, 64, 2, 2, 4, 16
ATOL = 1e-4


@pytest.mark.parametrize("shape,axes", [
    ((7,), ()), ((4, 33), ()), ((2, 16, 64), ()), ((2, 16, 64), (1,)),
    ((3, 5, 8, 9), (0, 2))])
@pytest.mark.parametrize("words", [(0, 0), (123456789, 2 ** 32 - 1),
                                   (0xDEADBEEF, 42)])
def test_dropout_mask_bitwise(shape, axes, words):
    mshape = tuple(1 if i in axes else n for i, n in enumerate(shape))
    ref = np.asarray(jnn._hash_keep_mask(jnp.asarray(words, jnp.uint32),
                                         mshape, 0.7))
    out = tnn._hash_keep_mask(words, mshape, 0.7).numpy()
    np.testing.assert_array_equal(out, ref)
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        "float32")
    ref = np.asarray(jnn.Dropout.fn(jnp.asarray(x), p=0.3, axes=axes,
                                    key=jnp.asarray(words, jnp.uint32),
                                    train=True))
    out = tnn.Dropout(torch.from_numpy(x), p=0.3, axes=axes, key=words,
                      train=True).numpy()
    np.testing.assert_array_equal(out, ref)


def test_dropout_identity_off_training_and_layer_draws_keys():
    x = torch.randn(4, 8)
    assert tnn.Dropout(x, p=0.5, key=(1, 2)) is x
    layer = DropoutLayer(0.5)
    assert layer.eval()(x) is x
    layer.train()
    trandom.seed(3)
    a = layer(x)
    trandom.seed(3)
    words = trandom.next_key()
    assert torch.equal(a, tnn.Dropout(x, p=0.5, key=words, train=True))
    assert not torch.equal(layer(x), a)          # the next key differs


def test_softmax_ce_matches():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((3, 5, 11)).astype("float32")
    label = rng.integers(0, 11, (3, 5)).astype("int32")
    label[0, 2] = -1                              # ignored
    ref = jgluon.loss.SoftmaxCrossEntropyLoss()(nd.array(pred),
                                                nd.array(label)).asnumpy()
    out = SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                    torch.from_numpy(label)).numpy()
    assert out.shape == (3,)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 6, 50), (256, 2), (64, 1000)])
def test_softmax_ce_bf16_matches_bitwise(shape):
    """In bf16 the loss is taken in ``pred``'s type, op for op, as the
    reference takes it: the same bf16 values, also at the NSP head's
    (256, 2)."""
    rng = np.random.default_rng(1)
    pred = (3 * rng.standard_normal(shape)).astype("float32")
    label = rng.integers(0, shape[-1], shape[:-1]).astype("int32")
    label.reshape(-1)[3] = -1
    ref = jgluon.loss.SoftmaxCrossEntropyLoss()(
        nd.array(pred).astype("bfloat16"), nd.array(label))
    assert str(ref.dtype) == "bfloat16"
    out = SoftmaxCrossEntropyLoss()(torch.from_numpy(pred).bfloat16(),
                                    torch.from_numpy(label))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.astype("float32").asnumpy())


def _rule_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((5, 7)).astype("float32") for _ in range(4)]


@pytest.mark.parametrize("rule", ["adam", "sgd_mom", "sgd"])
def test_update_rules_match(rule):
    w, m, v, _ = _rule_inputs(1)
    m, v = np.zeros_like(w), np.zeros_like(w)
    tw, tm, tv = (torch.from_numpy(x.copy()) for x in (w, m, v))
    lr, wd, rescale, clip = 0.01, 1e-3, 0.5, 0.8
    for t in (1, 2, 3):
        g = _rule_inputs(10 + t)[3]
        if rule == "adam":
            w, m, v = (np.asarray(x) for x in jopt._adam(
                jnp.asarray(w), jnp.asarray(m), jnp.asarray(v),
                jnp.asarray(g), lr, wd, 0.9, 0.999, 1e-8, rescale, clip, t))
            topt._adam(tw, tm, tv, torch.from_numpy(g), lr, wd, 0.9, 0.999,
                       1e-8, rescale, clip, t)
        elif rule == "sgd_mom":
            w, m = (np.asarray(x) for x in jopt._sgd_mom(
                jnp.asarray(w), jnp.asarray(m), jnp.asarray(g), lr, wd, 0.9,
                rescale, clip))
            topt._sgd_mom(tw, tm, torch.from_numpy(g), lr, wd, 0.9, rescale,
                          clip)
        else:
            w = np.asarray(jopt._sgd(jnp.asarray(w), jnp.asarray(g), lr, wd,
                                     rescale, clip))
            topt._sgd(tw, torch.from_numpy(g), lr, wd, rescale, clip)
        np.testing.assert_allclose(tw.numpy(), w, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tm.numpy(), m, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tv.numpy(), v, atol=1e-6, rtol=1e-6)


def test_functional_optimizer_refuses_unported():
    """``nag`` and ``lamb`` are ported; a name the reference does not take
    raises the reference's ``ValueError``."""
    init, _ = functional_optimizer("sgd")
    assert init(torch.zeros(3)) == ()
    for name, n_states in (("nag", 1), ("lamb", 2)):
        init, update = functional_optimizer(name, momentum=0.9)
        w = torch.ones(3)
        state = init(w)
        assert len(state) == n_states
        update(w, torch.ones(3), state, 1, 0.1)
        assert bool((w < 1).all())
    with pytest.raises(ValueError) as ref:
        jparallel.functional_optimizer("rmsprop")
    with pytest.raises(ValueError) as own:
        functional_optimizer("rmsprop")
    assert str(own.value) == str(ref.value)


def _batches(n):
    """``n`` (tokens, next-token labels) pairs; the last label is -1
    (ignored), so the loss is over the shifted logits."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        x = rng.integers(0, VOCAB, (BATCH, SEQ)).astype("int32")
        y = np.concatenate([x[:, 1:], np.full((BATCH, 1), -1, "int32")], 1)
        out.append((x, y))
    return out


def _pair():
    mx.random.seed(0)
    jnet = JaxLM(VOCAB, units=UNITS, num_layers=LAYERS, num_heads=HEADS,
                 max_len=SEQ, dropout=0.0)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 8), "int32")))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                         num_heads=HEADS, max_len=SEQ, device="cpu")
    convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)
    return jnet, tnet


@pytest.mark.parametrize("name,hyper", [
    ("adam", {"learning_rate": 1e-3}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01})],
    ids=["adam", "nag", "lamb"])
def test_trainer_follows_reference_adam(name, hyper):
    """5 steps of the functional ``name`` (Adam, and since the eager
    surface was ported NAG and LAMB) against the reference's."""
    jnet, tnet = _pair()
    jtr = jparallel.ShardedTrainer(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), name, dict(hyper),
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    ttr = ShardedTrainer(tnet, SoftmaxCrossEntropyLoss(), name, dict(hyper),
                         device="cpu")
    for x, y in _batches(5):
        ref = float(jtr.step(nd.array(x), nd.array(y)).asnumpy())
        loss = ttr.step(x, y)
        assert loss.shape == ()
        np.testing.assert_allclose(float(loss), ref, atol=ATOL, rtol=ATOL)
    jtr.sync_back()
    ttr.sync_back()
    ref = convert.state_dict_from_mxnet(
        {k: p.data().asnumpy() for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    own = tnet.state_dict()
    assert set(own) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(own[name].numpy(), r.numpy(), atol=ATOL,
                                   rtol=ATOL, err_msg=name)


def test_trainer_follows_reference_adam_bf16():
    """``test_trainer_follows_reference_adam`` with ``dtype="bfloat16"`` on
    both sides.

    Tolerances: each loss is bf16 and within one bf16 ulp (2^-7 relative)
    of the reference's; on this CPU they come out equal. The parameters
    are bf16 and within ``5 steps x 2 x lr`` = 1e-2 absolute: where a bf16
    gradient is near zero, the two packages' bf16 backward passes (rounded
    op by op, in other orders) can give it opposite signs, and Adam's first
    steps move such a weight by about ``lr`` in the sign's direction. The
    mean difference of every tensor must stay under 1e-3, a tenth of that,
    so the bound cannot hide a systematic drift."""
    jnet, tnet = _pair()
    lr = 1e-3
    jtr = jparallel.ShardedTrainer(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": lr}, dtype="bfloat16",
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    ttr = ShardedTrainer(tnet, SoftmaxCrossEntropyLoss(), "adam",
                         {"learning_rate": lr}, dtype="bfloat16",
                         device="cpu")
    steps = _batches(5)
    for x, y in steps:
        ref = jtr.step(nd.array(x), nd.array(y)).asnumpy()
        loss = ttr.step(x, y)
        assert str(ref.dtype) == "bfloat16" and loss.dtype == torch.bfloat16
        np.testing.assert_allclose(float(loss), float(ref), rtol=2.0 ** -7,
                                   atol=0)
    jtr.sync_back()
    ttr.sync_back()
    ref = convert.state_dict_from_mxnet(
        {k: p.data().asnumpy().astype("float32")
         for k, p in jnet.collect_params().items()}, prefix=jnet.prefix)
    own = tnet.state_dict()
    assert set(own) == set(ref)
    for name, r in ref.items():
        assert own[name].dtype == torch.bfloat16, name
        diff = np.abs(own[name].float().numpy() - r.numpy())
        assert diff.max() <= len(steps) * 2 * lr, (name, diff.max())
        assert diff.mean() <= 0.1 * len(steps) * 2 * lr, (name, diff.mean())


@pytest.mark.parametrize("where", ["op", "layer"])
def test_dropout_refuses_threefry(monkeypatch, where):
    x = torch.randn(4, 8)
    monkeypatch.setenv("MXTPU_DROPOUT_THREEFRY", "1")
    # no dropout runs: nothing to refuse
    assert tnn.Dropout(x, p=0.5, key=(1, 2)) is x
    assert tnn.Dropout(x, p=0.0, key=(1, 2), train=True) is x
    with pytest.raises(NotImplementedError, match="MXTPU_DROPOUT_THREEFRY"):
        if where == "op":
            tnn.Dropout(x, p=0.5, key=(1, 2), train=True)
        else:
            DropoutLayer(0.5).train()(x)
    monkeypatch.setenv("MXTPU_DROPOUT_THREEFRY", "0")
    assert tnn.Dropout(x, p=0.5, key=(1, 2), train=True).shape == x.shape


def _tiny_net():
    torch.manual_seed(0)
    return TransformerLM(VOCAB, units=32, num_layers=1, num_heads=2,
                         max_len=SEQ, dropout=0.1, device="cpu")


def test_trainer_bf16_state_step_many_and_refusals():
    net = _tiny_net()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tr = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                        {"learning_rate": 1e-3}, dtype="bfloat16",
                        device="cpu")
    (x, y), = _batches(1)
    losses = tr.step_many(np.stack([x, x]), np.stack([y, y]))
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    for name, v in tr.values.items():
        assert v.dtype == torch.bfloat16 and v.grad.dtype == torch.bfloat16
        assert all(s.dtype == torch.bfloat16 for s in tr._states[name])
    # the block changes only at sync_back, and takes the trainer's values
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert net.training
    tr.sync_back()
    assert net.head.weight.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="TUPLE"):
        tr.step([x], y)
    tr.set_learning_rate(0.5)
    assert tr.learning_rate == 0.5
    # a sharding plan trains over a mesh (ROADMAP item 10a)
    from mxnet_tpu_torch.parallel.planner import ShardingPlan
    planned = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                             plan=ShardingPlan(dp=2), device="cpu")
    assert planned.mesh.size == 2 and planned.plan.dp == 2
    assert bool(torch.isfinite(planned.step(x, y)))


def test_trainer_dropout_steps_repeat_under_one_seed():
    (x, y), = _batches(1)
    runs = []
    for _ in range(2):
        net = _tiny_net()
        tr = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                            {"learning_rate": 1e-3}, device="cpu")
        trandom.seed(11)
        runs.append([float(tr.step(x, y)) for _ in range(2)])
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]
