"""The port's eager ``gluon.Trainer`` against the JAX package's.

A 2-layer ``TransformerLM`` (units 64, 2 heads, vocab 64, dropout 0) on
each side, initialized from one seed with ``Xavier()`` (bit-equal weights:
``tests/test_torch_initializer.py``), 5 eager steps at batch 4, seq 16:
forward, the per-sample ``SoftmaxCrossEntropyLoss``, ``backward`` of the
loss vector (a ones head gradient), ``trainer.step(batch)``. The reference
records under ``autograd.record()`` (its net hybridized, so that its
program compiles once for the file). Losses agree to 1e-5 and every
parameter to 1e-4 (fp32, sums in another order), for SGD with momentum,
NAG, Adam and LAMB. Also held:

- ``clip_global_norm`` against the reference (the norm and the scaled
  arrays, clipping and not);
- ``save_states``/``load_states``: a trainer restored after 2 steps
  continues bit for bit;
- ``grad_req``: two backward passes before a step leave the second pass's
  gradient under ``"write"`` and their sum under ``"add"``, as in the
  reference; ``"null"`` is skipped by the step;
- a ``dist*`` store is refused by name.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import utils as tutils
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import TransformerLM

torch.set_num_threads(1)

VOCAB, UNITS, LAYERS, HEADS, BATCH, SEQ = 64, 64, 2, 2, 4, 16


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, VOCAB, (BATCH, SEQ)).astype("int32")
        y = np.concatenate([x[:, 1:], np.full((BATCH, 1), -1, "int32")], 1)
        out.append((x, y))
    return out


def _ref_net():
    jnet = JaxLM(VOCAB, units=UNITS, num_layers=LAYERS, num_heads=HEADS,
                 max_len=SEQ, dropout=0.0)
    jnet.hybridize()
    return jnet


@pytest.fixture(scope="module")
def shared_ref_net():
    """One hybridized reference net for the trainer cases (each
    re-initializes it), so that its program compiles once."""
    return _ref_net()


def _pair(jnet=None):
    jnet = _ref_net() if jnet is None else jnet
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier(), force_reinit=True)
    tnet = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                         num_heads=HEADS, max_len=SEQ, device="cpu")
    params = collect_params(tnet, prefix=jnet.prefix)
    trandom.seed(0)
    params.initialize(tinit.Xavier())
    return jnet, tnet, params


def _ref_step(jnet, jtr, loss_fn, x, y):
    with jautograd.record():
        loss = loss_fn(jnet(nd.array(x)), nd.array(y))
    loss.backward()
    jtr.step(BATCH)
    return loss.asnumpy()


def _own_step(tnet, params, ttr, loss_fn, x, y):
    loss = loss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward(torch.ones_like(loss))
    ttr.step(BATCH)
    return loss.detach().numpy()


CASES = {"sgd": {"learning_rate": 0.05, "momentum": 0.9},
         "nag": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
         "adam": {"learning_rate": 1e-3},
         "lamb": {"learning_rate": 1e-3, "wd": 0.01}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_follows_reference(name, shared_ref_net):
    hyper = CASES[name]
    jnet, tnet, params = _pair(shared_ref_net)
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(hyper))
    ttr = Trainer(params, name, dict(hyper))
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = SoftmaxCrossEntropyLoss()
    for x, y in _batches(5):
        ref = _ref_step(jnet, jtr, jloss, x, y)
        own = _own_step(tnet, params, ttr, tloss, x, y)
        np.testing.assert_allclose(own, ref, atol=1e-5, rtol=1e-5)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 5
    assert ttr.learning_rate == jtr.learning_rate
    for k, p in jnet.collect_params().items():
        np.testing.assert_allclose(params[k].tensor().detach().numpy(),
                                   p.data().asnumpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype("float32")
              for s in ((4, 5), (7,), (2, 3, 3))]
    ref = [nd.array(a) for a in arrays]
    own = [torch.from_numpy(a.copy()) for a in arrays]
    ref_norm = jgluon.utils.clip_global_norm(ref, max_norm)
    own_norm = tutils.clip_global_norm(own, max_norm)
    # float32 sums of squares in another order, then the same host sum
    np.testing.assert_allclose(own_norm, ref_norm, rtol=1e-6, atol=0)
    for o, r, a in zip(own, ref, arrays):
        np.testing.assert_allclose(o.numpy(), r.asnumpy(), atol=1e-7,
                                   rtol=1e-7)
        if max_norm > 1e3:
            np.testing.assert_array_equal(o.numpy(), a)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tutils.clip_global_norm([torch.tensor([float("inf")])], 1.0)
    assert any("nan or inf" in str(w.message) for w in caught)


def test_save_and_load_states_continue_bitwise(tmp_path):
    batches = _batches(4)
    runs = []
    for restore in (False, True):
        _, tnet, params = _pair()
        ttr = Trainer(params, "adam", {"learning_rate": 1e-3})
        loss_fn = SoftmaxCrossEntropyLoss()
        for i, (x, y) in enumerate(batches):
            if restore and i == 2:
                ttr.save_states(str(tmp_path / "adam.states"))
                ttr = Trainer(params, "sgd", {"learning_rate": 9.0})
                ttr.load_states(str(tmp_path / "adam.states"))
                assert type(ttr.optimizer).__name__ == "Adam"
                assert ttr.optimizer.param_dict[0] is \
                    params[sorted(params.keys())[0]]
            _own_step(tnet, params, ttr, loss_fn, x, y)
        runs.append([p.tensor().detach().clone() for p in params.values()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_matches_reference(req, shared_ref_net):
    jnet, tnet, params = _pair(shared_ref_net)
    jparams = jnet.collect_params()
    jparams.setattr("grad_req", req)
    params.setattr("grad_req", req)
    try:
        _two_passes_match(req, jnet, tnet, params)
    finally:
        jparams.setattr("grad_req", "write")


def _two_passes_match(req, jnet, tnet, params):
    jparams = jnet.collect_params()
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = SoftmaxCrossEntropyLoss()
    (x1, y1), (x2, y2) = _batches(2, seed=11)
    for x, y in ((x1, y1), (x2, y2)):
        with jautograd.record():
            jl = jloss(jnet(nd.array(x)), nd.array(y))
        jl.backward()
        tl = tloss(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward(torch.ones_like(tl))
    second = {}
    if req == "write":                     # the second pass alone
        probe = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                              num_heads=HEADS, max_len=SEQ, device="cpu")
        probe.load_state_dict(tnet.state_dict())
        pl = tloss(probe(torch.from_numpy(x2)), torch.from_numpy(y2))
        pl.backward(torch.ones_like(pl))
        second = dict(zip(params.keys(), (p.grad for p in
                                          probe.parameters())))
    for k, p in jparams.items():
        own = params[k].grad_tensor()
        np.testing.assert_allclose(own.numpy(), p.grad().asnumpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        if req == "write":
            assert torch.equal(own, second[k]), k


def test_null_grad_req_is_not_updated_and_refusals(monkeypatch):
    _, tnet, params = _pair()
    frozen = next(k for k in params.keys() if k.endswith("_embed_weight"))
    params[frozen].grad_req = "null"
    assert not params[frozen].tensor().requires_grad
    before = params[frozen].tensor().clone()
    ttr = Trainer(params, "sgd", {"learning_rate": 0.1})
    (x, y), = _batches(1)
    _own_step(tnet, params, ttr, SoftmaxCrossEntropyLoss(), x, y)
    assert torch.equal(params[frozen].tensor(), before)
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        params[frozen].grad()
    # a dist_sync store in one process is a world of one; a job of
    # several is tests/test_torch_dist.py's
    dist = Trainer(params, "sgd", {"learning_rate": 0.1},
                   kvstore="dist_sync")
    _own_step(tnet, params, dist, SoftmaxCrossEntropyLoss(), x, y)
    assert dist._kvstore.type == "dist_sync" and \
        dist._kvstore.num_workers == 1
    assert torch.equal(params[frozen].tensor(), before)
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    with pytest.raises(MXNetError, match="parallel.initialize"):
        Trainer(params, "sgd", kvstore="dist_sync").allreduce_grads()
    with pytest.raises(ValueError, match="list or dict of Parameters"):
        Trainer(3, "sgd")


@pytest.mark.parametrize("num_slice,axis,even", [(1, 0, True), (2, 0, True),
                                                 (3, 1, False),
                                                 (4, 1, True)])
def test_split_data_matches_reference(num_slice, axis, even):
    data = np.arange(8 * 7, dtype="float32").reshape(8, 7)
    if even and data.shape[axis] % num_slice:
        with pytest.raises(ValueError, match="evenly split"):
            tutils.split_data(torch.from_numpy(data), num_slice, axis)
        with pytest.raises(ValueError, match="evenly split"):
            jgluon.utils.split_data(nd.array(data), num_slice, axis)
        return
    ref = jgluon.utils.split_data(nd.array(data), num_slice, axis, even)
    own = tutils.split_data(torch.from_numpy(data), num_slice, axis, even)
    assert len(own) == len(ref) == num_slice
    for o, r in zip(own, ref):
        np.testing.assert_array_equal(o.numpy(), r.asnumpy())
    loaded = tutils.split_and_load(data, ["cpu"], axis)
    assert len(loaded) == 1 and loaded[0].device == torch.device("cpu")
    np.testing.assert_array_equal(loaded[0].numpy(), data)


def test_check_sha1(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(b"mxnet" * 1000)
    digest = "6b3e6d1ad8e5b8d2b8bc5ddbe0e5cbca4a8e7de4"
    assert tutils.check_sha1(str(path), digest) == \
        jgluon.utils.check_sha1(str(path), digest)
    import hashlib
    good = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert tutils.check_sha1(str(path), good)


def test_trainer_update_and_learning_rate():
    _, tnet, params = _pair()
    ttr = Trainer(params, "sgd", {"learning_rate": 0.1, "rescale_grad": 2.0})
    assert ttr.learning_rate == 0.1
    ttr.set_learning_rate(0.05)
    assert ttr.learning_rate == 0.05
    (x, y), = _batches(1)
    loss = SoftmaxCrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                     torch.from_numpy(y))
    loss.backward(torch.ones_like(loss))
    key = sorted(params.keys())[0]
    w0 = params[key].tensor().detach().clone()
    g = params[key].grad_tensor().clone()
    ttr.update(BATCH)
    assert ttr.optimizer.rescale_grad == 2.0 / BATCH
    torch.testing.assert_close(params[key].tensor().detach(),
                               w0 - 0.05 * (g * (2.0 / BATCH)))
    params.zero_grad()
    assert not params[key].grad_tensor().any()
