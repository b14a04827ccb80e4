"""The port's ``metric`` module and ``gluon.contrib.estimator`` against the
JAX package's, on the CPU.

- Every metric, fed the same numpy predictions and labels (as each
  package's NDArrays; the port's also as torch tensors), gives the
  reference's values exactly: both compute on the host with numpy.
- ``Estimator.fit`` of the same net (the reference's parameters copied
  into the port's) over the same ``DataLoader`` batches, with logging,
  checkpoint and early-stopping handlers, logs the reference's losses and
  metric values epoch by epoch: losses within ``LOSS_TOL`` (1e-5) relative
  (the forward and backward sum in other orders), accuracies exactly; the
  checkpoint each writes loads into the other.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib import estimator as jest
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.gluon.parameter import load_param_from_array

LOSS_TOL = 1e-5
R = np.random.RandomState(21)
N, F, C = 32, 4, 3


@pytest.fixture(autouse=True)
def _names():
    """Leave both packages' block-name counters as found."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock
    saved = [(m, dict(m._global_counter)) for m in (jblock, tblock)]
    yield
    for m, counts in saved:
        m._global_counter.clear()
        m._global_counter.update(counts)


# ---------------------------------------------------------------- metrics

def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _metric_cases():
    r = np.random.RandomState(5)
    probs = _softmax(r.randn(16, 5))
    labels = r.randint(0, 5, 16).astype(np.float32)
    bprobs = _softmax(r.randn(16, 2))
    blabels = r.randint(0, 2, 16).astype(np.float32)
    reg = r.randn(16, 1).astype(np.float32)
    reg_label = (reg[:, 0] + 0.3 * r.randn(16)).astype(np.float32)
    seq = _softmax(r.randn(4, 6, 5))
    seq_label = r.randint(0, 5, (4, 6)).astype(np.float32)
    seq_label[0, :2] = 2
    loss = r.rand(16).astype(np.float32)

    def mae(label, pred):
        return float(np.abs(label - pred.ravel()).mean())
    return [
        ("Accuracy", {}, labels, probs),
        ("Accuracy", {"axis": 2}, seq_label, seq),
        ("TopKAccuracy", {"top_k": 3}, labels, probs),
        ("F1", {}, blabels, bprobs),
        ("F1", {"average": "micro"}, blabels, bprobs),
        ("MCC", {}, blabels, bprobs),
        ("MCC", {"average": "micro"}, blabels, bprobs),
        ("Perplexity", {"ignore_label": 2}, seq_label, seq),
        ("Perplexity", {}, labels, probs),
        ("MAE", {}, reg_label, reg),
        ("MSE", {}, reg_label, reg),
        ("RMSE", {}, reg_label, reg),
        ("CrossEntropy", {}, labels, probs),
        ("NegativeLogLikelihood", {}, labels, probs),
        ("PearsonCorrelation", {}, reg_label, reg[:, 0]),
        ("Loss", {}, None, loss),
        ("np", {"fn": mae}, reg_label, reg),
        ("create", {"name": "acc"}, labels, probs),
        ("create", {"name": ["mse", "mae"]}, reg_label, reg),
    ]


def _make(metric_mod, name, kw):
    if name == "np":
        return metric_mod.np(kw["fn"])
    if name == "create":
        return metric_mod.create(kw["name"])
    return getattr(metric_mod, name)(**kw)


@pytest.mark.parametrize("case", range(len(_metric_cases())))
def test_metric_equals_the_reference(case):
    name, kw, label, pred = _metric_cases()[case]
    values = []

    def port_array(a):
        return tnd.array(a, ctx=tmx.cpu())
    for mod, wrap in ((jmx.metric, jnd.array), (tmx.metric, port_array),
                      (tmx.metric, torch.from_numpy)):
        m = _make(mod, name, kw)
        for half in (slice(0, 8), slice(8, None)):
            lab = None if label is None else [wrap(label[half])]
            m.update(lab, [wrap(pred[half])])
        values.append((m.get(), m.get_name_value()))
        m.reset()
        assert np.isnan(np.asarray(m.get()[1], dtype=float)).all()
    assert values[1] == values[0], (name, values)
    assert values[2] == values[0], (name, values)


def test_metric_registry_and_composite():
    for n in ("acc", "accuracy", "ce", "nll_loss", "f1",
              "mcc", "perplexity", "mae", "mse", "rmse", "pearsonr", "loss"):
        a, b = jmx.metric.create(n), tmx.metric.create(n)
        assert type(a).__name__ == type(b).__name__, n
    comp = tmx.metric.CompositeEvalMetric(["acc", "mse"])
    assert [type(m).__name__ for m in comp.metrics] == ["Accuracy", "MSE"]
    with pytest.raises(ValueError):
        tmx.metric.create("no_such_metric")
    assert tmx.metric.Accuracy().get_config()["metric"] == "Accuracy"


# -------------------------------------------------------------- estimator

def _data(n=N):
    X = R.randn(n, F).astype(np.float32)
    Y = (X[:, 0] + X[:, 1] > 0).astype(np.float32) + (X[:, 2] > 1)
    return X, Y.astype(np.float32)


def _nets():
    jnet, tnet = jgluon.nn.HybridSequential(), tgluon.nn.HybridSequential()
    for pkg, net in ((jgluon, jnet), (tgluon, tnet)):
        net.add(pkg.nn.Dense(8, in_units=F, activation="relu"),
                pkg.nn.Dense(C, in_units=8))
    jnet.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tnet.initialize()
    for a, b in zip(jnet.collect_params().values(),
                    tnet.collect_params().values()):
        load_param_from_array(b, a.data().asnumpy())
    return jnet, tnet


class _Record:
    """An epoch-end handler that keeps every metric's value."""

    def __init__(self, est_mod):
        rec = self

        class Handler(est_mod.EpochEnd):
            def epoch_end(self, estimator, *a, **k):
                rec.epochs.append([
                    m.get() for m in estimator.train_metrics
                    + estimator.train_loss_metrics + estimator.val_metrics
                    + estimator.val_loss_metrics])
        self.epochs = []
        self.handler = Handler()


def _fit(pkg, est_mod, net, tmp, X, Y, **fit_kw):
    ctx = pkg.cpu()
    loader = pkg.gluon.data.DataLoader(
        pkg.gluon.data.ArrayDataset(X, Y), batch_size=16)
    val = pkg.gluon.data.DataLoader(
        pkg.gluon.data.ArrayDataset(X[:16], Y[:16]), batch_size=8)
    est = est_mod.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
        metrics=[pkg.metric.Accuracy()], context=ctx,
        trainer=pkg.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.5}))
    rec = _Record(est_mod)
    stop = est_mod.EarlyStoppingHandler(monitor=est.train_loss_metrics[0],
                                        patience=0, mode="min",
                                        min_delta=1e9)
    ckpt = est_mod.CheckpointHandler(tmp, model_prefix="m",
                                     max_checkpoints=1)
    logs = []

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            logs.append(msg.split(": ", 1)[-1] if "finished" in msg else msg)
    log = logging.getLogger(est_mod.event_handler.__name__)
    keep = Keep()
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    try:
        est.fit(loader, val_data=val, event_handlers=[
            rec.handler, stop, ckpt, est_mod.LoggingHandler(
                metrics=est.train_metrics + est.train_loss_metrics)],
            **fit_kw)
    finally:
        log.removeHandler(keep)
    return est, rec.epochs, stop, logs


def test_estimator_fit_matches_the_reference(tmp_path):
    """Two epochs (early stopping ends a fit of five after the second: no
    loss can improve by 1e9), validation each epoch, a checkpoint a
    epoch: the port logs the reference's values, and each package's
    checkpoint loads into the other."""
    X, Y = _data()
    jnet, tnet = _nets()
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    _, jep, jstop, jlogs = _fit(jmx, jest, jnet, str(tmp_path / "j"), X, Y,
                                epochs=5)
    with tmx.cpu():
        _, tep, tstop, tlogs = _fit(tmx, test_, tnet, str(tmp_path / "t"),
                                    X, Y, epochs=5)
    assert len(jep) == len(tep) == 2
    assert jstop.stopped_epoch == tstop.stopped_epoch == 1
    for je, te in zip(jep, tep):
        assert [n for n, _ in je] == [n for n, _ in te]
        for (n, jv), (_, tv) in zip(je, te):
            if "loss" in n:
                assert abs(tv - jv) <= LOSS_TOL * abs(jv), (n, tv, jv)
            else:
                assert tv == jv, (n, tv, jv)
    assert len(jlogs) == len(tlogs) and jlogs[0] == tlogs[0]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == ["m-epoch2.params"]
    # each package's checkpoint into the other: the trained values
    j2, _ = _nets()
    j2.load_parameters(str(tmp_path / "t" / "m-epoch2.params"))
    with tmx.cpu():
        _, t2 = _nets()
        t2.load_parameters(str(tmp_path / "j" / "m-epoch2.params"))
    for got, want in ((j2, tnet), (t2, jnet)):
        for a, b in zip(got.collect_params().values(),
                        want.collect_params().values()):
            np.testing.assert_array_equal(a.data().asnumpy(),
                                          b.data().asnumpy())


def test_estimator_fit_by_batches_and_evaluate():
    X, Y = _data()
    with tmx.cpu():
        _, tnet = _nets()
        loader = tgluon.data.DataLoader(
            tgluon.data.ArrayDataset(X, Y), batch_size=16)
        est = test_.Estimator(tnet, tgluon.loss.SoftmaxCrossEntropyLoss())
        seen = []

        class Count(test_.BatchEnd):
            def batch_end(self, estimator, *a, **k):
                seen.append(k["loss"].shape)
        est.fit(loader, batches=4, event_handlers=[Count()])
        assert est.stop_training and len(seen) == 4
        est.evaluate(loader)
        name, value = est.val_loss_metrics[0].get()
        assert name == "validation loss" and np.isfinite(value)


def test_estimator_rejects_non_dataloader():
    with tmx.cpu():
        est = test_.Estimator(_nets()[1],
                              tgluon.loss.SoftmaxCrossEntropyLoss())
        with pytest.raises(ValueError):
            est.fit(train_data=[1, 2, 3], epochs=1)
        X, Y = _data(16)
        loader = tgluon.data.DataLoader(tgluon.data.ArrayDataset(X, Y),
                                        batch_size=8)
        with pytest.raises(ValueError):
            est.fit(train_data=loader)       # neither epochs nor batches
        with pytest.raises(ValueError):
            test_.Estimator(_nets()[1], loss="not a loss")


def test_estimator_defaults_to_the_current_context():
    """With no ``context`` the estimator takes ``current_context()``: the
    card, which this CPU box does not have (the card tests check it
    there); inside ``with cpu()`` the CPU."""
    net = _nets()[1]
    with tmx.cpu():
        assert test_.Estimator(
            net, tgluon.loss.L2Loss()).context == [tmx.cpu()]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            test_.Estimator(net, tgluon.loss.L2Loss())
