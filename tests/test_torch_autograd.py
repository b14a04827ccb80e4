"""The port's ``autograd`` (over torch's autograd) against the JAX
package's tape.

The same numpy inputs in both packages, on the CPU: the recording and
training flags of ``record``/``pause``/``train_mode``/``predict_mode``;
``attach_grad`` with ``grad_req`` write (each backward's own gradient)
and add (the sum); head gradients; ``autograd.grad`` (with a variable the
heads do not reach: zeros); a custom ``Function``; ``mark_variables``;
the in-place update regression (``p -= lr * p.grad`` keeps ``p`` a marked
leaf, over several steps); and the aux-state sinks, eagerly and through a
``CachedOp``. Float32 at 1e-5 (sums in another order).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import _tape as jtape
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _tape as ttape
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.cached_op import CachedOp

torch.set_num_threads(1)
TOL = 1e-5
PAIRS = ((jnd, jag), (tnd, tag))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _x(seed=0, shape=(3, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _close(own, ref):
    np.testing.assert_allclose(own.asnumpy(), ref.asnumpy(), atol=TOL,
                               rtol=TOL)


def test_scopes_set_the_flags():
    for _, ag in PAIRS:
        seen = []
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            seen.append((ag.is_recording(), ag.is_training()))
        assert seen == [(True, True), (False, False), (True, False),
                        (True, False), (False, True)]
        assert not ag.is_recording() and not ag.is_training()


def test_ops_record_only_inside_record():
    x = tnd.array(_x())
    x.attach_grad()
    y = x * 2
    assert not y._data.requires_grad
    with pytest.raises(ValueError, match="record"):
        y.backward()
    with tag.record():
        z = x * 2
    assert z._data.requires_grad


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_write_and_add(req):
    x0, w0 = _x(1), _x(2, (4, 2))
    out = []
    for F, ag in PAIRS:
        x, w = F.array(x0), F.array(w0)
        x.attach_grad(req)
        w.attach_grad(req)
        for scale in (1.0, 3.0):
            with ag.record():
                y = F.dot(F.tanh(x * scale), w).sum()
            y.backward()
        out.append((x.grad, w.grad))
    for own, ref in zip(out[1], out[0]):
        _close(own, ref)


def test_head_grads_and_retain_graph():
    x0, g0 = _x(3), _x(4, (3, 2))
    out = []
    for F, ag in PAIRS:
        x = F.array(x0)
        x.attach_grad()
        with ag.record():
            y = F.dot(x.exp(), F.ones((4, 2))) * x.sum()
        y.backward(F.array(g0), retain_graph=True)
        first = x.grad.copy()
        ag.backward([y], [F.array(g0 * 2)])
        out.append((first, x.grad))
    for own, ref in zip(out[1], out[0]):
        _close(own, ref)


def test_grad_function():
    x0, z0 = _x(5), _x(6)
    out = []
    for F, ag in PAIRS:
        x, z, u = F.array(x0), F.array(z0), F.array(z0)
        x.attach_grad()
        z.attach_grad()
        u.attach_grad()
        with ag.record():
            y = (x * x * z).sum() + F.sigmoid(z).sum()
        gx, gz, gu = ag.grad(y, [x, z, u])
        out.append((gx, gz, gu))
        assert float(x.grad.abs().sum().asscalar()) == 0.0
    for own, ref in zip(out[1], out[0]):
        _close(own, ref)


def test_custom_function():
    x0 = _x(7)
    out = []
    for F, ag in PAIRS:
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = 1 / (1 + F.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y) * 2.0   # scaled: the user's rule

        x = F.array(x0)
        x.attach_grad()
        with ag.record():
            y = Sigmoid()(x)
            loss = (y * y).sum()
        loss.backward()
        out.append((y, x.grad))
    for own, ref in zip(out[1], out[0]):
        _close(own, ref)


def test_mark_variables():
    x0 = _x(8)
    out = []
    for F, ag in PAIRS:
        x, g = F.array(x0), F.zeros((3, 4))
        ag.mark_variables([x], [g])
        with ag.record():
            y = (x ** 3).sum()
        y.backward()
        out.append(x.grad)
    _close(out[1], out[0])


def test_inplace_update_keeps_the_leaf():
    """The verify skill's regression: ``p -= lr * p.grad`` in an eager
    loop keeps ``p`` a marked leaf, step after step."""
    p0, x0 = _x(9, (4,)), _x(10, (5, 4))
    out = []
    for F, ag in PAIRS:
        p, x = F.array(p0), F.array(x0)
        p.attach_grad()
        losses = []
        for _ in range(4):
            with ag.record():
                loss = (F.dot(x, p) ** 2).mean()
            loss.backward()
            p -= 0.05 * p.grad
            losses.append(float(loss.asscalar()))
        out.append((p, losses))
        assert p._is_leaf
    _close(out[1][0], out[0][0])
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=TOL)


def test_aux_sinks():
    for F, tape in ((jnd, jtape), (tnd, ttape)):
        h = F.zeros((2,))
        tape.aux_write(h, F.ones((2,))._data)
        np.testing.assert_array_equal(h.asnumpy(), [1.0, 1.0])
        sink = tape.push_aux_sink()
        tape.aux_write(h, (F.ones((2,)) * 3)._data)
        assert tape.pop_aux_sink() is sink and len(sink) == 1
        np.testing.assert_array_equal(h.asnumpy(), [1.0, 1.0])
    # through a CachedOp: the write lands after the call
    stat = tnd.zeros((4,))

    def fn(x):
        ttape.aux_write(stat, (x.sum(axis=0) * 0.5)._data)
        return x * 2

    op = CachedOp(fn)
    y = op(tnd.array(_x(11)))
    _close(y, tnd.array(_x(11) * 2))
    np.testing.assert_allclose(stat.asnumpy(), _x(11).sum(0) * 0.5,
                               rtol=TOL)
