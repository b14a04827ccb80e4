"""The port's RNN family against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, and the same parameters go
through ``mxnet_tpu`` and ``mxnet_tpu_torch`` (``ctx=cpu()``: the port's
layers then run the plain per-step loop). Tolerances:

- fp32 outputs and states within ``OUT_TOL`` (1e-5) of each output's
  largest |value|, and gradients within ``GRAD_TOL`` (1e-4) of each
  gradient's (the scan and the loop sum in other orders);
- the Sequence ops, ``_rnn_param_concat``, the contrib reshapes
  (``PixelShuffle``, ``Concurrent``), ``BucketSentenceIter``'s batches
  and every metric exactly;
- dropout: the fused ``RNN`` op's inter-layer mask is the port's lowbias32
  ``Dropout`` on a key folded from the layer (the reference draws threefry,
  not ported), held through the op to its keep rate and its ``1/(1-p)``
  scaling; the layers' ``Dropout`` is the lowbias32 hash, held
  bit for bit to the reference's on injected key words, never through
  dispatch.

What the reference cannot run is held to a plain numpy loop: the Sequence
ops with lengths along axis 1 (the reference's ``SequenceLast`` raises
there and its ``SequenceReverse`` reverses axis 0).
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.models import RNNModel as JRNNModel
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon.contrib import nn as tcnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.gluon.parameter import load_param_from_array
from mxnet_tpu_torch.models import RNNModel as TRNNModel
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn as trnn

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
T, B, I, H = 6, 3, 8, 12
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True)
def _cpu_and_names():
    """The port on the CPU; both packages' block-name counters left as
    found (later tests compare names that the counters number)."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock
    saved = [(m, dict(m._global_counter)) for m in (jblock, tblock)]
    with tmx.cpu():
        yield
    for m, counts in saved:
        m._global_counter.clear()
        m._global_counter.update(counts)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, want, tol=OUT_TOL, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, "%s[%d]" % (what, i))
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, "%s: %g of max > %g" % (what, err, tol)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _both(op, *arrays, **kw):
    """``op`` through both registries (eager dispatch) on the same numpy
    inputs."""
    j = jreg.get_op(op)(*[jnd.array(a) for a in arrays], **kw)
    t = treg.get_op(op)(*[tnd.array(a) for a in arrays], **kw)
    return j, t


def _both_jit(op, *arrays, **kw):
    """``op``'s function in both packages: the reference's under one
    ``jax.jit`` (eagerly, each of its scans compiles apart), the port's on
    CPU tensors."""
    import jax
    j = jax.jit(lambda *a: jreg.get_op(op).fn(*a, **kw))(*arrays)
    t = treg.get_op(op).fn(*[torch.from_numpy(a) for a in arrays], **kw)
    return [np.asarray(v) for v in j], list(t)


# ------------------------------------------------------------ sequence ops

def _seq_data(axis):
    x = _rng(1).randn(*((T, B, 4) if axis == 0 else (B, T, 4)))
    return x.astype(np.float32), np.array([2, 6, 4], np.float32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_mask(axis, lengths):
    x, sl = _seq_data(axis)
    args = (x, sl) if lengths else (x,)
    j, t = _both("SequenceMask", *args, use_sequence_length=lengths,
                 value=-7.0, axis=axis)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    j, t = _both("sequence_mask", *args, use_sequence_length=lengths,
                 axis=axis)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("op", ["SequenceLast", "SequenceReverse"])
@pytest.mark.parametrize("axis,lengths", [(0, False), (0, True), (1, False)])
def test_sequence_last_and_reverse(op, axis, lengths):
    x, sl = _seq_data(axis)
    args = (x, sl) if lengths else (x,)
    j, t = _both(op, *args, use_sequence_length=lengths, axis=axis)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_sequence_ops_with_lengths_on_axis_1_against_numpy():
    x, sl = _seq_data(1)
    last = treg.get_op("SequenceLast")(tnd.array(x), tnd.array(sl),
                                       use_sequence_length=True, axis=1)
    rev = treg.get_op("SequenceReverse")(tnd.array(x), tnd.array(sl),
                                         use_sequence_length=True, axis=1)
    want_last = np.stack([x[b, int(n) - 1] for b, n in enumerate(sl)])
    want_rev = x.copy()
    for b, n in enumerate(sl.astype(int)):
        want_rev[b, :n] = x[b, :n][::-1]
    np.testing.assert_array_equal(last.asnumpy(), want_last)
    np.testing.assert_array_equal(rev.asnumpy(), want_rev)


def test_rnn_param_concat_and_names():
    a, b = _rng(2).randn(3, 4), _rng(3).randn(2, 4)
    for name in ("_rnn_param_concat", "_npi_rnn_param_concat"):
        j = jreg.get_op(name)(jnd.array(a), jnd.array(b), dim=0)
        t = treg.get_op(name)(tnd.array(a), tnd.array(b), dim=0)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    for name in ("SequenceMask", "sequence_mask", "SequenceLast",
                 "SequenceReverse", "RNN", "_npx_rnn", "_rnn_scan_layer",
                 "_rnn_param_concat", "_npi_rnn_param_concat"):
        assert treg.get_op(name) is not None, name


# ------------------------------------------------------------ scan and RNN

def _layer_arrays(mode, seed, inp=I):
    G = {"lstm": 4, "gru": 3}.get(mode, 1)
    r = _rng(seed)
    return [r.uniform(-0.4, 0.4, s).astype(np.float32) for s in
            ((T, B, inp), (G * H, inp), (G * H, H), (G * H,), (G * H,),
             (B, H), (B, H))]


@pytest.mark.parametrize("mode,reverse", [
    ("lstm", False), ("gru", True), ("rnn_tanh", False), ("rnn_relu", True)])
def test_rnn_scan_layer(mode, reverse):
    arrays = _layer_arrays(mode, 4)
    if mode != "lstm":
        arrays = arrays[:-1]
    j, t = _both_jit("_rnn_scan_layer", *arrays, mode=mode, reverse=reverse)
    _close(t, j, what=mode)
    j, t = _both("_rnn_scan_layer", *arrays, mode=mode, reverse=reverse)
    assert len(t) == len(j) and isinstance(t[0], tnd.NDArray)


def _flat_params(mode, layers, bidir, seed):
    size = trnn.rnn_param_size(layers, I, H, bidir, mode)
    from mxnet_tpu.ops import rnn as jrnn
    assert size == jrnn.rnn_param_size(layers, I, H, bidir, mode)
    return _rng(seed).uniform(-0.3, 0.3, size).astype(np.float32)


@pytest.mark.parametrize("mode,bidir,layers", [
    (m, b, n) for i, m in enumerate(MODES)
    for b, n in (((False, 1), (True, 2)) if i % 2 else
                 ((False, 2), (True, 1)))])
def test_fused_rnn_op(mode, bidir, layers):
    """Every mode, uni- and bidirectional, 1 and 2 layers (each mode in two
    of the four combinations)."""
    D = 2 if bidir else 1
    r = _rng(5)
    x = r.randn(T, B, I).astype(np.float32)
    params = _flat_params(mode, layers, bidir, 6)
    h0 = r.randn(layers * D, B, H).astype(np.float32) * 0.5
    args = [x, params, h0]
    if mode == "lstm":
        args.append(r.randn(layers * D, B, H).astype(np.float32) * 0.5)
    kw = dict(state_size=H, num_layers=layers, bidirectional=bidir,
              mode=mode, p=0.3)
    j, t = _both_jit("RNN", *args, state_outputs=True, **kw)
    assert len(t) == (3 if mode == "lstm" else 2)
    _close(t, j, what="RNN %s" % mode)
    # through dispatch (outside training: no dropout), and the other name
    t2 = treg.get_op("_npx_rnn")(*[tnd.array(a) for a in args], **kw)
    np.testing.assert_array_equal(t2[0].asnumpy(), t[0].numpy())


def test_fused_rnn_dropout_keep_rate_and_scaling():
    """Through the op itself: the second of two ``rnn_relu`` layers is the
    identity (``w_ih = I``, the rest 0) on the first layer's positive
    output, so the op's output is the dropped first layer."""
    p, Bw = 0.4, 256
    x = torch.ones(T, Bw, H)
    params = torch.zeros(trnn.rnn_param_size(2, H, H, mode="rnn_relu"))
    sets = trnn._split_rnn_params(params, 2, H, H, 1, 1)
    sets[0][0][0].copy_(torch.from_numpy(_rng(7).rand(H, H)))
    sets[0][0][2].fill_(0.1)
    sets[1][0][0].copy_(torch.eye(H))
    h0 = torch.zeros(2, Bw, H)
    kw = dict(state_size=H, num_layers=2, mode="rnn_relu", p=p)
    on = trnn.RNN(x, params, h0, key=(3, 9), train=True, **kw)[0]
    again = trnn.RNN(x, params, h0, key=(3, 9), train=True, **kw)[0]
    other = trnn.RNN(x, params, h0, key=(4, 9), train=True, **kw)[0]
    off = trnn.RNN(x, params, h0, key=(3, 9), train=False, **kw)[0]
    assert torch.equal(on, again) and not torch.equal(on, other)
    torch.testing.assert_close(off, trnn.RNN(x, params, h0, **kw)[0],
                               rtol=0, atol=0)
    assert bool((off > 0).all())
    # kept values scaled by 1/(1-p), the rest 0, at the keep rate
    kept = on != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(on[kept], off[kept] / (1 - p))
    # the mask is the keyed lowbias32 Dropout's on the layer's folded key
    want = tmx.ops.nn.Dropout(off, p, key=trnn.layer_key((3, 9), 0),
                              train=True)
    torch.testing.assert_close(on, want, rtol=0, atol=0)


def test_projection_size_is_refused():
    x = np.zeros((T, B, I), np.float32)
    params = _flat_params("lstm", 1, False, 8)
    h = np.zeros((1, B, H), np.float32)
    with pytest.raises(NotImplementedError):
        jreg.get_op("RNN").fn(jnd.array(x)._data, jnd.array(params)._data,
                              jnd.array(h)._data, jnd.array(h)._data,
                              state_size=H, projection_size=4)
    with pytest.raises(NotImplementedError):
        trnn.RNN(torch.from_numpy(x), torch.from_numpy(params),
                    torch.from_numpy(h), torch.from_numpy(h), state_size=H,
                    projection_size=4)
    with pytest.raises(NotImplementedError):
        tgluon.rnn.LSTM(H, projection_size=4)


# ------------------------------------------------------------------ cells

def _copy_params(jblock, tblock):
    """The reference block's values into the port's, by order (deferred
    ones take the shape)."""
    jp = list(jblock.collect_params().values())
    tp = list(tblock.collect_params().values())
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        load_param_from_array(b, a.data().asnumpy())


def _cells(pkg):
    r = pkg.gluon.rnn
    c = pkg.gluon.contrib.rnn

    def seq(kind):
        s = kind()
        s.add(r.LSTMCell(H, input_size=I))
        s.add(r.DropoutCell(0.5))
        s.add(r.GRUCell(H, input_size=H))
        return s
    return {
        "rnn": lambda: r.RNNCell(H, input_size=I),
        "rnn_relu": lambda: r.RNNCell(H, activation="relu"),
        "lstm": lambda: r.LSTMCell(H, input_size=I),
        "gru": lambda: r.GRUCell(H),
        "sequential": lambda: seq(r.SequentialRNNCell),
        "hybrid_sequential": lambda: seq(r.HybridSequentialRNNCell),
        "zoneout": lambda: r.ZoneoutCell(r.LSTMCell(H, input_size=I)),
        "residual": lambda: r.ResidualCell(r.GRUCell(I, input_size=I)),
        "bidirectional": lambda: r.BidirectionalCell(
            r.LSTMCell(H, input_size=I), r.GRUCell(H, input_size=I)),
        "vardrop": lambda: c.VariationalDropoutCell(
            r.LSTMCell(H, input_size=I), drop_inputs=0.3, drop_states=0.3,
            drop_outputs=0.3),
        "lstmp": lambda: c.LSTMPCell(H, 5, input_size=I),
    }


_CORE_CELLS = ("lstm", "gru", "rnn", "bidirectional")


@pytest.mark.parametrize("name,layout,valid", [
    (n, lay, v) for i, n in enumerate(_cells(jmx))
    for lay, v in ((("NTC", True), ("TNC", False)) if n in _CORE_CELLS
                   else ((("NTC", True),) if i % 2 else (("TNC", False),)))])
def test_cell_unroll(name, layout, valid):
    """Every cell's ``unroll`` (outside training: its dropout is the
    identity) with merged outputs, with and without ``valid_length``
    (the four basic cells both ways, the others one way each)."""
    r = _rng(9)
    shape = (B, T, I) if layout == "NTC" else (T, B, I)
    x = r.randn(*shape).astype(np.float32)
    vl = np.array([3, 6, 1], np.float32)
    jcell, tcell = _cells(jmx)[name](), _cells(tmx)[name]()
    jcell.initialize(jmx.init.Xavier())
    if any(p._data is None for p in jcell.collect_params().values()):
        jcell.unroll(T, jnd.array(x), layout=layout)    # deferred shapes
    tcell.initialize()
    _copy_params(jcell, tcell)
    kw = dict(layout=layout, merge_outputs=True)
    if valid:
        kw["valid_length"] = vl
    jout, jst = jcell.unroll(T, jnd.array(x), **dict(
        kw, valid_length=jnd.array(vl)) if valid else kw)
    tout, tst = tcell.unroll(T, tnd.array(x), **dict(
        kw, valid_length=tnd.array(vl)) if valid else kw)
    _close(tout, jout, what=name)
    _close(list(tst), list(jst), what=name + " states")
    if not valid:       # the outputs as a list of steps
        jo, _ = jcell.unroll(T, jnd.array(x), layout=layout,
                             merge_outputs=False)
        to, _ = tcell.unroll(T, tnd.array(x), layout=layout,
                             merge_outputs=False)
        _close(list(to), list(jo), what=name + " steps")


def test_begin_state_follows_the_context():
    cell = tgluon.rnn.LSTMCell(H, input_size=I)
    assert [s.shape for s in cell.begin_state(4)] == [(4, H), (4, H)]
    assert all(s.ctx == tmx.cpu() for s in cell.begin_state(4))
    layer = tgluon.rnn.GRU(H, 2, bidirectional=True)
    st = layer.begin_state(5, dtype="float32")
    assert [s.shape for s in st] == [(4, 5, H)]


def test_variational_dropout_one_mask_per_sequence():
    cell = tcrnn.VariationalDropoutCell(tgluon.rnn.RNNCell(H, input_size=I),
                                        drop_outputs=0.5)
    cell.initialize()
    x = tnd.array(np.ones((B, T, I), np.float32))
    with tag.record():
        out, _ = cell.unroll(T, x, layout="NTC", merge_outputs=True)
    zero = out.asnumpy() == 0
    assert zero.any() and not zero.all()
    assert (zero == zero[:, :1]).all()      # the same mask at every step


# ----------------------------------------------------------------- layers

def _layer(pkg, mode, layout, layers=2, bidir=False, dropout=0.0):
    r = pkg.gluon.rnn
    kw = dict(layout=layout, bidirectional=bidir, dropout=dropout,
              input_size=I)
    if mode == "lstm":
        return r.LSTM(H, layers, **kw)
    if mode == "gru":
        return r.GRU(H, layers, **kw)
    return r.RNN(H, layers, activation=mode[4:], **kw)


def _loss(out, cot, with_states):
    """``sum(out * cot)``, plus the new states' squares when given."""
    o = out[0] if with_states else out
    loss = (o * cot).sum()
    if with_states:
        loss = loss + sum((s * s).sum() for s in out[1])
    return loss


def _ref_grads(block, x, states, cot):
    """The reference block's outputs, and the gradients of :func:`_loss`
    for its input and parameters, as one ``jax.jit`` of
    ``jax.value_and_grad`` over the block run on traced values (its eager
    tape compiles every scan and its transpose apart: ~4x the time)."""
    import jax
    from mxnet_tpu.ndarray.ndarray import NDArray as JND
    params = list(block.collect_params().values())

    def f(vals, xv):
        saved = []
        for p, v in zip(params, vals):
            d = p._data[0]
            saved.append((d, d._data))
            d._data = v
        try:
            st = None if states is None else [JND(s) for s in states]
            out = block(JND(xv)) if st is None else block(JND(xv), st)
        finally:
            for d, old in saved:
                d._data = old
        out = out._data if st is None else \
            (out[0]._data, [s._data for s in out[1]])
        return _loss(out, cot, st is not None), out

    vals = [p.data()._data for p in params]
    (_, out), (gv, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(vals, x)
    return out, [gx] + list(gv)


def _port_grads(block, x, states, cot):
    xs = tnd.array(x)
    xs.attach_grad()
    st = None if states is None else [tnd.array(s) for s in states]
    with tag.record():
        out = block(xs) if st is None else block(xs, st)
        loss = _loss(out, tnd.array(cot), st is not None)
    loss.backward()
    grads = [xs.grad] + [p.grad() for p in block.collect_params().values()]
    return out, grads


@pytest.mark.parametrize("mode,layout,bidir,layers,with_states", [
    ("lstm", "TNC", True, 1, True), ("gru", "NTC", False, 2, False),
    ("rnn_tanh", "NTC", True, 1, True), ("rnn_relu", "TNC", False, 2, False)])
def test_layer_forward_and_gradients(mode, layout, bidir, layers,
                                     with_states):
    """``LSTM``, ``GRU`` and ``RNN`` in both layouts, uni- and
    bidirectional, with and without states: outputs, new states and the
    gradients of the input and of every parameter."""
    r = _rng(10)
    x = r.randn(*((T, B, I) if layout == "TNC" else (B, T, I))) \
        .astype(np.float32)
    jl = _layer(jmx, mode, layout, layers, bidir=bidir)
    tl = _layer(tmx, mode, layout, layers, bidir=bidir)
    jl.initialize(jmx.init.Xavier())
    tl.initialize()
    _copy_params(jl, tl)
    D = 2 if bidir else 1
    states = [r.randn(layers * D, B, H).astype(np.float32)
              for _ in range(2 if mode == "lstm" else 1)] \
        if with_states else None
    cot = r.randn(*((T, B, D * H) if layout == "TNC" else (B, T, D * H))) \
        .astype(np.float32)
    jout, jg = _ref_grads(jl, x, states, cot)
    tout, tg = _port_grads(tl, x, states, cot)
    if with_states:
        tout, jout = [tout[0]] + list(tout[1]), [jout[0]] + list(jout[1])
    _close(_np(tout), [np.asarray(v) for v in jout] if with_states
           else np.asarray(jout), what="%s out" % mode)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, np.asarray(b), GRAD_TOL, what="%s grad %d" % (mode, i))


def test_layer_names_shapes_and_deferred_input():
    jl, tl = jgluon.rnn.LSTM(H, 2, bidirectional=True), \
        tgluon.rnn.LSTM(H, 2, bidirectional=True)
    strip = (lambda n: n.split("_", 1)[1])
    assert [strip(n) for n in tl.collect_params()] == \
        [strip(n) for n in jl.collect_params()]
    tl.initialize()
    tl(tnd.array(np.zeros((T, B, 5), np.float32)))
    assert tl.l0_i2h_weight.shape == (4 * H, 5)
    assert tl.l1_i2h_weight.shape == (4 * H, 2 * H)
    assert tl.r1_h2h_weight.shape == (4 * H, H)


def test_hybridized_layer_keeps_the_states_nesting():
    """A hybridized ``LSTM`` takes its states as a list and returns
    ``(out, [h, c])`` as the eager call does, with the same values; a
    second call with new states reuses the one CachedOp."""
    r = _rng(13)
    tl = tgluon.rnn.LSTM(H, 2, input_size=I)
    tl.initialize()
    x = tnd.array(r.randn(T, B, I).astype(np.float32))
    states = [tnd.array(r.randn(2, B, H).astype(np.float32))
              for _ in range(2)]
    out, new = tl(x, states)
    tl.hybridize()
    for _ in range(2):
        hout, hnew = tl(x, states)
        assert isinstance(hnew, list) and len(hnew) == 2
        np.testing.assert_array_equal(hout.asnumpy(), out.asnumpy())
        for a, b in zip(hnew, new):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert len(tl._cached_ops) == 1


def test_layer_dropout_is_the_keyed_dropout(monkeypatch):
    """Between layers in training both packages draw the lowbias32 mask
    from their key words: with the same words (injected) the outputs
    agree; the RNN layers themselves are held above."""
    import jax.numpy as jnp
    from mxnet_tpu_torch import random as trandom
    words = (12345, 678)
    monkeypatch.setitem(jreg.get_op("Dropout").state_binders, "key",
                        lambda: jnp.array(words, dtype=jnp.uint32))
    monkeypatch.setattr(trandom, "next_key", lambda generator=None: words)
    r = _rng(11)
    x = r.randn(T, B, I).astype(np.float32)
    jl, tl = _layer(jmx, "gru", "TNC", 2, dropout=0.5), \
        _layer(tmx, "gru", "TNC", 2, dropout=0.5)
    jl.initialize(jmx.init.Xavier())
    tl.initialize()
    _copy_params(jl, tl)
    import jax
    from mxnet_tpu.ndarray.ndarray import NDArray as JND

    def ref(xv):        # one jit: eagerly each scan compiles apart
        with jag.train_mode():
            return jl(JND(xv))._data
    jo = np.asarray(jax.jit(ref)(x))
    with tag.train_mode():
        to = tl(tnd.array(x))
    _close(to, jo, what="dropout between layers")
    with tag.train_mode():      # the same words: the same masks
        np.testing.assert_array_equal(tl(tnd.array(x)).asnumpy(),
                                      to.asnumpy())
    # outside training no mask
    assert not np.allclose(to.asnumpy(), tl(tnd.array(x)).asnumpy())


# ----------------------------------------------------------------- models

@pytest.mark.parametrize("mode,tie", [("lstm", False), ("gru", True)])
def test_rnn_model(mode, tie):
    """``RNNModel`` untied and tied: names, logits, new states and every
    parameter's gradient (the tied weight's sums both uses)."""
    r = _rng(12)
    V = 40
    jnet = JRNNModel(mode, V, 16, 16, 2, dropout=0.0, tie_weights=tie)
    jnet.initialize(jmx.init.Xavier())
    params = {k: v.data().asnumpy() for k, v in
              jnet.collect_params().items()}
    tnet = TRNNModel(mode, V, 16, 16, 2, dropout=0.0, tie_weights=tie)
    convert.load_mxnet_params(tnet, params)
    assert [n.split("_", 1)[1] for n in tnet.collect_params()] == \
        [n.split("_", 1)[1] for n in params]
    x = r.randint(0, V, (T, B)).astype(np.float32)
    hid = [r.randn(2, B, 16).astype(np.float32) * 0.3
           for _ in range(2 if mode == "lstm" else 1)]
    cot = r.randn(T, B, V).astype(np.float32)
    jout, jg = _ref_grads(jnet, x, hid, cot)
    tout, tg = _port_grads(tnet, x, hid, cot)
    _close([tout[0]] + list(tout[1]),
           [np.asarray(jout[0])] + [np.asarray(v) for v in jout[1]],
           what="logits and states")
    assert len(tg) == len(jg) == len(params) + 1
    for n, a, b in zip(params, tg[1:], jg[1:]):
        _close(a, np.asarray(b), GRAD_TOL, what=n)
    if tie:
        assert tnet.decoder._parameters["weight"] is \
            tnet.encoder._parameters["weight"]


# ------------------------------------------------------------ contrib nn

def test_contrib_layers():
    r = _rng(13)
    x = r.randn(2, 4).astype(np.float32)
    jnet, tnet = jcnn.HybridConcurrent(axis=1), tcnn.HybridConcurrent(axis=1)
    jnet.add(jgluon.nn.Dense(3, in_units=4), jcnn.Identity())
    tnet.add(tgluon.nn.Dense(3, in_units=4), tcnn.Identity())
    jnet.initialize()
    tnet.initialize()
    _copy_params(jnet, tnet)
    _close(tnet(tnd.array(x)), jnet(jnd.array(x)), what="HybridConcurrent")
    np.testing.assert_array_equal(tnet(tnd.array(x)).asnumpy()[:, 3:], x)
    jc, tc = jcnn.Concurrent(axis=1), tcnn.Concurrent(axis=1)
    jc.add(jcnn.Identity(), jcnn.Identity())
    tc.add(tcnn.Identity(), tcnn.Identity())
    np.testing.assert_array_equal(tc(tnd.array(x)).asnumpy(),
                                  jc(jnd.array(x)).asnumpy())
    for cls, shape, f in (("PixelShuffle1D", (1, 6, 5), 3),
                          ("PixelShuffle2D", (2, 12, 3, 2), (2, 3)),
                          ("PixelShuffle3D", (1, 16, 2, 3, 2), 2)):
        a = r.randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(
            getattr(tcnn, cls)(f)(tnd.array(a)).asnumpy(),
            getattr(jcnn, cls)(f)(jnd.array(a)).asnumpy())
    je, te = jcnn.SparseEmbedding(10, 6), tcnn.SparseEmbedding(10, 6)
    je.initialize()
    te.initialize()
    _copy_params(je, te)
    ids = np.array([1, 5, 9], np.float32)
    np.testing.assert_array_equal(te(tnd.array(ids)).asnumpy(),
                                  je(jnd.array(ids)).asnumpy())
    jb, tb = jcnn.SyncBatchNorm(in_channels=4, num_devices=8), \
        tcnn.SyncBatchNorm(in_channels=4, num_devices=8)
    jb.initialize()
    tb.initialize()
    a = r.randn(6, 4, 3, 3).astype(np.float32)
    with jag.train_mode():
        jy = jb(jnd.array(a))
    with tag.train_mode():
        ty = tb(tnd.array(a))
    _close(ty, jy, what="SyncBatchNorm")


# -------------------------------------------------------------- mx.rnn

def test_bucket_sentence_iter_batches_are_the_references():
    r = _rng(14)
    sents = [list(r.randint(1, 30, r.randint(2, 12))) for _ in range(90)]
    jcoded, jvocab = jmx.rnn.encode_sentences(
        [[str(w) for w in s] for s in sents])
    tcoded, tvocab = tmx.rnn.encode_sentences(
        [[str(w) for w in s] for s in sents])
    assert jcoded == tcoded and jvocab == tvocab
    for layout in ("NT", "TN"):
        got = []
        for pkg in (jmx, tmx):
            random.seed(3)
            np.random.seed(3)
            it = pkg.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8, 12],
                                            layout=layout)
            batches = []
            for _ in range(2):
                it.reset()
                for b in it:
                    batches.append((b.bucket_key, b.data[0].asnumpy(),
                                    b.label[0].asnumpy(),
                                    b.provide_data[0].shape))
            got.append(batches)
        assert len(got[0]) == len(got[1]) > 10
        for (jk, jd, jl, js), (tk, td, tl, ts) in zip(*got):
            assert jk == tk and js == ts
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)


def test_legacy_rnn_names():
    for name in ("RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
                 "BidirectionalCell", "DropoutCell", "ZoneoutCell",
                 "ResidualCell"):
        assert getattr(tmx.rnn, name) is getattr(tgluon.rnn, name)


# --------------------------------------------------------------- weights

def test_params_files_both_ways(tmp_path):
    V = 30
    jnet = JRNNModel("lstm", V, 12, 12, 2, dropout=0.0, tie_weights=True)
    jnet.initialize(jmx.init.Xavier())
    x = _rng(15).randint(0, V, (T, B)).astype(np.float32)
    want = jnet(jnd.array(x)).asnumpy()
    # the reference's save_parameters -> the port's two loaders
    jnet.save_parameters(str(tmp_path / "ref.params"))
    t1 = TRNNModel("lstm", V, 12, 12, 2, dropout=0.0, tie_weights=True)
    t1.load_parameters(str(tmp_path / "ref.params"))
    t2 = TRNNModel("lstm", V, 12, 12, 2, dropout=0.0, tie_weights=True)
    convert.load_mxnet_params(t2, str(tmp_path / "ref.params"))
    # and its full names (ParameterDict.save)
    jnet.collect_params().save(str(tmp_path / "full.params"))
    t3 = TRNNModel("lstm", V, 12, 12, 2, dropout=0.0, tie_weights=True)
    convert.load_mxnet_params(t3, str(tmp_path / "full.params"))
    for t in (t1, t2, t3):
        _close(t(tnd.array(x)), want, what="loaded")
    # the port's save_parameters and full names -> the reference
    t1.save_parameters(str(tmp_path / "port.params"))
    j2 = JRNNModel("lstm", V, 12, 12, 2, dropout=0.0, tie_weights=True)
    j2.load_parameters(str(tmp_path / "port.params"))
    _close(j2(jnd.array(x)), want, what="reference from the port's file")
    full = convert.mxnet_params_from_state_dict(t1, prefix=jnet.prefix)
    assert set(full) == set(jnet.collect_params())
    sd = convert.state_dict_from_mxnet(str(tmp_path / "full.params"))
    assert set(sd) == set(t1.state_dict())
    for n, v in t1.state_dict().items():
        np.testing.assert_array_equal(sd[n].numpy(), v.numpy())


def test_bare_layer_and_cell_params(tmp_path):
    jl = jgluon.rnn.GRU(H, 2, input_size=I)
    jl.initialize(jmx.init.Xavier())
    jl.collect_params().save(str(tmp_path / "gru.params"))
    tl = tgluon.rnn.GRU(H, 2, input_size=I)
    convert.load_mxnet_params(tl, str(tmp_path / "gru.params"))
    sd = convert.state_dict_from_mxnet(str(tmp_path / "gru.params"))
    assert set(sd) == set(tl.state_dict())
    jc = jgluon.rnn.LSTMCell(H, input_size=I)
    jc.initialize(jmx.init.Xavier())
    jc.save_parameters(str(tmp_path / "cell.params"))
    tc = tgluon.rnn.LSTMCell(H, input_size=I)
    tc.load_parameters(str(tmp_path / "cell.params"))
    x = _rng(16).randn(B, T, I).astype(np.float32)
    _close(tc.unroll(T, tnd.array(x), merge_outputs=True)[0],
           jc.unroll(T, jnd.array(x), merge_outputs=True)[0], what="cell")
    y = _rng(17).randn(T, B, I).astype(np.float32)
    _close(tl(tnd.array(y)), jl(jnd.array(y)), what="GRU")
