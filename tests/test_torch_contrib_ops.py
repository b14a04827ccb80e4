"""Item 8, steps 1-3, of the port against the JAX package on the CPU: the
generation and CTC ops, ``transformer_ops``, ``contrib_ops`` (with the
control-flow trio through ``nd.contrib`` and ``mx.sym.contrib``),
``contrib_misc``, the STE and scatter ops, ``ROIPooling`` and
``IdentityAttachKLSparseReg``.

Each registry case feeds the same seeded numpy arrays to both packages'
ops (``_op_cases``): exact families (token ids, index arrays, cache writes,
``arange_like``, the STEs' values) bitwise; float ops within 1e-5 of the
output's largest magnitude in float32, gradients alike (``jax.grad`` of
the reference against autograd, the same seeded cotangents). The samplers
match the reference in their greedy rows only (threefry is not ported,
ROADMAP C3).

The reference's tape records nothing through ``foreach``, ``while_loop``
and ``cond`` (its gradients there are zeros, a fault of the reference):
the trio's gradients are held to ``jax.grad`` (``jax.jacfwd`` for
``while_loop``, which JAX cannot reverse) of the reference's own
functions.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import NDArray as JND
from mxnet_tpu.ops import contrib_ops as jcf
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import registry as treg

from _op_cases import Case, check, reference_thunks
from _parity import reference_results, result

RNG = onp.random.default_rng(16)


def _f(*shape, lo=None):
    a = RNG.standard_normal(shape).astype(onp.float32)
    return onp.abs(a) + 0.1 if lo == "pos" else a


LOGITS = _f(4, 50)
CACHE, NEW = _f(3, 8, 2, 4), _f(3, 2, 2, 4)
ARENA, BLOCK = _f(2, 3, 8, 4), _f(2, 1, 3, 4)
QKV, QS, KV = _f(6, 2, 3 * 2 * 4), _f(5, 2, 2 * 4), _f(6, 2, 2 * 2 * 4)
ATT, ATT_ED = _f(2 * 2, 6, 6), _f(2 * 2, 5, 6)
CTC_X = _f(10, 3, 6)
CTC_Y = onp.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 4, 4, 1]], onp.float32)
N_E, D_E, H_E, T_E = 4, 8, 16, 12
ROI_X = _f(2, 3, 10, 12)
ROIS = onp.array([[0, 1.2, 0.7, 8.6, 6.1], [1, 0.0, 2.5, 4.4, 9.3],
                  [0, 5.5, 5.5, 5.9, 5.9], [1, -2.0, -1.0, 14.0, 11.0]],
                 onp.float32)
HAWK = dict(lda=_f(3, 2, lo="pos"), alpha=_f(2, lo="pos") * 0.5,
            beta=_f(2, lo="pos"), state=_f(3, 2, lo="pos"),
            lags=_f(3, 5, lo="pos"),
            marks=onp.array([[0, 1, 1, 0, 1], [1, 1, 0, 0, 0],
                             [0, 0, 0, 1, 1]], onp.float32),
            valid_length=onp.array([5, 3, 4], onp.float32),
            max_time=onp.array([6.0, 4.5, 8.0], onp.float32))

CASES = {
    # step 1: generation and CTC
    "sample_greedy": Case("_contrib_sample_greedy", [LOGITS], tol="exact"),
    "sample_temperature_cold": Case(
        "_contrib_sample_temperature", [LOGITS, onp.array([1, 2], "uint32")],
        {"temperature": 0.0}, tol="exact"),
    "sample_top_k_1": Case("_contrib_sample_top_k",
                           [LOGITS, onp.array([3, 4], "uint32")],
                           {"k": 1, "temperature": 0.7}, tol="exact"),
    "generation_sample_cold": Case(
        "generation_sample", [LOGITS, onp.array([5, 6], "uint32"),
                              onp.zeros(4, onp.float32)], tol="exact"),
    "kv_cache_update": Case("_contrib_kv_cache_update",
                            [CACHE, NEW, onp.array([0, 5, 7], onp.int32)],
                            tol="exact"),
    "arena_slice": Case("arena_slice", [ARENA, onp.array(6, onp.int32)],
                        {"size": 3, "axis": 2}, tol="exact"),
    "arena_update": Case("_contrib_arena_update",
                         [ARENA, BLOCK, onp.array(1, onp.int32)],
                         {"axis": 2}, tol="exact"),
    "ctc_loss": Case("_ctc_loss", [CTC_X, CTC_Y], grad=(0,)),
    "ctc_lengths": Case("CTCLoss", [CTC_X, CTC_Y,
                                    onp.array([10, 7, 9], onp.float32),
                                    onp.array([4, 2, 3], onp.float32)],
                        {"use_data_lengths": True,
                         "use_label_lengths": True}, grad=(0,)),
    # step 2: transformer_ops and contrib_ops
    "selfatt_qk": Case("_contrib_interleaved_matmul_selfatt_qk", [QKV],
                       {"heads": 2}, grad=(0,)),
    "selfatt_valatt": Case("interleaved_matmul_selfatt_valatt", [QKV, ATT],
                           {"heads": 2}, grad=(0, 1)),
    "encdec_qk": Case("interleaved_matmul_encdec_qk", [QS, KV],
                      {"heads": 2}, grad=(0, 1)),
    "encdec_valatt": Case("_contrib_interleaved_matmul_encdec_valatt",
                          [KV, ATT_ED], {"heads": 2}, grad=(0, 1)),
    "arange_like": Case("_contrib_arange_like", [_f(2, 3)],
                        {"start": 1.5, "step": 0.25}, tol="exact"),
    "arange_like_axis": Case("_contrib_arange_like", [_f(4, 5)],
                             {"start": -2.0, "axis": 1}, tol="exact"),
    "arange_like_int": Case("_contrib_arange_like",
                            [onp.zeros((2, 3), onp.int32)], {"step": 3},
                            tol="exact"),
    "div_sqrt_dim": Case("_contrib_div_sqrt_dim", [_f(3, 7)], grad=(0,)),
    "smooth_l1": Case("smooth_l1", [_f(4, 6) * 2], grad=(0,)),
    "smooth_l1_s2": Case("_npx_smooth_l1", [_f(4, 6)], {"scalar": 2.0},
                         grad=(0,)),
    # step 3: contrib_misc, STEs, scatter ops, loss ops
    "quadratic": Case("quadratic", [_f(3, 4)], {"a": 0.5, "b": -1.0,
                                                "c": 2.0}, grad=(0,)),
    "index_copy": Case("_contrib_index_copy",
                       [_f(6, 3), onp.array([4, 0, 2], onp.float32),
                        _f(3, 3)], grad=(0, 2)),
    "index_copy_out_of_range": Case(
        "index_copy", [_f(5, 2), onp.array([1, 9], onp.int32), _f(2, 2)],
        grad=(0, 2)),
    "index_array": Case("_contrib_index_array", [_f(2, 3, 4)], tol="exact"),
    "index_array_axes": Case("index_array", [_f(2, 3, 4)], {"axes": (2, 0)},
                             tol="exact"),
    "group_adagrad": Case("_contrib_group_adagrad_update",
                          [_f(5, 3), _f(5, 3), _f(5, 1, lo="pos")],
                          {"lr": 0.1, "rescale_grad": 0.5,
                           "clip_gradient": 0.4}),
    "hawkesll": Case("_contrib_hawkesll", list(HAWK.values()),
                     grad=(0, 1, 2, 3, 4)),
    "moe_ffn": Case("_contrib_moe_ffn",
                    [_f(2, T_E // 2, D_E), _f(D_E, N_E) * 0.5,
                     _f(N_E, D_E, H_E) * 0.3, _f(N_E, H_E, D_E) * 0.3],
                    {"capacity_factor": 1.0}, grad=(0, 1, 2, 3)),
    "round_ste": Case("_contrib_round_ste",
                      [onp.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.4, -0.0],
                                 onp.float32)], tol="exact", grad=(0,)),
    "sign_ste": Case("sign_ste", [onp.array([-2.0, -0.0, 0.0, 3.0, onp.nan],
                                            onp.float32)],
                     tol="exact", grad=(0,)),
    "gradientmultiplier": Case("_contrib_gradientmultiplier", [_f(3, 4)],
                               {"scalar": -0.5}, tol="exact", grad=(0,)),
    "scatter_plus": Case("_scatter_plus_scalar", [_f(3, 4)],
                         {"scalar": 1.5}, tol="exact"),
    "scatter_minus": Case("_scatter_minus_scalar", [_f(3, 4)],
                          {"scalar": 1.5}, tol="exact"),
    "scatter_div": Case("_scatter_elemwise_div",
                        [_f(3, 4), _f(3, 4, lo="pos")], tol="exact"),
    "identity_kl": Case("IdentityAttachKLSparseReg", [_f(3, 4)],
                        tol="exact", grad=(0,)),
    "roi_pooling": Case("ROIPooling", [ROI_X, ROIS],
                        {"pooled_size": (3, 2), "spatial_scale": 0.5},
                        tol="exact", grad=(0,)),
    "roi_pooling_npx": Case("_npx_roi_pooling", [ROI_X, ROIS],
                            {"pooled_size": (2, 4), "spatial_scale": 1.0},
                            tol="exact"),
}


@pytest.fixture(scope="module")
def ref():
    return reference_results(reference_thunks(CASES), chunk=8, probe=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(ref, name):
    check(CASES[name], result(ref, name), name)


NEW_MODULES = ("generation_ops", "ctc", "transformer_ops", "contrib_ops",
               "contrib_misc", "ste_graph_ops", "loss_ops", "spatial_ops",
               "detection_ops", "proposal_ops")


def test_new_names_carry_the_reference_metadata():
    """Every reference name of the slice's modules (but the seven graph
    names, which wait for sparse storage) resolves in the port to the op
    of the same canonical name, ``n_out`` and ``differentiable``."""
    names = [n for n in jreg.list_ops()
             if jreg.get_op(n).fn.__module__.rsplit(".", 1)[-1]
             in NEW_MODULES and not jreg.get_op(n).host_op]
    assert len(names) == 130 + 6      # 130 new; the 3 regression outputs
    for n in names:
        a, b = jreg.get_op(n), treg.get_op(n)
        assert b is not None, n
        assert (b.name, b.n_out, b.differentiable) == \
            (a.name, a.n_out, a.differentiable), n


def test_samplers_bind_the_key():
    """A sampler op is a function of its bound key: the same words give
    the same tokens, and temperature-0 rows are the greedy ones."""
    with tmx.cpu():
        x = tnd.array(LOGITS)
        key = tnd.array(onp.array([9, 11], "uint32"), dtype="uint32")
        a = tnd.sample_temperature(x, key, temperature=1.0).asnumpy()
        b = tnd._contrib_sample_temperature(x, key=key).asnumpy()
        c = tnd.generation_sample(x, key, tnd.array([0.0, 1.0, 0.0, 2.0]),
                                  k=5).asnumpy()
    assert a.dtype == onp.int32 and (a == b).all()
    assert (c[[0, 2]] == LOGITS[[0, 2]].argmax(-1)).all()


# ---- the control-flow trio -------------------------------------------------

X_CF = RNG.standard_normal((5, 3)).astype(onp.float32)
S_CF = RNG.standard_normal((3,)).astype(onp.float32)


def _body(F):
    return lambda x, s: (F.tanh(x * s[0]), [s[0] * 0.5 + x, s[1] - x])


def _loop(x, s):
    return x * 0.9 + s, s + 1


def _ref_foreach(x, s):
    out, fin = jcf.foreach(_body(jmx.nd), JND(x), [JND(s), JND(s * 2)])
    return out._data, fin[0]._data, fin[1]._data


@pytest.mark.parametrize("ns", ["nd", "sym"])
def test_foreach_matches_reference(ns):
    rx, rf0, rf1 = jax.jit(_ref_foreach)(jnp.asarray(X_CF), jnp.asarray(S_CF))
    gref = jax.jit(jax.grad(lambda x, s: sum(
        jnp.sum(o * w) for o, w in zip(_ref_foreach(x, s), (1.0, 2.0, 3.0))),
        argnums=(0, 1)))(jnp.asarray(X_CF), jnp.asarray(S_CF))
    fn = (tmx.nd if ns == "nd" else tmx.sym).contrib.foreach
    with tmx.cpu():
        x, s = tnd.array(X_CF), tnd.array(S_CF)
        x.attach_grad()
        s.attach_grad()
        with tag.record():
            out, fin = fn(_body(tnd), x, [s, s * 2])
            loss = (out * 1.0).sum() + (fin[0] * 2.0).sum() + \
                (fin[1] * 3.0).sum()
        loss.backward()
        got = [out.asnumpy(), fin[0].asnumpy(), fin[1].asnumpy()]
        grads = [x.grad.asnumpy(), s.grad.asnumpy()]
    for g, w in zip(got + grads, [rx, rf0, rf1, *gref]):
        onp.testing.assert_allclose(g, onp.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ns", ["nd", "sym"])
def test_while_loop_and_cond_match_reference(ns):
    contrib = (tmx.nd if ns == "nd" else tmx.sym).contrib
    jc = jmx.nd.contrib

    def ref_while(x0):
        out = jc.while_loop(lambda i, v: i < 4, lambda i, v: (i + 1, v * v * 0.5
                                                              + 0.1),
                            [JND(jnp.zeros(())), JND(x0)])
        return out[1]._data

    x0 = jnp.asarray(S_CF)
    want = jax.jit(ref_while)(x0)
    jac = jax.jit(jax.jacfwd(lambda x: jnp.sum(ref_while(x))))(x0)
    with tmx.cpu():
        v = tnd.array(S_CF)
        v.attach_grad()
        with tag.record():
            i, out = contrib.while_loop(
                lambda i, v: i < 4, lambda i, v: (i + 1, v * v * 0.5 + 0.1),
                [tnd.zeros(()), v], max_iterations=10)
            out.sum().backward()
        assert float(i.asnumpy()) == 4.0
        onp.testing.assert_allclose(out.asnumpy(), onp.asarray(want),
                                    rtol=1e-6)
        onp.testing.assert_allclose(v.grad.asnumpy(), onp.asarray(jac),
                                    rtol=1e-5)
        a = tnd.array(X_CF)
        a.attach_grad()
        for pred in (1.0, 0.0):
            with tag.record():
                got = contrib.cond(tnd.array([pred]), lambda: a * 3.0,
                                   lambda: [tnd.exp(a)])
                got.sum().backward()
            want = jax.grad(lambda t: jnp.sum(jc.cond(
                JND(jnp.asarray([pred])), lambda: JND(t) * 3.0,
                lambda: [jmx.nd.exp(JND(t))])._data))(jnp.asarray(X_CF))
            onp.testing.assert_allclose(a.grad.asnumpy(), onp.asarray(want),
                                        rtol=1e-6)
            onp.testing.assert_allclose(
                got.asnumpy(), X_CF * 3.0 if pred else onp.exp(X_CF),
                rtol=1e-6)


def test_control_flow_registry_ops():
    with tmx.cpu():
        x, s = tnd.array(X_CF), tnd.array(S_CF)
        outs = tnd._foreach(lambda d, st: (d * st, st + d), x, s)
        ref, fin = tnd.contrib.foreach(lambda d, st: (d * st, st + d), x, s)
        assert len(outs) == 2
        onp.testing.assert_array_equal(outs[0].asnumpy(), ref.asnumpy())
        onp.testing.assert_array_equal(outs[1].asnumpy(), fin.asnumpy())
        w = tnd._while_loop(lambda i: i < 3, lambda i: i + 1,
                            tnd.zeros((1,)))
        assert len(w) == 1 and float(w[0].asnumpy()[0]) == 3.0
        c = tnd._cond(tnd.array([0.0]), lambda: x, lambda: [x * 2, s])
        assert len(c) == 2


@pytest.mark.parametrize("name", ["while_loop", "cond"])
def test_predicated_control_flow_refuses_a_capture(name, monkeypatch):
    """Inside a CUDA-graph capture (simulated) ``while_loop`` and ``cond``
    raise naming themselves; ``foreach`` runs (its trip count is static)."""
    with tmx.cpu():
        x = tnd.array(S_CF)
        call = {"while_loop": lambda: tnd.contrib.while_loop(
                    lambda v: v.sum() < 0, lambda v: v, x),
                "cond": lambda: tnd.contrib.cond(x.sum() > 0, lambda: x,
                                                 lambda: x)}[name]
        call()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        with pytest.raises(tmx.MXNetError, match=name):
            call()
        tnd.contrib.foreach(lambda d, st: (d, st), tnd.array(X_CF), x)
