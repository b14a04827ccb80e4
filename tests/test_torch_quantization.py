"""The INT8 family (``ops/quantized_ops.py``, 13 ops under 26 names) and
``contrib.quantization`` of the port against the JAX package on the CPU.

Op cases (``_op_cases``): the same seeded arrays through both packages'
ops, the reference's under ``jax.jit`` in one chunk. Every integer output
(int8/uint8 payloads, int32 accumulators) and every range is bitwise;
``dequantize``'s float32 output too (one multiply). ``quantize_net`` on
``example/quantization/quantize_deploy.py``'s CNN (``build_cnn``) and on
a Conv2D -> BatchNorm net (the fold): the same float weights in, then the
int8 weights, the calibrated ranges and the logits of the quantized nets
are bitwise equal between the packages (both run op for op, eagerly);
``.params`` files of a quantized net load across the packages; a range
loaded into a net that has already run is used at its next call.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import quantized_ops as tqo
from mxnet_tpu_torch.ops import registry as treg

from _op_cases import Case, check, reference_thunks
from _parity import reference_results, result

RNG = np.random.default_rng(171)


def _i8(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


def _u8(*shape):
    return RNG.integers(0, 256, shape).astype(np.uint8)


def _f(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _r(v):
    return np.array([v], np.float32)


NAMES = ["quantize", "quantize_v2", "dequantize", "requantize",
         "quantized_fully_connected", "quantized_conv", "quantized_pooling",
         "quantized_act", "quantized_flatten", "quantized_elemwise_add",
         "quantized_concat", "quantized_batch_norm", "calibrate_entropy"]

X = _f(4, 3, 9, 9)
ACC = RNG.integers(-2 ** 24, 2 ** 24, (4, 6)).astype(np.int32)
HIST = RNG.integers(0, 50, 64).astype(np.float32)
CASES = {
    "quantize_v2_int8": Case("_contrib_quantize_v2", [X], tol="exact"),
    "quantize_v2_calib": Case("quantize_v2", [X], dict(
        min_calib_range=-1.7, max_calib_range=2.3), tol="exact"),
    "quantize_v2_uint8": Case("quantize_v2", [X], dict(out_type="uint8"),
                              tol="exact"),
    "quantize_uint8": Case("_contrib_quantize", [X, _r(-2.1), _r(2.6)],
                           tol="exact"),
    "quantize_int8": Case("quantize", [X, _r(-2.1), _r(1.6)],
                          dict(out_type="int8"), tol="exact"),
    "dequantize_int8": Case("_contrib_dequantize",
                            [_i8(5, 7), _r(-0.8), _r(1.3)], tol="exact"),
    "dequantize_uint8": Case("dequantize", [_u8(5, 7), _r(-0.8), _r(1.3)],
                             tol="exact"),
    "dequantize_int32": Case("dequantize", [ACC, _r(-3.5e3), _r(3.5e3)],
                             tol="exact"),
    "requantize": Case("_contrib_requantize", [ACC, _r(-3.5e3), _r(3.5e3)],
                       tol="exact"),
    "requantize_calib": Case("requantize", [ACC, _r(-3.5e3), _r(3.5e3)],
                             dict(min_calib_range=-0.02,
                                  max_calib_range=0.03), tol="exact"),
    "fc_bias": Case("_contrib_quantized_fully_connected",
                    [_i8(5, 2, 3, 4), _i8(6, 24), _f(6)],
                    dict(min_data=-1.5, max_data=1.2, min_weight=-0.3,
                         max_weight=0.4, min_bias=-0.5, max_bias=0.5,
                         num_hidden=6), tol="exact"),
    "fc_no_flatten": Case("quantized_fully_connected",
                          [_i8(3, 5, 12), _i8(8, 12), None],
                          dict(min_data=-1.0, max_data=1.0, min_weight=-1.0,
                               max_weight=1.0, num_hidden=8, no_bias=True,
                               flatten=False), tol="exact"),
    "conv_stem": Case("_contrib_quantized_conv",
                      [_i8(2, 3, 15, 15), _i8(8, 3, 7, 7), _f(8)],
                      dict(min_data=-2.0, max_data=2.0, min_weight=-0.1,
                           max_weight=0.1, min_bias=-0.3, max_bias=0.3,
                           kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                           num_filter=8), tol="exact"),
    "conv_dilate": Case("quantized_conv",
                        [_i8(2, 4, 9, 9), _i8(5, 4, 3, 3), None],
                        dict(min_data=-1.0, max_data=1.0, min_weight=-1.0,
                             max_weight=1.0, kernel=(3, 3), stride=(1, 1),
                             pad=(2, 2), dilate=(2, 2), num_filter=5,
                             no_bias=True), tol="exact"),
    "conv_1d": Case("quantized_conv", [_i8(2, 4, 11), _i8(3, 4, 3), None],
                    dict(min_data=-1.0, max_data=1.0, min_weight=-1.0,
                         max_weight=1.0, kernel=(3,), stride=(2,), pad=(1,),
                         num_filter=3, no_bias=True), tol="exact"),
    "pool_max": Case("_contrib_quantized_pooling", [_i8(2, 3, 9, 9)],
                     dict(min_data=-1.0, max_data=1.0, kernel=(3, 3),
                          stride=(2, 2), pad=(1, 1), pool_type="max"),
                     tol="exact"),
    "pool_avg": Case("quantized_pooling", [_i8(2, 3, 8, 8)],
                     dict(min_data=-1.0, max_data=1.0, kernel=(2, 2),
                          stride=(2, 2), pool_type="avg"), tol="exact"),
    "pool_avg_uint8": Case("quantized_pooling", [_u8(2, 3, 9, 9)],
                           dict(min_data=0.0, max_data=3.0, kernel=(3, 3),
                                stride=(2, 2), pad=(1, 1), pool_type="avg"),
                           tol="exact"),
    "pool_global": Case("quantized_pooling", [_i8(2, 3, 7, 7)],
                        dict(min_data=-1.0, max_data=1.0, kernel=(7, 7),
                             pool_type="avg", global_pool=True),
                        tol="exact"),
    "act": Case("_contrib_quantized_act", [_i8(3, 8)],
                dict(min_data=-1.0, max_data=2.0), tol="exact"),
    "flatten": Case("_contrib_quantized_flatten", [_i8(2, 3, 4, 5)],
                    dict(min_data=-1.0, max_data=2.0), tol="exact"),
    "elemwise_add": Case("_contrib_quantized_elemwise_add",
                         [_i8(4, 6), _i8(4, 6)],
                         dict(lhs_min=-0.7, lhs_max=0.9, rhs_min=-2.0,
                              rhs_max=1.5), tol="exact"),
    "concat": Case("_contrib_quantized_concat",
                   [_i8(2, 3, 4), _i8(2, 5, 4), _i8(2, 1, 4),
                    _r(-1.0), _r(1.0), _r(-3.0), _r(2.0), _r(-0.5), _r(0.7)],
                   dict(num_args=3, dim=1), tol="exact"),
    "batch_norm": Case("_contrib_quantized_batch_norm",
                       [_i8(2, 4, 5, 5), _f(4) + 1.0, _f(4), _f(4),
                        np.abs(_f(4)) + 0.5],
                       dict(min_data=-2.0, max_data=2.0, eps=1e-3),
                       tol="exact"),
    "batch_norm_calib": Case("quantized_batch_norm",
                             [_i8(2, 4, 5, 5), _f(4) + 1.0, _f(4), _f(4),
                              np.abs(_f(4)) + 0.5],
                             dict(min_data=-2.0, max_data=2.0, eps=1e-3,
                                  min_calib_range=-3.0,
                                  max_calib_range=2.5), tol="exact"),
    "calibrate_entropy": Case("_contrib_calibrate_entropy",
                              [HIST, np.linspace(0, 4, 65).astype(
                                  np.float32)],
                              dict(num_quantized_bins=15), tol="exact"),
}


@pytest.fixture(scope="module")
def ref():
    return reference_results(reference_thunks(CASES))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_against_reference(ref, name):
    check(CASES[name], result(ref, name), name)


@pytest.mark.parametrize("name", NAMES)
def test_both_names_resolve_to_one_op(name):
    op = treg.get_op(name)
    assert op is not None and op is treg.get_op("_contrib_" + name)
    assert jreg.get_op(name) is not None


@pytest.mark.parametrize("m,k,n", [(5, 147, 9), (40, 64, 1000), (1, 3, 2)])
def test_int8_matmul_equals_its_plain_version(m, k, n):
    a, b = torch.from_numpy(_i8(m, k)), torch.from_numpy(_i8(n, k))
    got = tqo.int8_matmul(a, b)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, tqo.int8_matmul_plain(a, b), rtol=0,
                               atol=0)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(2, 2), pool_type="avg", stride=(2, 2)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(1, 1), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True)])
def test_pooling_on_int32_as_reference(kw):
    x = RNG.integers(-127, 128, (2, 3, 7, 7)).astype(np.int32)
    want = np.asarray(jreg.get_op("Pooling").fn(jmx.nd.array(
        x, dtype="int32")._data, **kw))
    got = treg.get_op("Pooling").fn(torch.from_numpy(x), **kw).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---- quantize_net, quantize_model, the calibration helpers -----------------

def _cnn(mx):
    """``build_cnn`` of ``example/quantization/quantize_deploy.py``."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                               activation="relu"),
            mx.gluon.nn.MaxPool2D(2),
            mx.gluon.nn.Conv2D(16, kernel_size=3, padding=1,
                               activation="relu"),
            mx.gluon.nn.MaxPool2D(2),
            mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(32, activation="relu"),
            mx.gluon.nn.Dense(10))
    return net


def _conv_bn(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(6, kernel_size=3, padding=1, use_bias=False),
            mx.gluon.nn.BatchNorm(),
            mx.gluon.nn.Activation("relu"),
            mx.gluon.nn.Conv2D(4, kernel_size=1, strides=2),
            mx.gluon.nn.BatchNorm(),
            mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(5))
    return net


CALIB = [RNG.standard_normal((8, 1, 12, 12)).astype(np.float32) * 0.3
         + (RNG.random((8, 1, 12, 12)) > 0.8) * 2.0 for _ in range(3)]
XQ = CALIB[0][:4] + 0.1


def _twin(build, tmp_path, stats=False):
    """The same float net in both packages (the port's values saved and
    loaded into the reference), BatchNorm statistics set alike."""
    with tmx.cpu():
        tnet = build(tmx)
        tnet.initialize(tmx.init.Xavier())
        tnet(tmx.nd.array(XQ))
        if stats:
            for name, p in tnet.collect_params().items():
                if name.endswith(("running_mean", "running_var", "gamma",
                                  "beta")):
                    v = RNG.random(p.shape).astype(np.float32) + \
                        (0.5 if name.endswith(("var", "gamma")) else -0.5)
                    p.set_data(v)
        f = str(tmp_path / "float.params")
        tnet.save_parameters(f)
    jnet = build(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(XQ))
    jnet.load_parameters(f)
    return tnet, jnet


def _quantize_both(tnet, jnet):
    with tmx.cpu():
        tq.quantize_net(tnet, calib_data=[tmx.nd.array(c) for c in CALIB],
                        calib_mode="naive")
    jq.quantize_net(jnet, calib_data=[jmx.nd.array(c) for c in CALIB],
                    calib_mode="naive")


def _out(net, mx, x=XQ):
    with tmx.cpu():
        return net(mx.nd.array(x)).asnumpy()


@pytest.mark.parametrize("build,swapped,stats", [
    (_cnn, 4, False), (_conv_bn, 3, True)], ids=["quantize_deploy_cnn",
                                                 "conv_bn_fold"])
def test_quantize_net_matches_reference(tmp_path, build, swapped, stats):
    """The int8 weights bitwise; the calibrated ranges bitwise where every
    float bias is zero (the reference's ``Constant("qbias")`` starts at
    zero, so its folded biases are lost: "Standing hazards"); the logits
    bitwise once the port's quantized parameters are loaded into the
    reference's quantized net."""
    tnet, jnet = _twin(build, tmp_path, stats)
    ref_float = _out(tnet, tmx)
    _quantize_both(tnet, jnet)
    kinds = [type(c).__name__ for c in tnet._modules.values()]
    assert sum(k.startswith("_Int8") for k in kinds) == swapped, kinds
    assert kinds == [type(c).__name__ for c in jnet._children.values()]
    for tb, jb in zip(tnet._modules.values(), jnet._children.values()):
        if type(tb).__name__.startswith("_Int8"):
            np.testing.assert_array_equal(tb.qweight.data().asnumpy(),
                                          jb.qweight.data().asnumpy())
            assert tb.qweight.data().dtype == np.int8
            if not stats:
                assert tb._range == jb._range
    got = _out(tnet, tmx)
    if not stats:
        np.testing.assert_array_equal(got, _out(jnet, jmx))
    f = str(tmp_path / "int8.params")
    with tmx.cpu():
        tnet.save_parameters(f)
    jnet.load_parameters(f)
    np.testing.assert_array_equal(got, _out(jnet, jmx))
    scale = np.abs(ref_float).max()
    assert np.abs(got - ref_float).max() < 0.05 * scale


def test_quantized_params_cross_packages_and_a_loaded_range_is_used(
        tmp_path):
    tnet, jnet = _twin(_cnn, tmp_path)
    _quantize_both(tnet, jnet)
    before = _out(tnet, tmx)
    tf, jf = str(tmp_path / "tq.params"), str(tmp_path / "jq.params")
    with tmx.cpu():
        tnet.save_parameters(tf)
    jnet.save_parameters(jf)
    saved = tmx.nd.load(tf, ctx=tmx.cpu())
    assert sorted(saved) == sorted(jmx.nd.load(jf))
    assert saved["0.qweight"].dtype == np.int8
    # a narrower range for the first conv, loaded into nets that have run
    narrowed = {k: v.asnumpy() for k, v in saved.items()}
    narrowed["0.calib"] = narrowed["0.calib"] * np.float32(0.5)
    nf = str(tmp_path / "narrow.params")
    tmx.nd.save(nf, {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
                     for k, v in narrowed.items()})
    with tmx.cpu():
        tnet.load_parameters(nf)
    jnet.load_parameters(nf)
    after = _out(tnet, tmx)
    np.testing.assert_array_equal(after, _out(jnet, jmx))
    assert not np.array_equal(after, before)
    # and back: the reference's own file restores the first outputs
    with tmx.cpu():
        tnet.load_parameters(jf)
    np.testing.assert_array_equal(_out(tnet, tmx), before)


def test_a_range_set_in_place_is_used_by_a_hybridized_net(tmp_path):
    """``set_data`` of a narrower range into a hybridized net that has
    run: the next call quantizes in it, as the reference's does."""
    tnet, jnet = _twin(_cnn, tmp_path)
    _quantize_both(tnet, jnet)
    with tmx.cpu():
        tnet.hybridize()
    before = _out(tnet, tmx)
    np.testing.assert_array_equal(_out(tnet, tmx), before)
    tlayer = next(iter(tnet._modules.values()))
    jlayer = next(iter(jnet._children.values()))
    narrowed = tlayer.calib.data().asnumpy() * np.float32(0.5)
    with tmx.cpu():
        tlayer.calib.set_data(narrowed)
    jlayer.calib.set_data(jmx.nd.array(narrowed))
    after = _out(tnet, tmx)
    np.testing.assert_array_equal(after, _out(jnet, jmx))
    assert not np.array_equal(after, before)


def test_quantize_model_and_helpers():
    w = {"fc_weight": RNG.standard_normal((6, 4)).astype(np.float32),
         "fc_bias": RNG.standard_normal(6).astype(np.float32),
         "conv_weight": RNG.standard_normal((3, 2, 3, 3)).astype(
             np.float32)}
    with tmx.cpu():
        _, targs, _ = tq.quantize_model(
            None, {k: tmx.nd.array(v) for k, v in w.items()}, {})
    _, jargs, _ = jq.quantize_model(
        None, {k: jmx.nd.array(v) for k, v in w.items()}, {})
    for k in w:
        np.testing.assert_array_equal(targs[k].asnumpy(),
                                      jargs[k].asnumpy())
    tqp, tsc = tq.quantize_params(w)
    jqp, jsc = jq.quantize_params(w)
    for k in w:
        np.testing.assert_array_equal(tqp[k], jqp[k])
        np.testing.assert_array_equal(tsc[k], jsc[k])
    acts = RNG.standard_normal(4000).astype(np.float32) ** 3
    for mode in ("naive", "entropy"):
        tc, jc = tq.CalibrationCollector(mode), jq.CalibrationCollector(mode)
        tc.collect("a", torch.from_numpy(acts))
        jc.collect("a", acts)
        assert tc.scales() == jc.scales()
