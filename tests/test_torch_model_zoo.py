"""The port's model zoo (``mxnet_tpu_torch.gluon.model_zoo``) against the
JAX package's, as ``tests/test_model_zoo.py`` drives it, held to the
reference's outputs and not only to shapes.

- Every ``get_model`` name: parameter names (after the net's prefix),
  order, shapes (0 where deferred) and count equal the reference's;
  ``resnet50_v1``'s ~23.5M parameters with a 10-class head; an unknown
  name raises ``ValueError``; ``pretrained=True`` raises.
- ``resnet18_v1`` after ``random.seed(0)`` and
  ``collect_params(net).initialize(Xavier())`` (the reference's
  ``net.initialize(mx.init.Xavier())``):
  every value equal to the reference's bit for bit (numpy draws in the
  same order, the deferred ones at the first call), and the forward (b2,
  32x32) within 1e-4 of the output's largest |value| (float32, sums in
  another order), eager and hybridized; narrow ResNets of
  ``BottleneckV1``/``V2`` blocks (ResNet-50's) and of ``BasicBlockV2``
  (``resnet18_v2``'s) likewise, the port's values carried into the
  reference (whose forward runs under ``jax.jit``); ``resnet50_v1``'s
  parameter count at 64x64.
- ``.params`` both ways: the reference's ``export`` file (``arg:``/
  ``aux:`` names) into the port through ``convert.load_mxnet_params``;
  the port's ``save_parameters`` file into the reference's
  ``load_parameters``; the port's ``arg:``/``aux:`` names
  (``convert.mxnet_params_from_state_dict(export=True)``) equal the
  reference's ``export``'s, and its file of them, beside the reference's
  symbol, loads through the reference's ``SymbolBlock.imports``.
- ``cast("bfloat16")``: every BatchNorm parameter stays float32 and every
  other one is bfloat16, in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import get_model as jget
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel.functional import functionalize
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import collect_params
from mxnet_tpu_torch.gluon.model_zoo import get_model as tget
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.nn import BatchNorm
from mxnet_tpu_torch.ndarray.serialization import save_ndarrays

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _reference_compiles_unoptimized():
    """The reference compiles one XLA program per eager op and shape;
    compiling them without XLA's optimizations costs less and leaves their
    values within these tolerances. Module scope: the flag is restored and
    the programs compiled under it dropped, so no later test reuses one."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()

TOL = 1e-4
NAMES = sorted(tvision._MODELS)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _leaves(net):
    return [(n[len(net.prefix):], tuple(p.shape or ()))
            for n, p in net.collect_params().items()]


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_order_and_count_match_reference(name):
    ref, port = jget(name), tget(name)
    assert _leaves(port) == _leaves(ref)
    assert port.prefix[:-2] == ref.prefix[:-2] or \
        port.prefix.rstrip("_0123456789") == ref.prefix.rstrip("_0123456789")


def test_get_model_unknown_and_pretrained_raise():
    with pytest.raises(ValueError):
        tget("nonexistent_model_xyz")
    with pytest.raises(RuntimeError):
        tvision.resnet18_v1(pretrained=True)


def _pair(name, x, **kw):
    """The reference's and the port's ``name`` after the same seed and
    ``initialize(Xavier())``, each called once on ``x``; the outputs."""
    mx.random.seed(0)
    ref = jget(name, **kw)
    ref.initialize(mx.init.Xavier())
    want = ref(mx.nd.array(x)).asnumpy()
    trandom.seed(0)
    with tmx.cpu():
        port = tget(name, **kw)
        collect_params(port).initialize(tinit.Xavier())
        got = port(tnd.array(x)).asnumpy()
    return ref, port, want, got


@pytest.fixture(scope="module")
def resnet18():
    x = np.random.default_rng(1).random((2, 3, 32, 32)).astype(np.float32)
    return (x,) + _pair("resnet18_v1", x, classes=7)


def test_resnet18_xavier_values_bitwise(resnet18):
    _, ref, port, _, _ = resnet18
    rp, pp = ref.collect_params(), port.collect_params()
    assert len(rp) == len(pp) == 102
    for p, q in zip(rp.values(), pp.values()):
        np.testing.assert_array_equal(q.data().asnumpy(),
                                      p.data().asnumpy(), err_msg=q.name)


def test_resnet18_forward_matches_reference(resnet18):
    x, _, port, want, got = resnet18
    assert got.shape == want.shape == (2, 7)
    assert _rel(got, want) <= TOL
    port.hybridize()
    with tmx.cpu():
        hyb = port(tnd.array(x)).asnumpy()
    np.testing.assert_array_equal(hyb, got)


def _forward_pair(make_ref, make_port, x):
    """A port net from ``Xavier()`` (shapes settled by its first call) and
    a reference net given its values; both outputs, the reference's from
    its ``functionalize``d forward under ``jax.jit`` (one compilation in
    place of an eager call per op)."""
    trandom.seed(0)
    with tmx.cpu():
        port = make_port()
        port.initialize(tinit.Xavier())
        got = port(tnd.array(x)).asnumpy()
    ref = make_ref()
    ref.initialize()
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        p.set_data(mx.nd.array(q.data().asnumpy()))
        p._finish_deferred_init()
    pure, params = functionalize(ref, train=False)
    fwd = jax.jit(lambda v, a: pure(jax.random.PRNGKey(0), v, a)[0][0])
    want = np.asarray(fwd([p.data()._data for p in params], jnp.asarray(x)))
    return want, got


@pytest.mark.parametrize("version,block", [
    (1, "BottleneckV1"), (2, "BottleneckV2"), (2, "BasicBlockV2")])
def test_narrow_resnet_matches_reference(version, block):
    """ResNet-50's blocks (``BottleneckV1``/``V2``) and ``resnet18_v2``'s
    (``BasicBlockV2``) at narrow widths, a projection in each stage."""
    x = np.random.default_rng(2).random((2, 3, 16, 16)).astype(np.float32)
    spec = ([1, 1, 1, 1], [8, 16, 32, 64, 128])

    def make(pkg):
        res = pkg.resnet
        net = (res.ResNetV1, res.ResNetV2)[version - 1]
        return lambda: net(getattr(res, block), *spec, classes=10,
                           thumbnail=True)
    want, got = _forward_pair(make(jvision), make(tvision), x)
    assert got.shape == want.shape == (2, 10)
    assert _rel(got, want) <= TOL


def test_resnet50_v1_structure():
    """``tests/test_model_zoo.py``'s check on the port alone: a 10-class
    ResNet-50 v1 at 64x64 has ~23.5M parameters (its names and shapes
    equal the reference's above; its blocks' forward is held at narrow
    widths)."""
    with tmx.cpu():
        net = tvision.resnet50_v1(classes=10)
        net.initialize()
        out = net(tnd.array(np.random.default_rng(4).random(
            (1, 3, 64, 64)).astype(np.float32)))
    assert out.shape == (1, 10)
    n = sum(int(np.prod(p.shape)) for p in net.collect_params().values())
    assert 23_000_000 < n < 24_500_000


def test_params_files_both_ways(resnet18, tmp_path):
    x, ref, port, want, _ = resnet18
    symbol, exported = ref.export(str(tmp_path / "ref"))
    # the reference's arg:/aux: file into a fresh port net (deferred
    # shapes taken from the file), and the port's names back out
    fresh = tget("resnet18_v1", classes=7)
    with tmx.cpu():
        convert.load_mxnet_params(fresh, exported)
        got = fresh(tnd.array(x)).asnumpy()
    assert _rel(got, want) <= TOL
    marks = convert.mxnet_params_from_state_dict(fresh, prefix=ref.prefix,
                                                 export=True)
    assert sorted(marks) == sorted(mx.nd.load(exported))
    # the port's save_parameters file (structural names) into the
    # reference, and an arg:/aux: file of the port's into the reference
    port_file = str(tmp_path / "port.params")
    fresh.save_parameters(port_file)
    back = jget("resnet18_v1", classes=7)
    back.load_parameters(port_file)
    assert _rel(back(mx.nd.array(x)).asnumpy(), want) <= TOL
    # the port's arg:/aux: file beside the reference's symbol, read by
    # the reference's SymbolBlock.imports, as an exported model is
    aux_file = str(tmp_path / "port-0000.params")
    save_ndarrays(aux_file, [torch.from_numpy(v) for v in marks.values()],
                  list(marks))
    back2 = jgluon.SymbolBlock.imports(symbol, ["data"], aux_file)
    assert _rel(back2(mx.nd.array(x)).asnumpy(), want) <= TOL


def test_cast_bfloat16_keeps_batchnorm_float32(resnet18):
    x, ref, port, _, _ = resnet18
    ref.cast("bfloat16")
    port.cast("bfloat16")
    bn = {id(p) for m in port.modules() if isinstance(m, BatchNorm)
          for p in (m.gamma, m.beta, m.running_mean, m.running_var)}
    assert len(bn) == 4 * 20
    for (n, p), q in zip(ref.collect_params().items(),
                         port.collect_params().values()):
        want = "float32" if id(q) in bn else "bfloat16"
        assert str(q.data().dtype) == want, n
        assert str(p.data().dtype) == want, n
    with tmx.cpu():
        out = port(tnd.array(x[:1, :, :16, :16]).astype("bfloat16"))
    assert str(out.dtype) == "bfloat16" and out.shape == (1, 7)
