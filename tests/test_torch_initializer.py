"""The port's initializers and ``collect_params(...).initialize`` against
the JAX package's.

Both fill host arrays from numpy's global random state, so one numpy seed
must give equal bits:

- every registered initializer (and ``Mixed``, ``Load``, an ``InitDesc``
  whose ``__init__`` attribute names another initializer), each on a
  weight-, bias-, gamma- and beta-named array, into a float32 torch tensor
  on the port's side;
- ``create`` by name and alias, ``dumps``, and the refusals;
- ``collect_params(net).initialize(Xavier())`` after
  ``mxnet_tpu_torch.random.seed(s)`` against ``net.initialize(
  mx.init.Xavier())`` after ``mx.random.seed(s)``, for a 2-layer
  ``TransformerLM``, ``bert_tiny`` and a ``PretrainStep`` over it: the
  same names in the same order, and the same values bit for bit.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import nd
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import collect_params
from mxnet_tpu_torch.models import PretrainStep, TransformerLM, bert_tiny

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("fc_weight", "fc_bias", "ln_gamma", "ln_beta", "bn_running_mean",
         "bn_moving_var", "plain")
SHAPE = (6, 4, 3, 3)


def _both(make, name, shape=SHAPE, seed=5):
    """``(reference, port)`` arrays of ``make()``'s initializer applied to
    ``name`` under one numpy seed."""
    np.random.seed(seed)
    ref = nd.zeros(shape)
    make(jinit)(jinit.InitDesc(name), ref)
    np.random.seed(seed)
    own = torch.zeros(shape)
    make(tinit)(tinit.InitDesc(name), own)
    return ref.asnumpy(), own.numpy()


INITS = {
    "zero": lambda m: m.Zero(),
    "one": lambda m: m.One(),
    "constant": lambda m: m.Constant(0.25),
    "uniform": lambda m: m.Uniform(0.3),
    "normal": lambda m: m.Normal(0.2),
    "orthogonal": lambda m: m.Orthogonal(),
    "orthogonal_normal": lambda m: m.Orthogonal(scale=0.5,
                                                rand_type="normal"),
    "xavier": lambda m: m.Xavier(),
    "xavier_gaussian_in": lambda m: m.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2),
    "xavier_out": lambda m: m.Xavier(factor_type="out"),
    "msraprelu": lambda m: m.MSRAPrelu(slope=0.1),
    "bilinear": lambda m: m.Bilinear(),
    "lstmbias": lambda m: m.LSTMBias(forget_bias=2.0),
    "mixed": lambda m: m.Mixed([".*gamma", ".*"],
                               [m.Constant(3.0), m.Uniform(0.5)]),
}


@pytest.mark.parametrize("which,name", [
    (w, n) for w in sorted(INITS) for n in NAMES
    if w != "lstmbias" or n == "fc_bias"])          # LSTMBias: biases only
def test_initializer_bitwise(which, name):
    shape = (8,) if which == "lstmbias" else SHAPE
    ref, own = _both(INITS[which], name, shape)
    assert own.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(own, ref)


def test_load_and_init_attr_bitwise():
    rng = np.random.default_rng(0)
    saved = {"arg:a_weight": rng.standard_normal(SHAPE).astype("float32"),
             "b_bias": rng.standard_normal((4,)).astype("float32")}
    for name, shape in (("a_weight", SHAPE), ("b_bias", (4,)),
                        ("c_weight", (5, 3))):
        ref, own = _both(lambda m: m.Load(saved, default_init=m.Normal(1.0)),
                         name, shape)
        np.testing.assert_array_equal(own, ref)
    with pytest.raises(ValueError, match="no initializer"):
        tinit.Load(saved)("c_weight", torch.zeros(2))
    with pytest.raises(ValueError, match="shape mismatch"):
        tinit.Load(saved)("b_bias", torch.zeros(3))
    # an InitDesc naming its own initializer overrides the one called
    spec = tinit.Normal(0.5).dumps()
    assert spec == jinit.Normal(0.5).dumps()
    np.random.seed(9)
    ref = nd.zeros((5, 3))
    jinit.Zero()(jinit.InitDesc("x_bias", attrs={"__init__": spec}), ref)
    np.random.seed(9)
    own = torch.zeros((5, 3))
    tinit.Zero()(tinit.InitDesc("x_bias", attrs={"__init__": spec}), own)
    np.testing.assert_array_equal(own.numpy(), ref.asnumpy())
    assert float(own.abs().sum()) > 0


def test_create_dumps_and_registry():
    assert sorted(tinit.registry()) == sorted(jinit.registry())
    for name, kw in (("xavier", {"magnitude": 2}), ("zeros", {}),
                     ("ones", {}), ("gaussian", {"sigma": 0.1}),
                     ("Uniform", {"scale": 0.2}), ("msraprelu", {})):
        ref, own = jinit.create(name, **kw), tinit.create(name, **kw)
        assert type(own).__name__ == type(ref).__name__
        assert own.dumps() == ref.dumps()
        assert repr(own) == repr(ref)
    assert isinstance(tinit.create(None), tinit.Uniform)
    x = tinit.Xavier()
    assert tinit.create(x) is x
    with pytest.raises(ValueError, match="unknown initializer"):
        tinit.create("nope")
    with pytest.raises(TypeError, match="first argument"):
        tinit.Zero()(3, torch.zeros(2))


def test_fills_other_dtypes_through_the_host():
    """A bf16 tensor takes the float32 host values rounded once."""
    np.random.seed(1)
    host = np.zeros((4, 5), np.float32)
    tinit.Xavier()("w_weight", host)
    np.random.seed(1)
    own = torch.zeros((4, 5), dtype=torch.bfloat16)
    tinit.Xavier()("w_weight", own)
    assert torch.equal(own, torch.from_numpy(host).bfloat16())


def _example():
    spec = importlib.util.spec_from_file_location(
        "pretrain_bert_example", REPO / "example" / "bert" /
        "pretrain_bert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets(which):
    if which == "lm":
        return (JaxLM(64, units=32, num_layers=2, num_heads=2, max_len=16),
                TransformerLM(64, units=32, num_layers=2, num_heads=2,
                              max_len=16, device="cpu"))
    jnet = jbert.bert_tiny(vocab_size=100, max_length=16)
    tnet = bert_tiny(vocab_size=100, max_length=16, device="cpu")
    if which == "pretrain":
        return _example().PretrainStep(jnet), PretrainStep(tnet)
    return jnet, tnet


@pytest.mark.parametrize("which", ["lm", "bert", "pretrain"])
def test_collect_params_initialize_bitwise(which):
    jnet, tnet = _nets(which)
    jparams = jnet.collect_params()
    prefix = jnet.bert.prefix if which == "pretrain" else jnet.prefix
    tparams = collect_params(tnet, prefix=prefix)
    assert list(tparams.keys()) == list(jparams.keys())
    for k, p in jparams.items():
        assert tparams[k].init == p.init, k
        assert tparams[k].shape == p.shape, k
    mx.random.seed(7)
    jnet.initialize(mx.init.Xavier())
    trandom.seed(7)
    tparams.initialize(tinit.Xavier())
    for k, p in jparams.items():
        np.testing.assert_array_equal(tparams[k].tensor().detach().numpy(),
                                      p.data().asnumpy(), err_msg=k)
    # a second initialize is a no-op; force_reinit draws again
    before = {k: p.tensor().clone() for k, p in tparams.items()}
    tparams.initialize(tinit.Xavier())
    assert all(torch.equal(p.tensor(), before[k]) for k, p in tparams.items())
    tparams.initialize(tinit.Xavier(), force_reinit=True)
    assert not all(torch.equal(p.tensor(), before[k])
                   for k, p in tparams.items())


def test_collect_params_select_names_and_other_modules():
    tnet = TransformerLM(64, units=32, num_layers=1, num_heads=2,
                         max_len=16, device="cpu")
    sel = collect_params(tnet, select=".*_bias$")
    assert list(sel.keys()) == [
        "transformerlm0_blocks_transformerencoderlayer0_ffn_up_bias",
        "transformerlm0_blocks_transformerencoderlayer0_ffn_down_bias"]
    # one wrapper per tensor across calls
    assert collect_params(tnet)[list(sel.keys())[0]] is list(sel.values())[0]
    lin = torch.nn.Linear(3, 2)
    params = collect_params(lin, prefix="dense0_")
    assert list(params.keys()) == ["dense0_weight", "dense0_bias"]
    assert params["dense0_weight"].init is None


def test_parameter_dict_save_load_across_packages(tmp_path):
    """``ParameterDict.save`` writes the reference's ``.params`` bytes: each
    package loads the other's file."""
    jnet, tnet = _nets("lm")
    mx.random.seed(3)
    jnet.initialize(mx.init.Xavier())
    tparams = collect_params(tnet, prefix=jnet.prefix)
    ref_file, own_file = str(tmp_path / "ref.params"), \
        str(tmp_path / "own.params")
    jnet.collect_params().save(ref_file)
    tparams.load(ref_file)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(tparams[k].tensor().detach().numpy(),
                                      p.data().asnumpy(), err_msg=k)
    with torch.no_grad():
        for p in tparams.values():
            p.tensor().mul_(2)
    tparams.save(own_file, strip_prefix=jnet.prefix)
    jnet.collect_params().load(own_file, restore_prefix=jnet.prefix)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(tparams[k].tensor().detach().numpy(),
                                      p.data().asnumpy(), err_msg=k)
    # an initialized parameter is not drawn again
    before = {k: p.tensor().clone() for k, p in tparams.items()}
    tparams.initialize(tinit.Xavier())
    assert all(torch.equal(p.tensor(), before[k]) for k, p in tparams.items())
    with pytest.raises(AssertionError, match="missing"):
        collect_params(bert_tiny(vocab_size=100, max_length=16,
                                 device="cpu")).load(ref_file)
