"""The port's ``.params`` container (``mxnet_tpu_torch/ndarray/
serialization.py``) against the JAX package's.

- ``load_ndarrays`` reads ``tests/data/ref_export-0000.params`` and files
  that the reference's ``save_ndarrays`` wrote (dicts and lists;
  float32/float16/int32; 0-d and 4-d arrays) as the reference reads them:
  the same names, dtypes, shapes and values;
- ``save_ndarrays`` writes the same bytes as the reference's for the same
  arrays, from numpy arrays and from torch tensors;
- ``is_mxnet_binary`` agrees;
- a ``bert_tiny`` loads from a reference ``save_parameters`` file
  (structural names, layers keyed by child index) and from a file with
  ``export``'s ``arg:`` names, and its forward then equals the reference's
  (atol/rtol 1e-4, fp32).
"""
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.ndarray import serialization as jser
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ndarray import serialization as tser

torch.set_num_threads(1)

REF_EXPORT = pathlib.Path(__file__).resolve().parent / "data" / \
    "ref_export-0000.params"


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "w4d": rng.standard_normal((2, 3, 4, 5)).astype("float32"),
        "half": rng.standard_normal((7,)).astype("float16"),
        "ids": rng.integers(-5, 1000, (3, 4)).astype("int32"),
        "scalar": np.array(2.5, "float32"),
        "row": np.zeros((1, 1), "float32"),
    }


def _same(port, ref):
    (pa, pn), (ra, rn) = port, ref
    assert pn == rn
    assert len(pa) == len(ra)
    for a, r in zip(pa, ra):
        assert a.dtype == r.dtype and a.shape == r.shape
        np.testing.assert_array_equal(a, r)


def test_load_reads_the_reference_export_fixture():
    _same(tser.load_ndarrays(REF_EXPORT), jser.load_ndarrays(REF_EXPORT))
    arrays, names = tser.load_ndarrays(REF_EXPORT)
    assert names == ["arg:fc0_weight", "arg:fc0_bias"]


@pytest.mark.parametrize("form", ["dict", "list"])
def test_load_reads_what_the_reference_wrote(tmp_path, form):
    arrs = _arrays()
    path = tmp_path / "ref.params"
    names = list(arrs) if form == "dict" else None
    jser.save_ndarrays(str(path), list(arrs.values()), names)
    _same(tser.load_ndarrays(str(path)), jser.load_ndarrays(str(path)))
    arrays, got = tser.load_ndarrays(str(path))
    assert got == (names or [])
    assert arrays[3].shape == () and arrays[0].shape == (2, 3, 4, 5)


@pytest.mark.parametrize("form", ["dict", "list", "torch"])
def test_save_writes_the_reference_bytes(tmp_path, form):
    arrs = _arrays()
    names = None if form == "list" else list(arrs)
    jser.save_ndarrays(str(tmp_path / "ref.params"), list(arrs.values()),
                       names)
    values = list(arrs.values())
    if form == "torch":
        values = [torch.from_numpy(a) for a in values]
    tser.save_ndarrays(str(tmp_path / "port.params"), values, names)
    assert (tmp_path / "port.params").read_bytes() == \
        (tmp_path / "ref.params").read_bytes()


def test_save_writes_bf16_tensors_as_float32(tmp_path):
    x = torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16)
    tser.save_ndarrays(str(tmp_path / "a.params"), [x], ["x"])
    jser.save_ndarrays(str(tmp_path / "b.params"),
                       [np.array([[1.5, -2.25]], "float32")], ["x"])
    assert (tmp_path / "a.params").read_bytes() == \
        (tmp_path / "b.params").read_bytes()


def test_is_mxnet_binary_agrees(tmp_path):
    text = tmp_path / "notes.txt"
    text.write_text("not a container")
    short = tmp_path / "short.bin"
    short.write_bytes(b"\x12\x01")
    for path in (REF_EXPORT, text, short, tmp_path / "missing.params"):
        assert tser.is_mxnet_binary(str(path)) == \
            jser.is_mxnet_binary(str(path))
    assert tser.is_mxnet_binary(str(REF_EXPORT))


def _ref_net():
    mx.random.seed(1)
    net = jbert.bert_tiny(vocab_size=100, max_length=16)
    net.initialize(mx.init.Xavier())
    return net


def _forward_equal(jnet, tnet):
    tokens, segments, pos, *_ = tbert.synthetic_batch(
        np.random.default_rng(2), 2, 16, 100, 3)
    lens = np.array([16, 5], "float32")
    ref = jnet(nd.array(tokens), nd.array(segments), nd.array(lens),
               nd.array(pos))
    with torch.no_grad():
        out = tnet(*(torch.from_numpy(a) for a in (tokens, segments, lens,
                                                   pos)))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.asnumpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("fmt", ["save_parameters", "arg_names"])
def test_bert_loads_from_a_reference_params_file(tmp_path, fmt):
    jnet = _ref_net()
    path = str(tmp_path / "bert.params")
    if fmt == "save_parameters":
        jnet.save_parameters(path)
        assert "encoder.5.attn.qkv.weight" in jser.load_ndarrays(path)[1]
    else:
        params = {k: p.data().asnumpy()
                  for k, p in jnet.collect_params().items()}
        jser.save_ndarrays(path, list(params.values()),
                           ["arg:" + k for k in params])
    assert tser.is_mxnet_binary(path)
    tnet = tbert.bert_tiny(vocab_size=100, max_length=16, device="cpu")
    convert.load_mxnet_params(tnet, path)
    _forward_equal(jnet, tnet)


def test_pretrain_step_loads_structural_names_and_refuses_unnamed(tmp_path):
    jnet = _ref_net()
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    arrays, names = tser.load_ndarrays(path)
    wrapped = str(tmp_path / "step.params")
    tser.save_ndarrays(wrapped, arrays, ["bert." + n for n in names])
    step = tbert.PretrainStep(tbert.bert_tiny(vocab_size=100, max_length=16,
                                              device="cpu"))
    convert.load_mxnet_params(step, wrapped)
    _forward_equal(jnet, step.bert)
    unnamed = str(tmp_path / "list.params")
    tser.save_ndarrays(unnamed, arrays)
    with pytest.raises(ValueError, match="unnamed"):
        convert.load_mxnet_params(step, unnamed)


@pytest.mark.parametrize("fmt", ["save_parameters", "arg_names"])
def test_transformer_lm_loads_from_a_reference_params_file(tmp_path, fmt):
    from mxnet_tpu.models import TransformerLM as JaxLM
    from mxnet_tpu_torch.models import TransformerLM
    mx.random.seed(2)
    jnet = JaxLM(50, units=32, num_layers=2, num_heads=2, max_len=16)
    jnet.initialize(mx.init.Xavier())
    tokens = np.random.default_rng(3).integers(0, 50, (2, 16)).astype(
        "int32")
    ref = jnet(nd.array(tokens)).asnumpy()
    path = str(tmp_path / "lm.params")
    if fmt == "save_parameters":
        jnet.save_parameters(path)
    else:
        params = {k: p.data().asnumpy()
                  for k, p in jnet.collect_params().items()}
        jser.save_ndarrays(path, list(params.values()),
                           ["arg:" + k for k in params])
    tnet = TransformerLM(50, units=32, num_layers=2, num_heads=2, max_len=16,
                         device="cpu")
    convert.load_mxnet_params(tnet, path)
    with torch.no_grad():
        out = tnet(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
