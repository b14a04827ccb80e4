"""The port's BERT pretraining path against the JAX package.

A ``bert_tiny`` (2 layers, 128 units, 2 heads, hidden 512, vocab 100,
max_length 16, dropout 0) with reference weights from ``mx.init.Xavier()``,
carried across by ``convert``, at batch 3, seq 16 and 3 masked slots:

- ``BERTModel``'s four outputs, with ``valid_len`` None and given (lengths
  16, 9 and 1: no row is fully masked), with and without
  ``masked_positions``, at atol/rtol 1e-4 (fp32, sums in another order);
- ``BERTPretrainingLoss`` with ``picked`` True and False: fp32 at 1e-5;
  with bf16 logits, whose log-softmax both take op for op in bf16, the
  float32 loss (the float32 weights promote it) within one bf16 ulp (2^-7
  relative);
- 5 Adam steps of ``ShardedTrainer`` over ``PretrainStep`` (the reference's
  from ``example/bert/pretrain_bert.py``) and over a variant of it that
  passes a ``valid_len``: losses, and the parameters after ``sync_back``,
  at atol/rtol 1e-4, as ``tests/test_torch_training.py`` holds the
  TransformerLM;
- the name map both ways, for a plain and a ``PretrainStep``-wrapped net,
  and its refusals.

Both packages take their plain attention path on the CPU; the non-causal
key-masked kernel's plain version is held against the Pallas kernel in
``tests/test_torch_flash_attention.py`` and
``tests/test_torch_flash_backward.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.parallel import ShardedTrainer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB, SEQ, BATCH, MASKS = 100, 16, 3, 3
ATOL = 1e-4
LENS = np.array([16, 9, 1], "float32")


def _example():
    spec = importlib.util.spec_from_file_location(
        "pretrain_bert_example", REPO / "example" / "bert" /
        "pretrain_bert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _pair():
    mx.random.seed(0)
    jnet = jbert.bert_tiny(vocab_size=VOCAB, max_length=SEQ)
    jnet.initialize(mx.init.Xavier())
    tnet = tbert.bert_tiny(vocab_size=VOCAB, max_length=SEQ, device="cpu")
    convert.load_mxnet_params(tnet, _ref_params(jnet), prefix=jnet.prefix)
    return jnet, tnet


def _batch(seed=3):
    return tbert.synthetic_batch(np.random.default_rng(seed), BATCH, SEQ,
                                 VOCAB, MASKS)


def _close(out, ref, atol=ATOL, name=""):
    np.testing.assert_allclose(out.detach().float().numpy(), ref,
                               atol=atol, rtol=atol, err_msg=name)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("positions", [False, True])
def test_bert_forward_matches(valid, positions):
    jnet, tnet = _pair()
    tokens, segments, pos, *_ = _batch()
    jargs = [nd.array(tokens), nd.array(segments),
             nd.array(LENS) if valid else None,
             nd.array(pos) if positions else None]
    ref = jnet(*jargs)
    targs = [torch.from_numpy(tokens), torch.from_numpy(segments),
             torch.from_numpy(LENS) if valid else None,
             torch.from_numpy(pos) if positions else None]
    with torch.no_grad():
        out = tnet(*targs)
    assert out[2].shape == ((BATCH, MASKS, VOCAB) if positions
                            else (BATCH, SEQ, VOCAB))
    for name, o, r in zip(("seq", "pooled", "mlm_logits", "nsp_logits"),
                          out, ref):
        assert tuple(o.shape) == r.shape, name
        _close(o, r.asnumpy(), name=name)


def test_gather_positions_takes_float_positions():
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    pos = torch.tensor([[3.0, 0.0], [1.0, 1.0]])
    out = tbert._gather_positions(x, pos)
    assert torch.equal(out, torch.stack([x[0, 3], x[0, 0], x[1, 1],
                                         x[1, 1]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 1500])
def test_embedding_gradient_sums_each_id(rows, dtype):
    """The Embedding weight gradient that BERT's segment (2 rows, one-hot
    product) and word (1500 rows, float32 index_put_) tables take: each
    row is the float64 sum of its id's gradient rows, to 1e-5 of the
    largest in fp32 and one bf16 rounding (2^-8 relative) in bf16, and the
    same bits on a second call."""
    from mxnet_tpu_torch.gluon.nn import Embedding
    rng = np.random.default_rng(8)
    ids = rng.integers(0, rows, (4, 512))
    ids[:, :300] = rows - 1                   # one id repeated 1200 times
    up = rng.standard_normal((4, 512, 8)).astype("float32")
    dt = getattr(torch, dtype)
    up_t = torch.from_numpy(up).to(dt)
    want = np.zeros((rows, 8))
    np.add.at(want, ids.reshape(-1),
              up_t.double().numpy().reshape(-1, 8))
    emb = Embedding(rows, 8, device="cpu", dtype=dt)
    grads = []
    for _ in range(2):
        emb.weight.grad = None
        emb(torch.from_numpy(ids)).backward(up_t)
        grads.append(emb.weight.grad.clone())
    assert grads[0].dtype == dt and torch.equal(grads[0], grads[1])
    tol = (1e-5 if dtype == "float32" else 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(grads[0].double().numpy(), want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("picked", [True, False])
def test_pretraining_loss_matches(picked, dtype):
    rng = np.random.default_rng(5)
    T = MASKS if picked else SEQ
    logits = (2 * rng.standard_normal((BATCH, T, VOCAB))).astype("float32")
    nsp = rng.standard_normal((BATCH, 2)).astype("float32")
    _, _, pos, labels, weights, nsp_labels = _batch()
    weights[1, 2] = 0.0                          # a padded slot
    ref = jbert.BERTPretrainingLoss(picked=picked)(
        nd.array(logits).astype(dtype), nd.array(nsp).astype(dtype),
        nd.array(labels), nd.array(pos), nd.array(weights),
        nd.array(nsp_labels))
    tdt = getattr(torch, dtype)
    out = tbert.BERTPretrainingLoss(picked=picked)(
        torch.from_numpy(logits).to(tdt), torch.from_numpy(nsp).to(tdt),
        *(torch.from_numpy(a) for a in (labels, pos, weights, nsp_labels)))
    assert out.shape == () and out.dtype == torch.float32
    assert str(ref.dtype) == "float32"
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(float(out), float(ref.asnumpy()), rtol=tol,
                               atol=0)


def test_pretraining_loss_refuses_unpicked_logits():
    _, _, pos, labels, weights, nsp_labels = _batch()
    with pytest.raises(ValueError, match="picked=True"):
        tbert.BERTPretrainingLoss(picked=True)(
            torch.zeros(BATCH, SEQ, VOCAB), torch.zeros(BATCH, 2),
            *(torch.from_numpy(a) for a in (labels, pos, weights,
                                            nsp_labels)))


class _TorchStepWithLen(tbert.PretrainStep):
    """``PretrainStep`` with a ``valid_len`` input, so that a key mask
    reaches every attention layer."""

    def forward(self, tokens, segments, valid_len, positions, labels,
                weights, nsp_labels):
        _, _, mlm, nsp = self.bert(tokens, segments, valid_len, positions)
        return self.loss(mlm, nsp, labels, positions, weights, nsp_labels)


def _jax_step_with_len(base):
    class _JaxStepWithLen(base):
        def hybrid_forward(self, F, tokens, segments, valid_len, positions,
                           labels, weights, nsp_labels):
            _, _, mlm, nsp = self.bert(tokens, segments, valid_len,
                                       positions)
            return self.loss(mlm, nsp, labels, positions, weights,
                             nsp_labels)
    return _JaxStepWithLen


@pytest.mark.parametrize("valid", [False, True])
def test_pretrain_step_follows_reference_adam(valid):
    ex = _example()
    jnet, tnet = _pair()
    jcls = _jax_step_with_len(ex.PretrainStep) if valid else ex.PretrainStep
    tcls = _TorchStepWithLen if valid else tbert.PretrainStep
    jtr = jparallel.ShardedTrainer(
        jcls(jnet), ex.PretrainLoss(), "adam", {"learning_rate": 1e-3},
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    ttr = ShardedTrainer(tcls(tnet), tbert.PretrainLoss(), "adam",
                         {"learning_rate": 1e-3}, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(5):
        batch = list(tbert.synthetic_batch(rng, BATCH, SEQ, VOCAB, MASKS))
        if valid:
            batch.insert(2, LENS)
        dummy = np.zeros((BATCH,), "float32")
        ref = float(jtr.step(tuple(nd.array(a) for a in batch),
                             nd.array(dummy)).asnumpy())
        loss = ttr.step(tuple(batch), dummy)
        assert loss.shape == ()
        np.testing.assert_allclose(float(loss), ref, atol=ATOL, rtol=ATOL)
    jtr.sync_back()
    ttr.sync_back()
    ref = convert.state_dict_from_mxnet(_ref_params(jnet),
                                        prefix=jnet.prefix)
    own = tnet.state_dict()
    assert set(own) == set(ref)
    for name, r in ref.items():
        _close(own[name], r.numpy(), name=name)


def test_name_map_round_trips_plain_and_wrapped():
    jnet, tnet = _pair()
    ref = _ref_params(jnet)
    names = convert.mxnet_params_from_state_dict(tnet)
    assert {n[len("bertmodel0_"):] for n in names} == \
        {n[len(jnet.prefix):] for n in ref}
    assert set(convert.mxnet_params_from_state_dict(tnet.state_dict())) \
        == set(names)
    back = convert.state_dict_from_mxnet(names)
    sd = tnet.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # a PretrainStep: the outer prefix, both ways
    step = tbert.PretrainStep(tnet)
    wrapped = convert.mxnet_params_from_state_dict(step)
    assert all(n.startswith("pretrainstep0_bertmodel0_") for n in wrapped)
    assert len(wrapped) == len(ref)
    other = tbert.PretrainStep(tbert.bert_tiny(vocab_size=VOCAB,
                                               max_length=SEQ, device="cpu"))
    convert.load_mxnet_params(other, wrapped)
    assert all(torch.equal(v, step.state_dict()[k])
               for k, v in other.state_dict().items())
    convert.load_mxnet_params(other, {"pretrainstep0_" + k: v
                                      for k, v in ref.items()},
                              prefix="pretrainstep0_" + jnet.prefix)
    for k, v in convert.state_dict_from_mxnet(ref, jnet.prefix).items():
        assert torch.equal(other.state_dict()["bert." + k], v)


def _refusal(params, change):
    p = dict(params)
    first = sorted(p)[0]
    if change == "missing":
        name = [n for n in p if n.endswith("nsp_bias")][0]
        del p[name]
        return p, "nsp.bias"
    if change == "extra":
        p[first.split("encoder_")[0] + "encoder_extra_weight"] = p[first]
        return p, "encoder_extra_weight"
    if change == "duplicate":
        name = [n for n in p if n.endswith("encoder_layernorm0_gamma")][0]
        p[name.replace("layernorm0", "layernorm7")] = p[name]
        return p, "encoder.ln.gamma"
    name = [n for n in p if n.endswith("pooler_weight")][0]
    p[name] = np.zeros((3, 3), "float32")
    return p, "pooler.weight"


@pytest.mark.parametrize("change", ["missing", "extra", "duplicate",
                                    "shape"])
def test_name_map_refuses_with_the_name(change):
    jnet, tnet = _pair()
    params, name = _refusal(_ref_params(jnet), change)
    with pytest.raises(ValueError, match=name):
        convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)


def test_name_map_refuses_a_transformer_name_and_an_unknown_model():
    jnet, tnet = _pair()
    params = _ref_params(jnet)
    params[jnet.prefix + "head_weight"] = np.zeros((VOCAB, 128), "float32")
    with pytest.raises(ValueError, match="head_weight"):
        convert.load_mxnet_params(tnet, params, prefix=jnet.prefix)
    with pytest.raises(TypeError, match="Linear"):
        convert.load_mxnet_params(torch.nn.Linear(2, 2), {})
