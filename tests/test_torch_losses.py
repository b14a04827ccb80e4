"""The port's Gluon losses against the JAX package's.

Every loss on the same numpy inputs (fp32), without and with a
``sample_weight``, at atol/rtol 1e-6 (the same arithmetic op for op;
transcendental functions of two libraries may differ in the last bit):
``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss`` (with and
without ``from_sigmoid`` and ``pos_weight``), ``SoftmaxCrossEntropyLoss``
(sparse and dense labels), ``KLDivLoss`` (both ``from_logits``),
``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss`` (both
label formats), ``TripletLoss``, ``PoissonNLLLoss`` (both ``from_logits``,
``compute_full``), ``CosineEmbeddingLoss`` and ``SDMLLoss``; ``CTCLoss``
in both layouts, with padded labels and with explicit lengths (there also
its gradient, at 1e-5). bf16 inputs give a bf16 loss.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu_torch.gluon import loss as tloss

torch.set_num_threads(1)

TOL = 1e-6
B, D = 4, 6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


def _inputs(case):
    """``(constructor kwargs, inputs, sample_weight shape)`` of a case."""
    r = _rng(len(case))
    f = lambda *s: r.standard_normal(s).astype("float32")   # noqa: E731
    sign = lambda *s: np.where(r.random(s) < 0.5, -1.0, 1.0).astype(  # noqa
        "float32")
    binary = lambda *s: (r.random(s) < 0.5).astype("float32")  # noqa: E731
    prob = lambda *s: r.uniform(0.05, 0.95, s).astype("float32")  # noqa
    name, variant = case
    if name in ("L2Loss", "L1Loss", "HuberLoss"):
        return ({"rho": 0.7} if name == "HuberLoss" else {}), \
            [f(B, D), f(B, D)], (B, 1)
    if name == "SigmoidBinaryCrossEntropyLoss":
        sig = variant.startswith("sigmoid")
        inputs = [prob(B, D) if sig else 3 * f(B, D), binary(B, D)]
        return {"from_sigmoid": sig}, inputs, (B, 1)
    if name == "SoftmaxCrossEntropyLoss":
        if variant == "sparse":
            return {}, [f(B, 5, 11), r.integers(0, 11, (B, 5)).astype(
                "float32")], (B, 5, 1)
        return {"sparse_label": False}, [f(B, 11), _softmax(f(B, 11))], \
            (B, 1)
    if name == "KLDivLoss":
        logits = variant == "logits"
        pred = f(B, D) if not logits else np.log(_softmax(f(B, D)))
        return {"from_logits": logits}, [pred, _softmax(f(B, D))], (B, 1)
    if name in ("HingeLoss", "SquaredHingeLoss"):
        return {"margin": 1.5}, [f(B, D), sign(B, D)], (B, 1)
    if name == "LogisticLoss":
        return {"label_format": variant}, \
            [f(B, D), sign(B, D) if variant == "signed" else binary(B, D)], \
            (B, 1)
    if name == "TripletLoss":
        return {"margin": 2.0}, [f(B, D), f(B, D), f(B, D)], (B,)
    if name == "PoissonNLLLoss":
        target = r.poisson(2.0, (B, D)).astype("float32")
        if variant == "logits":
            return {}, [f(B, D), target], (B, 1)
        return {"from_logits": False, "compute_full": variant == "full"}, \
            [prob(B, D) * 4, target], (B, 1)
    if name == "CosineEmbeddingLoss":
        return {"margin": 0.1}, [f(B, D), f(B, D), sign(B)], (B, 1)
    raise AssertionError(case)


CASES = [("L2Loss", ""), ("L1Loss", ""), ("HuberLoss", ""),
         ("SigmoidBinaryCrossEntropyLoss", "logits"),
         ("SigmoidBinaryCrossEntropyLoss", "logits_pos_weight"),
         ("SigmoidBinaryCrossEntropyLoss", "sigmoid"),
         ("SigmoidBinaryCrossEntropyLoss", "sigmoid_pos_weight"),
         ("SoftmaxCrossEntropyLoss", "sparse"),
         ("SoftmaxCrossEntropyLoss", "dense"),
         ("KLDivLoss", "logits"), ("KLDivLoss", "probabilities"),
         ("HingeLoss", ""), ("SquaredHingeLoss", ""),
         ("LogisticLoss", "signed"), ("LogisticLoss", "binary"),
         ("TripletLoss", ""), ("PoissonNLLLoss", "logits"),
         ("PoissonNLLLoss", "rates"), ("PoissonNLLLoss", "full"),
         ("CosineEmbeddingLoss", "")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", CASES, ids=["%s-%s" % c for c in CASES])
def test_loss_matches_reference(case, weighted):
    kwargs, inputs, sw_shape = _inputs(case)
    ref_fn = getattr(jgluon.loss, case[0])(**kwargs)
    own_fn = getattr(tloss, case[0])(**kwargs)
    ref_args = [nd.array(a) for a in inputs]
    own_args = [torch.from_numpy(a) for a in inputs]
    # the reference's blocks take positional arguments only:
    # (..., sample_weight, pos_weight)
    extra = []
    if weighted or case[1].endswith("pos_weight"):
        extra.append(_rng(99).uniform(0.5, 2.0, sw_shape).astype("float32")
                     if weighted else None)
    if case[1].endswith("pos_weight"):
        extra.append(_rng(98).uniform(0.5, 3.0, (D,)).astype("float32"))
    ref = ref_fn(*ref_args, *[None if a is None else nd.array(a)
                              for a in extra]).asnumpy()
    own = own_fn(*own_args, *[None if a is None else torch.from_numpy(a)
                              for a in extra])
    assert own.dtype == torch.float32
    assert tuple(own.shape) == ref.shape
    np.testing.assert_allclose(own.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("smoothing", [0.3, 0.1])
def test_sdml_matches_reference(smoothing):
    r = _rng(5)
    x1, x2 = (r.standard_normal((5, D)).astype("float32") for _ in range(2))
    ref = jgluon.loss.SDMLLoss(smoothing)(nd.array(x1), nd.array(x2))
    own = tloss.SDMLLoss(smoothing)(torch.from_numpy(x1),
                                    torch.from_numpy(x2))
    np.testing.assert_allclose(own.numpy(), ref.asnumpy(), atol=TOL,
                               rtol=TOL)


def _ctc_inputs(layout, label_layout):
    r = _rng(7)
    T, C, L = 12, 6, 4
    pred = r.standard_normal((B, T, C)).astype("float32")
    labels = r.integers(0, C - 1, (B, L)).astype("float32")
    labels[1, 3:] = -1                       # padding
    labels[2, 1] = labels[2, 2] = 2          # a repeat: no skip
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        labels = labels.T.copy()
    return pred, labels


@pytest.mark.parametrize("layout,label_layout,lengths", [
    ("NTC", "NT", False), ("TNC", "TN", True), ("NTC", "TN", True)])
def test_ctc_matches_reference(layout, label_layout, lengths):
    pred, labels = _ctc_inputs(layout, label_layout)
    args_ref, args_own = [nd.array(pred), nd.array(labels)], \
        [torch.from_numpy(pred).requires_grad_(), torch.from_numpy(labels)]
    if lengths:
        pl = np.array([12, 9, 12, 5], "float32")
        ll = np.array([4, 3, 4, 2], "float32")
        args_ref += [nd.array(pl), nd.array(ll)]
        args_own += [torch.from_numpy(pl), torch.from_numpy(ll)]
    ref_fn = jgluon.loss.CTCLoss(layout, label_layout)
    own_fn = tloss.CTCLoss(layout, label_layout)
    ref = ref_fn(*args_ref).asnumpy()
    own = own_fn(*args_own)
    assert own.shape == (B,) and own.dtype == torch.float32
    np.testing.assert_allclose(own.detach().numpy(), ref, atol=TOL,
                               rtol=TOL)
    sw = np.array([1.0, 0.5, 2.0, 0.0], "float32")
    pad = [None] * (4 - len(args_own))
    np.testing.assert_allclose(
        own_fn(*args_own, *pad, torch.from_numpy(sw)).detach().numpy(),
        ref_fn(*args_ref, *pad, nd.array(sw)).asnumpy(), atol=TOL,
        rtol=TOL)
    if not lengths:
        return
    # the gradient of the summed loss, against the reference's autograd
    import mxnet_tpu as mx
    jpred = args_ref[0]
    jpred.attach_grad()
    with mx.autograd.record():
        jl = ref_fn(jpred, *args_ref[1:])
    jl.backward()
    own.sum().backward()
    np.testing.assert_allclose(args_own[0].grad.numpy(),
                               jpred.grad.asnumpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["L2Loss", "L1Loss", "HuberLoss",
                                  "HingeLoss", "LogisticLoss",
                                  "SigmoidBinaryCrossEntropyLoss"])
def test_bf16_inputs_give_a_bf16_loss(name):
    kwargs, inputs, _ = _inputs((name, "logits" if "Sigmoid" in name
                                 else "signed" if name == "LogisticLoss"
                                 else ""))
    fn = getattr(tloss, name)(**kwargs)
    own32 = fn(*[torch.from_numpy(a) for a in inputs])
    own16 = fn(*[torch.from_numpy(a).bfloat16() for a in inputs])
    assert own16.dtype == torch.bfloat16
    np.testing.assert_allclose(own16.float().numpy(), own32.numpy(),
                               rtol=2 ** -6, atol=2 ** -6)


def test_refusals():
    with pytest.raises(ValueError, match="label_format"):
        tloss.LogisticLoss(label_format="tri")
    with pytest.raises(ValueError, match="layout"):
        tloss.CTCLoss("NCT")
    with pytest.raises(TypeError, match="weight must be a number"):
        tloss.L1Loss(weight=np.ones(2))(torch.zeros(2, 2), torch.zeros(2, 2))
