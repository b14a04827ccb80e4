"""Faults of the port's ops against the JAX package, now repaired.

- bf16 rounding (ROADMAP C5): ``gelu``, ``softmax`` (also inside the plain
  attention and with ``use_length``), average and sum ``Pooling``,
  ``log_softmax``, ``sigmoid``, ``softrelu``, ``selu`` and the other
  ``LeakyReLU`` variants round op by op as the reference's jax functions
  do. Each is held bitwise (tolerance 0) on bf16 casts of the same numpy
  input, at the shapes the models use: (64, 1000), the NSP head's
  (256, 2), and pooling at (4, 16, 14, 14) with a 3x3 window, stride 2
  and pad 1 in both ``pooling_convention``s.
- ``arange`` (C6): the registry has the reference's ``_arange`` (alias
  ``_contrib_arange``) and no ``arange``; the values are the reference's
  float32 ones, bitwise, for fractional steps and ``repeat``.
- Shape arguments (C7): ``squeeze`` of an axis whose size is not 1 raises
  ``ValueError``; ``expand_dims`` and ``softmax`` take tuple axes;
  ``clip`` with no bound returns the input's values.
- The registry gate: the snapshot names the port lacks are exactly
  ``MISSING_SNAPSHOT_NAMES`` (25 since item 8's steps 1-4: the 13
  quantization names, ``Custom`` and ``_npi_Custom``, the 7 graph names
  that wait for sparse storage, and ``_CrossDeviceCopy``, ``_NDArray``
  and ``_Native``, which the reference does not register either).
- Attention-dropout keys (C9): both key words reach the generator that
  draws the plain path's dropout mask and the kernels' int32 seed, so
  two keys that share their last word give different masks and seeds,
  and one key gives the same ones twice.
- Negative slice steps (C11): ``x[::-1]``, ``x[4:1:-1]``, ``x[::-2] = 0``,
  ``x[::-1, ::2]``, mixed 2-D keys and ``nd.slice``/``crop`` with a
  negative ``step`` read and write as the reference's, in ``nd`` and
  ``mx.np`` (one helper, ``ops/_jnp.getitem``/``setitem``).
- Out-of-range integer indices (C12): a read clamps (``arange(6)[10]`` is
  5, ``[-10]`` is 0, an index array clamps), a write there is dropped, in
  both frontends; ``mx.np.take`` with a float index raises.
- NaN, signed zeros and zero divisors (C13), bitwise in float16, float32
  and float64: ``sign`` keeps NaN and -0.0, ``angle`` gives pi at -0.0 and
  NaN at NaN, ``heaviside(NaN, h)`` is ``h``, float ``floor_divide`` by
  ±0 is NaN, ``relu`` and ``Activation("relu")`` of -0.0 are +0.0.
- Boolean inputs (C14): ``left_shift``/``right_shift``, ``inner``/``vdot``
  and ``isin``/``in1d`` with a boolean first operand compute in an
  integer type and give the reference's result dtype.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import core as jcore
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import registry as jregistry
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import core as tcore
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as tregistry


def _bf16_pair(shape, seed=0, scale=2.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        "float32")
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _bitwise(own, ref):
    assert own.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        own.float().numpy(), np.asarray(ref.astype(jnp.float32)))


ACTS = {
    "gelu": (lambda x: jnn.gelu.fn(x), tnn.gelu),
    "sigmoid": (lambda x: jnn.Activation.fn(x, act_type="sigmoid"),
                lambda x: tnn.Activation(x, act_type="sigmoid")),
    "sigmoid_op": (lambda x: jnn.sigmoid.fn(x), tnn.sigmoid),
    "softrelu": (lambda x: jnn.Activation.fn(x, act_type="softrelu"),
                 lambda x: tnn.Activation(x, act_type="softrelu")),
    "softrelu_op": (lambda x: jnn.softrelu.fn(x), tnn.softrelu),
    "selu": (lambda x: jnn.LeakyReLU.fn(x, act_type="selu"),
             lambda x: tnn.LeakyReLU(x, act_type="selu")),
    "elu": (lambda x: jnn.LeakyReLU.fn(x, act_type="elu", slope=0.3),
            lambda x: tnn.LeakyReLU(x, act_type="elu", slope=0.3)),
    "leaky": (lambda x: jnn.LeakyReLU.fn(x, act_type="leaky", slope=0.3),
              lambda x: tnn.LeakyReLU(x, act_type="leaky", slope=0.3)),
    "softmax": (lambda x: jnn.softmax.fn(x), tnn.softmax),
    "log_softmax": (lambda x: jnn.log_softmax.fn(x),
                    lambda x: tnn._log_softmax(x)),
}


@pytest.mark.parametrize("shape", [(64, 1000), (256, 2)])
@pytest.mark.parametrize("name", sorted(ACTS))
def test_bf16_ops_round_as_reference(name, shape):
    ref_fn, own_fn = ACTS[name]
    xj, xt = _bf16_pair(shape)
    _bitwise(own_fn(xt), ref_fn(xj))


def test_bf16_log_softmax_shapes_and_masked_softmax():
    for shape in [(64, 30522), (8, 128)]:
        xj, xt = _bf16_pair(shape, seed=1)
        _bitwise(tnn.log_softmax(xt), jnn.log_softmax.fn(xj))
    xj, xt = _bf16_pair((4, 6, 50), seed=2)
    length = np.array([[1, 50, 7, 20, 3, 9]] * 4, dtype="int32")
    _bitwise(tnn.softmax(xt, length=torch.from_numpy(length), use_length=True),
             jnn.softmax.fn(xj, length=jnp.asarray(length), use_length=True))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_attention_matches_bitwise(causal):
    """The plain attention path (decode, chunk, verify and BERT off the
    kernel) at head_dim 32, whose 1/sqrt(32) rounds in bf16. V holds the
    identity in its first 16 columns, so the output is the softmax weights
    themselves (the weights-by-V product's summation order is XLA's or
    torch's and is not what is held here)."""
    qj, qt = _bf16_pair((2, 3, 16, 32), seed=3, scale=1.0)
    kj, kt = _bf16_pair((2, 3, 16, 32), seed=4, scale=1.0)
    v = np.zeros((2, 3, 16, 32), "float32")
    v[..., :16] = np.eye(16, dtype="float32")
    vj, vt = jnp.asarray(v).astype(jnp.bfloat16), torch.from_numpy(v).bfloat16()
    mask = np.ones((2, 16), "float32")
    mask[1, 11:] = 0
    ref = jnn.dot_product_attention.fn(qj, kj, vj, jnp.asarray(mask),
                                       causal=causal)
    own = tnn.dot_product_attention(qt, kt, vt, torch.from_numpy(mask),
                                    causal=causal)
    _bitwise(own, ref)


@pytest.mark.parametrize("pool_type,count_include_pad", [
    ("avg", True), ("avg", False), ("sum", True)])
@pytest.mark.parametrize("convention", ["valid", "full"])
def test_bf16_pooling_sums_in_order(pool_type, convention, count_include_pad):
    xj, xt = _bf16_pair((4, 16, 14, 14), seed=6)
    kw = dict(kernel=(3, 3), pool_type=pool_type, stride=(2, 2), pad=(1, 1),
              pooling_convention=convention,
              count_include_pad=count_include_pad)
    _bitwise(tnn.Pooling(xt, **kw), jnn.Pooling.fn(xj, **kw))


def test_fp32_pooling_still_matches():
    x = np.random.default_rng(7).standard_normal((2, 3, 9, 9)).astype(
        "float32")
    for kw in [dict(kernel=(2, 2), pool_type="avg", stride=(2, 2)),
               dict(kernel=(3,), pool_type="sum", stride=(2,), pad=(1,)),
               dict(kernel=(2, 2, 2), pool_type="lp", stride=(1, 1, 1))]:
        xx = x if len(kw["kernel"]) == 2 else (
            x[:, :, 0] if len(kw["kernel"]) == 1
            else x.reshape(2, 3, 3, 3, 9)[..., :4])
        ref = np.asarray(jnn.Pooling.fn(jnp.asarray(xx), **kw))
        own = tnn.Pooling(torch.from_numpy(np.ascontiguousarray(xx)), **kw)
        np.testing.assert_allclose(own.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---- C6: arange -----------------------------------------------------------

@pytest.mark.parametrize("args,repeat", [((0, 1, 0.1), 1), ((0.5, 7.3, 0.7), 1),
                                         ((-3, 3, 0.3), 1), ((0, 2, 0.3), 2),
                                         ((2, 11, 3), 1)])
def test_arange_values_bitwise(args, repeat):
    ref = jnd.arange(*args, repeat=repeat).asnumpy()
    with tmx.cpu():
        own = tnd.arange(*args, repeat=repeat).asnumpy()
        op = tnd._arange(*args, repeat=repeat).asnumpy()
        alias = tnd._contrib_arange(*args, repeat=repeat).asnumpy()
    for out in (own, op, alias):
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        own, np.asarray(jregistry.get_op("_arange").fn(*args, repeat=repeat)))


def _static_names(registry):
    """The registry's names but the subgraph regions a partition
    registers at run time (``_subgraph_<backend>_<n>``, made by
    ``symbol/subgraph.py`` in whichever package partitioned)."""
    return {n for n in registry.list_ops() if not getattr(
        registry.get_op(n).fn, "__module__", "").endswith("symbol.subgraph")}


def test_registry_names_are_reference_names():
    own = _static_names(tregistry)
    ref = _static_names(jregistry)
    assert "_arange" in own and "_contrib_arange" in own
    assert "arange" not in own
    assert own - ref == set()


# The snapshot names (tests/data/reference_ops.txt) that the port's
# registry lacks: the reference lacks them too (its registry-parity test
# allows them), and no name may join them.
MISSING_SNAPSHOT_NAMES = frozenset(["_CrossDeviceCopy", "_NDArray",
                                    "_Native"])


def test_missing_snapshot_names_are_the_listed_ones():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "reference_ops.txt")
    with open(path) as f:
        snapshot = {line.strip() for line in f if line.strip()}
    missing = snapshot - set(tregistry.list_ops())
    assert len(MISSING_SNAPSHOT_NAMES) <= 3
    assert missing - MISSING_SNAPSHOT_NAMES == set(), "new gaps"
    assert MISSING_SNAPSHOT_NAMES - missing == set(), \
        "ported: take these names off the list"
    assert not MISSING_SNAPSHOT_NAMES & set(jregistry.list_ops())


def test_every_reference_name_resolves_in_the_port():
    # the package's own names (tests register ops of their own modules)
    ref = {n for n in _static_names(jregistry) if getattr(
        jregistry.get_op(n).fn, "__module__", "").startswith("mxnet_tpu.")}
    assert len(ref) == 878
    assert ref - set(tregistry.list_ops()) == set()

# ---- C7: shape arguments --------------------------------------------------

def test_squeeze_of_a_wide_axis_raises_as_reference():
    x = np.zeros((2, 1, 3), "float32")
    with pytest.raises(ValueError):
        jcore.squeeze.fn(jnp.asarray(x), axis=0)
    with pytest.raises(ValueError):
        tcore.squeeze.fn(torch.from_numpy(x), axis=0)
    with pytest.raises(ValueError):
        tcore.squeeze.fn(torch.from_numpy(x), axis=(1, 2))
    assert tuple(tcore.squeeze.fn(torch.from_numpy(x), axis=1).shape) == tuple(
        jcore.squeeze.fn(jnp.asarray(x), axis=1).shape)


@pytest.mark.parametrize("axis", [0, (0, 2), (-1, 1), (3, 0)])
def test_expand_dims_tuple_axes(axis):
    x = np.arange(6.0, dtype="float32").reshape(2, 3)
    ref = np.asarray(jcore.expand_dims.fn(jnp.asarray(x), axis=axis))
    own = tcore.expand_dims.fn(torch.from_numpy(x), axis=axis).numpy()
    assert own.shape == ref.shape
    np.testing.assert_array_equal(own, ref)


def test_softmax_tuple_axis_and_clip_without_bounds():
    x = np.random.default_rng(8).standard_normal((2, 3, 4)).astype("float32")
    ref = np.asarray(jnn.softmax.fn(jnp.asarray(x), axis=(0, 2)))
    own = tnn.softmax(torch.from_numpy(x), axis=(0, 2)).numpy()
    np.testing.assert_allclose(own, ref, rtol=1e-6, atol=1e-7)
    ref = np.asarray(jcore.clip.fn(jnp.asarray(x)))
    with tmx.cpu():
        own = tnd.clip(tnd.array(x)).asnumpy()
    np.testing.assert_array_equal(own, ref)


GRADS = {
    "gelu": (lambda x: jnn.gelu.fn(x), tnn.gelu),
    "sigmoid": (lambda x: jnn.sigmoid.fn(x), tnn.sigmoid),
    "softrelu": (lambda x: jnn.softrelu.fn(x), tnn.softrelu),
    "softmax": (lambda x: jnn.softmax.fn(x), tnn.softmax),
    "log_softmax": (lambda x: jnn.log_softmax.fn(x),
                    lambda x: tnn._log_softmax(x)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_bf16_op_gradients_follow_reference(name):
    """The bf16 forms' gradients (one fused backward kernel each) against
    ``jax.grad`` of the reference's bf16 functions, for a random cotangent:
    within 2e-2 of the largest |gradient| (a few bf16 ulps; the two round
    the backward's intermediates differently)."""
    import jax
    ref_fn, own_fn = GRADS[name]
    xj, xt = _bf16_pair((8, 50), seed=9)
    gj, gt = _bf16_pair((8, 50), seed=10, scale=1.0)
    ref = jax.grad(lambda x: (ref_fn(x).astype(jnp.float32)
                              * gj.astype(jnp.float32)).sum())(xj)
    xt.requires_grad_(True)
    own_fn(xt).backward(gt)
    ref = np.asarray(ref.astype(jnp.float32))
    own = xt.grad.float().numpy()
    assert np.abs(own - ref).max() <= 2e-2 * np.abs(ref).max()


def _attention_draws(rng_key):
    """The plain path's output under dropout 0.5 and the kernels' seed,
    both drawn from ``rng_key``'s generator."""
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 2, 8, 16)).astype("float32"))
    out = tnn._attention_op(q, q, q, dropout=0.5, rng_key=rng_key,
                            train=True)
    seed = tnn._kernel_seed(0.5, tnn._key_generator(rng_key), None)
    return out, seed


def test_attention_dropout_key_mixes_both_words():
    a, seed_a = _attention_draws((5, 7))
    b, seed_b = _attention_draws((9, 7))
    again, seed_again = _attention_draws((5, 7))
    assert not torch.equal(a, b)
    assert seed_a != seed_b
    assert torch.equal(a, again) and seed_a == seed_again


# ---- C11, C12: basic indexing as jnp's --------------------------------------

def _read(mod, frontend, key, shape=(6,)):
    n = int(np.prod(shape))
    a = (mod.np.arange(float(n)) if frontend == "np" else mod.nd.arange(n))
    return a.reshape(shape)[key]


def _write(mod, frontend, key, value, shape=(6,)):
    n = int(np.prod(shape))
    a = (mod.np.arange(float(n)) if frontend == "np" else mod.nd.arange(n))
    a = a.reshape(shape)
    a[key] = value
    return a


def _same(own, ref):
    own, ref = own.asnumpy(), np.asarray(ref.asnumpy())
    assert own.dtype == ref.dtype and own.shape == ref.shape
    np.testing.assert_array_equal(own, ref)


INDEX_READS = {
    "step_-1": (slice(None, None, -1), (6,)),
    "4:1:-1": (slice(4, 1, -1), (6,)),
    "-1:-7:-2": (slice(-1, -7, -2), (6,)),
    "10:0:-3": (slice(10, 0, -3), (6,)),
    "2d_-1_1": ((slice(None, None, -1), 1), (3, 4)),
    "2d_-1_2": ((slice(None, None, -1), slice(None, None, 2)), (3, 4)),
    "2d_1_-1": ((1, slice(None, None, -1)), (3, 4)),
    "2d_ell_-2": ((Ellipsis, slice(3, None, -2)), (3, 4)),
    "oob_10": (10, (6,)),
    "oob_-10": (-10, (6,)),
    "oob_2d_5_1": ((5, 1), (3, 4)),
    "oob_2d_1_10": ((1, 10), (3, 4)),
}


@pytest.mark.parametrize("frontend", ["nd", "np"])
@pytest.mark.parametrize("case", sorted(INDEX_READS))
def test_basic_index_reads_as_reference(case, frontend):
    import mxnet_tpu as jmx
    key, shape = INDEX_READS[case]
    ref = _read(jmx, frontend, key, shape)
    with tmx.cpu():
        _same(_read(tmx, frontend, key, shape), ref)


INDEX_WRITES = {
    "step_-2": (slice(None, None, -2), 0, (6,)),
    "4:1:-1": (slice(4, 1, -1), -1, (6,)),
    "2d_-1_2": ((slice(None, None, -1), slice(None, None, 2)), 7, (3, 4)),
    "oob_10": (10, 1, (6,)),
    "oob_-10": (-10, 1, (6,)),
    "oob_2d_1_9": ((1, 9), 5, (3, 4)),
}


@pytest.mark.parametrize("frontend", ["nd", "np"])
@pytest.mark.parametrize("case", sorted(INDEX_WRITES))
def test_basic_index_writes_as_reference(case, frontend):
    import mxnet_tpu as jmx
    key, value, shape = INDEX_WRITES[case]
    ref = _write(jmx, frontend, key, value, shape)
    with tmx.cpu():
        _same(_write(tmx, frontend, key, value, shape), ref)


def test_negative_step_write_through_an_array_value():
    """A write with a negative step takes an array in the slice's order
    (numpy's, as the reference cannot assign arrays through nd keys)."""
    with tmx.cpu():
        a = tnd.arange(6)
        a[4:0:-2] = tnd.array([10.0, 20.0])
        np.testing.assert_array_equal(a.asnumpy(), [0, 1, 20, 3, 10, 5])
        b = tnd.zeros((3, 4))
        b[::-1, ::2] = tnd.array(np.arange(6.0).reshape(3, 2))
        want = np.zeros((3, 4), "float32")
        want[::-1, ::2] = np.arange(6.0).reshape(3, 2)
        np.testing.assert_array_equal(b.asnumpy(), want)


@pytest.mark.parametrize("op", ["slice", "crop"])
@pytest.mark.parametrize("begin,end,step", [
    ((None,), (None,), (-1,)), ((5,), (0,), (-2,)),
    ((2, None), (0, None), (-1, -2)), ((None, 3), (None, None), (1, -1))])
def test_slice_with_negative_steps_as_reference(op, begin, end, step):
    shape = (6,) if len(begin) == 1 else (3, 4)
    x = np.arange(float(np.prod(shape)), dtype="float32").reshape(shape)
    ref = getattr(jnd, op)(jnd.array(x), begin=begin, end=end, step=step)
    with tmx.cpu():
        _same(getattr(tnd, op)(tnd.array(x), begin=begin, end=end,
                               step=step), ref)


def test_index_arrays_clamp_in_both_frontends():
    import mxnet_tpu as jmx
    ref = jmx.nd.arange(6)[jmx.nd.array([7, -8, 2])]
    with tmx.cpu():
        _same(tnd.arange(6)[tnd.array([7, -8, 2])], ref)
        np.testing.assert_array_equal(
            tmx.np.arange(6.0)[tmx.np.array([7, -8, 2], dtype="int64")]
            .asnumpy(), [5.0, 0.0, 2.0])


def test_np_take_with_a_float_index_raises_as_reference():
    import mxnet_tpu as jmx
    with pytest.raises(ValueError, match="integer"):
        jmx.np.take(jmx.np.arange(6.0), jmx.np.array([1.0, 2.0]))
    with tmx.cpu(), pytest.raises(ValueError, match="integer"):
        tmx.np.take(tmx.np.arange(6.0), tmx.np.array([1.0, 2.0]))


# ---- C13: NaN, signed zeros, zero divisors ---------------------------------

C13_X = [np.nan, -0.0, 0.0, -2.0, 3.0, -np.inf]
C13_Y = [0.0, -0.0, 0.0, -0.0, 2.0, 0.5]
C13 = {
    "nd.sign": lambda m, x, y: m.nd.sign(m.nd.array(x, dtype=x.dtype)),
    "np.sign": lambda m, x, y: m.np.sign(m.np.array(x, dtype=x.dtype)),
    "np.angle": lambda m, x, y: m.np.angle(m.np.array(x, dtype=x.dtype)),
    "np.heaviside": lambda m, x, y: m.np.heaviside(
        m.np.array(x, dtype=x.dtype), m.np.array(y + 0.25, dtype=x.dtype)),
    "np.floor_divide": lambda m, x, y: m.np.floor_divide(
        m.np.array(x, dtype=x.dtype), m.np.array(y, dtype=x.dtype)),
    "nd.relu": lambda m, x, y: m.nd.relu(m.nd.array(x, dtype=x.dtype)),
    "nd.Activation": lambda m, x, y: m.nd.Activation(
        m.nd.array(x, dtype=x.dtype), act_type="relu"),
}


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
@pytest.mark.parametrize("fn", sorted(C13))
def test_nan_and_signed_zero_results_bitwise(fn, dtype):
    import mxnet_tpu as jmx
    x, y = np.array(C13_X, dtype), np.array(C13_Y, dtype)
    ref = np.asarray(C13[fn](jmx, x, y).asnumpy())
    with tmx.cpu():
        own = C13[fn](tmx, x, y).asnumpy()
    assert own.dtype == ref.dtype
    # bitwise (signed zeros too); a NaN's sign and payload are the
    # hardware's (x86 makes -NaN, CUDA +NaN), so NaNs match as NaNs
    np.testing.assert_array_equal(np.isnan(own), np.isnan(ref))
    bits = "u%d" % ref.dtype.itemsize
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(own[ok].view(bits), ref[ok].view(bits))


# ---- C14: boolean inputs ----------------------------------------------------

B1, B2 = [True, False, True, True], [True, True, False, True]
C14 = {
    "left_shift": lambda m: m.np.left_shift(m.np.array(B1), m.np.array(B2)),
    "right_shift": lambda m: m.np.right_shift(m.np.array(B1),
                                              m.np.array(B2)),
    "inner": lambda m: m.np.inner(m.np.array(B1), m.np.array(B2)),
    "inner_2d": lambda m: m.np.inner(m.np.array([B1, B2]),
                                     m.np.array([B2, B2, B1])),
    "vdot": lambda m: m.np.vdot(m.np.array([B1, B2]), m.np.array([B2, B1])),
    "isin": lambda m: m.np.isin(m.np.array(B1),
                                m.np.array([1, 2], dtype="int32")),
    "isin_bool": lambda m: m.np.isin(m.np.array(B1), m.np.array([False])),
    "in1d": lambda m: m.np.in1d(m.np.array([B1, B2]), m.np.array([0.0])),
}


@pytest.mark.parametrize("fn", sorted(C14))
def test_bool_inputs_as_reference(fn):
    import mxnet_tpu as jmx
    ref = C14[fn](jmx)
    with tmx.cpu():
        _same(C14[fn](tmx), ref)


def test_shift_of_bool_by_int_keeps_the_int_dtype():
    """Shifting booleans by int32 (which worked before C14's repair) stays
    int32, as the reference's."""
    import mxnet_tpu as jmx
    run = (lambda m: m.np.left_shift(
        m.np.array(B1), m.np.array([1, 2, 3, 0], dtype="int32")))
    ref = run(jmx)
    with tmx.cpu():
        _same(run(tmx), ref)
