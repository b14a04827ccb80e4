"""Registry-op cases of the contrib, spatial and detection parity tests.

A case names a registry op, its arguments (seeded numpy arrays or Python
values) and keyword arguments, a tolerance, and, for a differentiable op,
the arguments to differentiate. The reference's results (the JAX
package's op, and its gradients by ``jax.grad``) are computed for every
case of a file at once, in ``jax.jit`` chunks (``_parity.
reference_results``); the port's op runs on the CPU on the same arrays.

Tolerances: ``"exact"`` holds dtype, shape and bits (``-0.0`` is not
``0.0``; NaN matches NaN); a float ``tol`` holds dtype and shape and every
value within ``tol`` of the largest magnitude of the reference's output.
A gradient is ``grad(sum_i <out_i, c_i>)`` with the cotangents ``c_i``
drawn from a seed by shape (:func:`cotangent`), both sides alike.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

from _parity import dtype_of, flat, to_numpy


class Case:
    def __init__(self, op, args, kw=None, tol=1e-5, grad=()):
        self.op, self.args, self.kw, self.tol = op, list(args), kw or {}, tol
        self.grad = tuple(grad)


def cotangent(shape):
    """The seeded cotangent of an output of ``shape`` (float32)."""
    seed = 7 + sum((i + 1) * int(d) for i, d in enumerate(shape))
    return onp.random.default_rng(seed).standard_normal(shape).astype(
        onp.float32)


def _jax_args(case):
    return [jnp.asarray(a) if isinstance(a, onp.ndarray) else a
            for a in case.args]


def _torch_args(case, grad=False):
    out = []
    for i, a in enumerate(case.args):
        if isinstance(a, onp.ndarray):
            t = torch.from_numpy(a.copy())
            if grad and i in case.grad:
                t.requires_grad_(True)
            a = t
        out.append(a)
    return out


def _kw(case, conv):
    return {k: conv(v) if isinstance(v, onp.ndarray) else v
            for k, v in case.kw.items()}


def reference_thunks(cases):
    """``{name: thunk}`` of the reference's op on each case: its outputs,
    or, for a differentiable case, ``(outputs, gradients)`` from one
    ``jax.vjp`` (one program for both)."""
    thunks = {}
    for name, case in cases.items():
        fn = jreg.get_op(case.op).fn

        def run(fn=fn, case=case):
            args = _jax_args(case)
            if not case.grad:
                return fn(*args, **_kw(case, jnp.asarray))

            def part(*diff):
                full = list(args)
                for i, d in zip(case.grad, diff):
                    full[i] = d
                return fn(*full, **_kw(case, jnp.asarray))
            outs, vjp = jax.vjp(part, *[args[i] for i in case.grad])
            cots = [jnp.asarray(cotangent(o.shape)).astype(o.dtype)
                    if jnp.issubdtype(o.dtype, jnp.floating)
                    else onp.zeros(o.shape, jax.dtypes.float0)
                    for o in flat(outs)]
            grads = vjp(type(outs)(cots) if isinstance(outs, (tuple, list))
                        else cots[0])
            return outs, grads
        thunks[name] = run
    return thunks


def check(case, ref, name):
    """The port's outputs (and gradients) of ``case`` against the
    reference's result ``ref`` (see :func:`reference_thunks`)."""
    want, want_grads = ref if case.grad else (ref, None)
    got = port_forward(case)
    assert_close(got, want, case.tol, name)
    if case.grad:
        tol = 1e-5 if case.tol == "exact" else case.tol
        assert_close(port_grads(case), want_grads, tol, name + "/grad")
    return got, want


def port_forward(case):
    with torch.no_grad():
        return treg.get_op(case.op).fn(*_torch_args(case),
                                       **_kw(case, torch.from_numpy))


def port_grads(case):
    args = _torch_args(case, grad=True)
    outs = flat(treg.get_op(case.op).fn(*args,
                                        **_kw(case, torch.from_numpy)))
    loss = sum((o * torch.from_numpy(cotangent(tuple(o.shape)))).sum()
               for o in outs if o.is_floating_point())
    return torch.autograd.grad(loss, [args[i] for i in case.grad],
                               allow_unused=True)


def _bits(a):
    return a.view(onp.dtype("u%d" % a.dtype.itemsize)) if a.dtype.kind == "f" \
        else a


def assert_close(got, want, tol, what=""):
    got, want = flat(got), flat(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None:                   # no path from this input: zero
            g = onp.zeros(onp.shape(w), onp.asarray(w).dtype)
        assert dtype_of(g) == dtype_of(w), (what, k, dtype_of(g),
                                            dtype_of(w))
        gv, wv = to_numpy(g), to_numpy(w)
        assert gv.shape == wv.shape, (what, k, gv.shape, wv.shape)
        if tol == "exact" or wv.dtype.kind in "biu":
            onp.testing.assert_array_equal(_bits(gv), _bits(wv),
                                           err_msg="%s[%d]" % (what, k))
            continue
        gv, wv = gv.astype(onp.float64), wv.astype(onp.float64)
        onp.testing.assert_array_equal(onp.isnan(gv), onp.isnan(wv),
                                       err_msg=what)
        ok = ~onp.isnan(wv)
        scale = max(float(onp.abs(wv[ok]).max()) if ok.any() else 0.0,
                    1e-30)
        err = float(onp.abs(gv[ok] - wv[ok]).max()) if ok.any() else 0.0
        assert err <= tol * scale, "%s[%d]: %.3g of max %.3g (tol %g)" % (
            what, k, err / scale, scale, tol)


# ---- NMS inputs -------------------------------------------------------------

NEAR = 1e-5   # no IoU the sweep compares may lie this close to a threshold


def iou64(a, b):
    """The IoU of corner boxes in float64 (for drawing inputs only)."""
    a, b = a.astype(onp.float64), b.astype(onp.float64)
    tl = onp.maximum(a[:, None, :2], b[None, :, :2])
    br = onp.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = onp.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return onp.clip(x[:, 2] - x[:, 0], 0, None) * onp.clip(
            x[:, 3] - x[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return onp.where(union > 0, inter / onp.where(union > 0, union, 1), 0)


def near_pairs(boxes, thr):
    """``(i, j)``, ``i < j``: the pairs of boxes whose IoU is within
    :data:`NEAR` of ``thr``."""
    iou = iou64(boxes, boxes)
    return onp.nonzero(onp.triu(onp.abs(iou - thr) < NEAR, 1))


def near(boxes, thr):
    """The later box of each pair too near ``thr`` (the ones to
    redraw)."""
    return onp.unique(near_pairs(boxes, thr)[1])


def keep_rows(out):
    """Which rows an NMS output keeps (not all -1)."""
    o = onp.asarray(to_numpy(flat(out)[0]))
    o = o.reshape(-1, o.shape[-1])
    return ~(o == -1).all(-1)
