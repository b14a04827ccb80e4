"""``mx.np.linalg`` (counterpart of ``mxnet_tpu/numpy/linalg.py``, which
wraps ``jax.numpy.linalg``): each function runs ``torch.linalg`` on its
arguments' device (cuSOLVER and cuBLAS on the card, no host copy), in the
reference's dtype (integers as float32/float64, bf16 and fp16 computed in
float32 and cast back). ``svd`` with no arguments is the ``_npi_svd`` op,
the reference's layout: the reduced ``(u, s, vh)`` with ``a = u @ diag(s)
@ vh``. Factors (``svd``, ``eigh``, ``qr``) may differ from the
reference's in sign."""
from __future__ import annotations

import torch

from ..ops import _jnp


def _np():
    from .. import numpy as np_mod
    return np_mod


def _prepared(*vs):
    dt = _jnp.result_dtype("inexact", *vs)
    work = torch.float32 if dt in (torch.float16, torch.bfloat16) else dt
    return [v.to(work) for v in vs], dt


def _back(out, dt):
    if isinstance(out, (tuple, list)):
        return tuple(_back(o, dt) for o in out)
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return out.to(dt)
    return out


def _wrap(name, tfn, n_arrays=1):
    """``name``: ``tfn`` on the first ``n_arrays`` arguments' tensors (the
    rest passed as they are)."""
    def fn(*args, **kwargs):
        arrays, rest = args[:n_arrays], args[n_arrays:]

        def run(*vs):
            vs, dt = _prepared(*vs)
            return _back(tfn(*vs, *rest, **kwargs), dt)
        return _np()._wrap_record("linalg." + name, run, *arrays)
    fn.__name__ = name
    return fn


def _norm(x, ord=None, axis=None, keepdims=False):
    if isinstance(axis, list):
        axis = tuple(axis)
    if ord is None and axis is None:
        out = torch.linalg.vector_norm(x.reshape(-1))
        return out.reshape((1,) * x.dim()) if keepdims else out
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _svd(a, full_matrices=False, compute_uv=True, hermitian=False):
    driver = "gesvd" if a.is_cuda else None     # as ``_npi_svd``
    if not compute_uv:
        return torch.linalg.svdvals(a, driver=driver)
    if not full_matrices:
        from ..ops.numpy_ops import _npi_svd
        return _npi_svd.fn(a)
    return tuple(torch.linalg.svd(a, full_matrices=True, driver=driver))


def _eigh(a, UPLO=None, symmetrize_input=True):
    if symmetrize_input:
        a = (a + a.transpose(-1, -2).conj()) / 2
    w, v = torch.linalg.eigh(a, UPLO=UPLO or "L")
    return w, v


def _eigvalsh(a, UPLO="L", symmetrize_input=True):
    return _eigh(a, UPLO, symmetrize_input)[0]


def _qr(a, mode="reduced"):
    q, r = torch.linalg.qr(a, mode="complete" if mode == "complete"
                           else "reduced")
    return r if mode == "r" else (q, r)


def _lstsq(a, b, rcond=None, numpy_resid=False):
    x = torch.linalg.pinv(a, rtol=rcond) @ b if rcond is not None else \
        torch.linalg.lstsq(a, b, driver="gelsd" if a.device.type == "cpu"
                           else None).solution
    s = torch.linalg.svdvals(a)
    rank = torch.linalg.matrix_rank(a).to(torch.int64)
    m, n = a.shape[-2], a.shape[-1]
    r = b - a @ x
    resid = (r * r).sum(0)
    resid = resid.reshape(1) if b.dim() == 1 else resid
    resid = torch.where(rank == n, resid, torch.zeros_like(resid)) \
        if m > n else resid[:0]
    return x, resid, rank, s


def _matrix_rank(M, rtol=None, tol=None):
    return torch.linalg.matrix_rank(M, rtol=rtol, atol=tol).to(torch.int64)


def _tensorinv(a, ind=2):
    out_shape = a.shape[ind:] + a.shape[:ind]
    n = 1
    for d in a.shape[:ind]:
        n *= d
    return torch.linalg.inv(a.reshape(n, -1)).reshape(out_shape)


def _tensorsolve(a, b, axes=None):
    return torch.linalg.tensorsolve(a, b, dims=axes)


norm = _wrap("norm", _norm)
svd = _wrap("svd", _svd)
inv = _wrap("inv", torch.linalg.inv)
pinv = _wrap("pinv", lambda a, rtol=None, hermitian=False:
             torch.linalg.pinv(a, rtol=rtol, hermitian=hermitian))
det = _wrap("det", torch.linalg.det)
slogdet = _wrap("slogdet", lambda a: tuple(torch.linalg.slogdet(a)))
cholesky = _wrap("cholesky", lambda a, upper=False:
                 torch.linalg.cholesky(a, upper=upper))
qr = _wrap("qr", _qr)
eig = _wrap("eig", lambda a: tuple(torch.linalg.eig(a)))
eigh = _wrap("eigh", _eigh)
eigvals = _wrap("eigvals", torch.linalg.eigvals)
eigvalsh = _wrap("eigvalsh", _eigvalsh)
solve = _wrap("solve", torch.linalg.solve, 2)
lstsq = _wrap("lstsq", _lstsq, 2)
matrix_rank = _wrap("matrix_rank", _matrix_rank)
matrix_power = _wrap("matrix_power", torch.linalg.matrix_power)
tensorinv = _wrap("tensorinv", _tensorinv)
tensorsolve = _wrap("tensorsolve", _tensorsolve, 2)


def multi_dot(arrays, *, precision=None):
    def run(*vs):
        vs, dt = _prepared(*vs)
        return _back(torch.linalg.multi_dot(vs), dt)
    return _np()._wrap_record("linalg.multi_dot", run, *arrays)
