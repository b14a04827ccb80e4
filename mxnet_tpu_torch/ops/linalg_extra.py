"""The rest of the linear-algebra operators.

Counterpart of ``mxnet_tpu/ops/linalg_extra.py`` (``la_op.cc``'s
``det``, ``slogdet``, ``inverse``, ``potri``, ``trmm``, ``gelqf``,
``syevd``, ``makediag``, ``maketrian`` and ``extracttrian``, with their
``_linalg_*`` and short aliases). Each runs on its input's device through
``torch.linalg`` (cuSOLVER and cuBLAS on the card); nothing is copied to
the host. As in the reference, ``gelqf`` is the transpose of a QR of the
transpose and ``syevd`` symmetrizes its input and returns the
eigenvectors as rows. A factor's signs may differ from the reference's
(another LAPACK, or cuSOLVER): the factors are equal up to them.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


@register("linalg_det", aliases=("_linalg_det", "det"))
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("_linalg_slogdet",), n_out=2)
def linalg_slogdet(A):
    sign, logabsdet = torch.linalg.slogdet(A)
    return sign, logabsdet


@register("linalg_inverse", aliases=("_linalg_inverse", "inverse"))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_potri", aliases=("_linalg_potri",))
def linalg_potri(A):
    """``(L L^T)^-1`` from the lower Cholesky factor ``L``: ``L^-1`` by a
    triangular solve, then ``L^-T L^-1``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("linalg_trmm", aliases=("_linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A) @ B`` (or ``B @ op(A)`` with ``rightside``), ``A``'s
    other triangle taken as zero."""
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = tri.transpose(-1, -2)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@register("linalg_gelqf", aliases=("_linalg_gelqf",), n_out=2)
def linalg_gelqf(A):
    """``A = L Q``, ``Q`` with orthonormal rows: the transposes of the
    reduced QR of ``A^T``."""
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("linalg_syevd", aliases=("_linalg_syevd",), n_out=2)
def linalg_syevd(A):
    """``A = U^T diag(L) U`` of the symmetrized ``A``: the rows of ``U``
    are the eigenvectors, ``L`` ascending."""
    w, v = torch.linalg.eigh((A + A.transpose(-1, -2)) / 2)
    return v.transpose(-1, -2), w


@register("linalg_makediag", aliases=("_linalg_makediag",))
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset))


def _tri_indices(n, k, lower, device):
    """The triangle's (rows, cols), row-major as numpy's: offset 0 the
    triangle ``lower`` names, offset > 0 on and above the k-th
    superdiagonal, offset < 0 on and below the k-th subdiagonal."""
    if k > 0 or (k == 0 and not lower):
        idx = torch.triu_indices(n, n, k, device=device)
    else:
        idx = torch.tril_indices(n, n, k, device=device)
    return idx[0], idx[1]


def _tri_count(n, k, lower):
    if k > 0 or (k == 0 and not lower):
        m = n - k
        return max(m, 0) * (max(m, 0) + 1) // 2
    m = n + k
    return max(m, 0) * (max(m, 0) + 1) // 2


@register("linalg_maketrian", aliases=("_linalg_maketrian",))
def linalg_maketrian(A, offset=0, lower=True):
    """The triangular matrix whose triangle holds the last axis of ``A``
    (the inverse of ``extracttrian``): the smallest size whose triangle
    has room for the entries."""
    k = int(offset)
    n = 1
    while _tri_count(n, k, lower) < A.shape[-1]:
        n += 1
    rows, cols = _tri_indices(n, k, lower, A.device)
    out = torch.zeros(A.shape[:-1] + (n, n), dtype=A.dtype, device=A.device)
    out[..., rows, cols] = A
    return out


@register("linalg_extracttrian", aliases=("_linalg_extracttrian",))
def linalg_extracttrian(A, offset=0, lower=True):
    rows, cols = _tri_indices(A.shape[-1], int(offset), lower, A.device)
    return A[..., rows, cols]
