"""Contrib layers: counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``.

``Concurrent`` and ``HybridConcurrent`` (every child on the same input,
outputs concatenated on ``axis``), ``Identity``, ``SparseEmbedding`` (the
dense ``Embedding`` under the reference's name and arguments: its
gradient is dense, as the reference's is), ``SyncBatchNorm`` (on one
device the batch is the whole batch, so it is ``BatchNorm`` with the
reference's extra arguments) and ``PixelShuffle1D``/``2D``/``3D``
(sub-pixel upscaling, channels into space).
"""
from __future__ import annotations

import torch

from ....ndarray.ndarray import NDArray
from ...block import HybridBlock
from ...nn.basic_layers import (BatchNorm, Embedding, HybridSequential,
                                Sequential)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


def _concat(outs, axis):
    if isinstance(outs[0], NDArray):
        from .... import ndarray as F
        return F.concat(*outs, dim=axis)
    return torch.cat(outs, dim=axis)


class Concurrent(Sequential):
    """Run the children on the same input and concatenate their outputs
    on ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable ``Concurrent``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    forward = Concurrent.forward


class Identity(HybridBlock):
    """The identity, for a skip branch of a ``Concurrent``."""

    def forward(self, x):
        return x


class SparseEmbedding(Embedding):
    """``Embedding`` under the reference's contrib name (a dense
    gradient)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer, **kwargs)

    def extra_repr(self):
        return "%d -> %d" % (self._input_dim, self._output_dim)


class SyncBatchNorm(BatchNorm):
    """``BatchNorm`` over axis 1 with the reference's ``num_devices``
    (kept, unused: one device holds the whole batch)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=
                         running_variance_initializer,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor,) * ndim
        self._factors = tuple(int(f) for f in factor)

    def extra_repr(self):
        return "factors=%s" % (self._factors,)

    def forward(self, x):
        """``(N, C * prod(f), *S)`` -> ``(N, C, *(s_i * f_i))``."""
        n, fs = len(self._factors), self._factors
        spatial = tuple(x.shape[2:])
        x = x.reshape((x.shape[0], -1) + fs + spatial)
        # (N, C, f_1..f_n, s_1..s_n) -> (N, C, s_1, f_1, ..., s_n, f_n)
        perm = [0, 1] + [p for i in range(n) for p in (2 + n + i, 2 + i)]
        x = x.permute(perm)
        return x.reshape(x.shape[:2] + tuple(s * f for s, f in
                                             zip(spatial, fs)))


class PixelShuffle1D(_PixelShuffle):
    """``(N, C*f, W)`` -> ``(N, C, W*f)``."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """``(N, C*f1*f2, H, W)`` -> ``(N, C, H*f1, W*f2)``."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """``(N, C*f1*f2*f3, D, H, W)`` -> ``(N, C, D*f1, H*f2, W*f3)``."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)
