"""Straight-through estimators, the gradient multiplier and the scatter
scalar ops: counterpart of the first part of
``mxnet_tpu/ops/ste_graph_ops.py``.

- ``round_ste`` / ``sign_ste``: round (half to even) or sign (jnp's: NaN
  and signed zeros kept) forward, identity gradient;
- ``gradientmultiplier``: identity forward, the gradient times ``scalar``
  (in the data's dtype) backward;
- ``_scatter_plus_scalar``, ``_scatter_minus_scalar``,
  ``_scatter_elemwise_div``: on dense inputs the plain ops, as the
  reference's.

- the graph names ``_contrib_edge_id``, ``_contrib_getnnz`` and the five
  ``_contrib_dgl_*``: host ops over a ``CSRNDArray``
  (``mxnet_tpu_torch.contrib.graph``), registered with ``host_op=True``
  (a ``CachedOp`` runs a callable that reaches one eagerly) and
  ``storage=True`` (they take the sparse handle as it is).
"""
from __future__ import annotations

import torch

from .core import sign as _sign
from .registry import register

__all__ = ["round_ste", "sign_ste", "gradientmultiplier"]


def _straight_through(name, forward):
    class _STE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return forward(x)

        @staticmethod
        def backward(ctx, g):
            return g

    _STE.__name__ = name
    return _STE.apply


_round_ste = _straight_through("_RoundSTE", torch.round)
_sign_ste = _straight_through("_SignSTE", _sign.fn)


@register("_contrib_round_ste", aliases=("round_ste",))
def round_ste(data):
    """``round`` forward, identity gradient."""
    return _round_ste(data)


@register("_contrib_sign_ste", aliases=("sign_ste",))
def sign_ste(data):
    """``sign`` forward, identity gradient."""
    return _sign_ste(data)


class _GradMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.save_for_backward(lam)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        lam, = ctx.saved_tensors
        return g * lam, None


@register("_contrib_gradientmultiplier", aliases=("gradientmultiplier",))
def gradientmultiplier(data, scalar=1.0):
    """Identity forward; the gradient times ``scalar`` backward."""
    return _GradMul.apply(data, torch.tensor(scalar, dtype=data.dtype,
                                             device=data.device))


@register("_scatter_plus_scalar")
def scatter_plus_scalar(data, scalar=0.0):
    return data + scalar


@register("_scatter_minus_scalar")
def scatter_minus_scalar(data, scalar=0.0):
    return data - scalar


@register("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


def _graph(name):
    def call(*args, **kwargs):
        from ..contrib import graph as g
        return getattr(g, name)(*args, **kwargs)
    call.__name__ = name
    call.__doc__ = "host op: mxnet_tpu_torch.contrib.graph.%s" % name
    return call


for _ref_name, _fn_name in [
        ("_contrib_edge_id", "edge_id"),
        ("_contrib_getnnz", "getnnz"),
        ("_contrib_dgl_adjacency", "dgl_adjacency"),
        ("_contrib_dgl_subgraph", "dgl_subgraph"),
        ("_contrib_dgl_csr_neighbor_uniform_sample",
         "dgl_csr_neighbor_uniform_sample"),
        ("_contrib_dgl_csr_neighbor_non_uniform_sample",
         "dgl_csr_neighbor_non_uniform_sample"),
        ("_contrib_dgl_graph_compact", "dgl_graph_compact")]:
    register(_ref_name, host_op=True, storage=True,
             differentiable=False)(_graph(_fn_name))
