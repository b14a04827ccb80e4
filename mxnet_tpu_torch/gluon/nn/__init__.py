"""Counterpart of ``mxnet_tpu.gluon.nn``: the layers the slice uses."""
from .basic_layers import Dense, Embedding, LayerNorm

__all__ = ["Dense", "Embedding", "LayerNorm"]
