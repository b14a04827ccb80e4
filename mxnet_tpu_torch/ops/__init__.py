"""Operators: plain functions on tensors, and the CUDA kernels' wrappers."""
from . import flash_attention, generation_ops, nn

__all__ = ["flash_attention", "generation_ops", "nn"]
