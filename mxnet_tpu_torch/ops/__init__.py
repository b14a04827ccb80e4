"""Operators: plain functions on tensors, and the CUDA kernels' wrappers."""
from . import ctc, flash_attention, generation_ops, nn

__all__ = ["ctc", "flash_attention", "generation_ops", "nn"]
