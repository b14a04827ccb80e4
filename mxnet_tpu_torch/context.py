"""Devices.

Counterpart of ``mxnet_tpu/context.py``. The port's entry points run on
the card: :func:`default_device` gives CUDA when no device is named and
raises when there is none. The CPU is used only when a caller asks for it
(``device="cpu"``), as the tests do; nothing falls back to it quietly.
"""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device(device=None):
    """``torch.device`` for ``device``; CUDA when ``device`` is None. A
    CUDA device without an index resolves to the current one, so that
    devices compare equal.

    Raises :class:`RuntimeError` when no device is named and CUDA is
    absent."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: mxnet_tpu_torch runs on the GPU; pass "
            "device='cpu' to run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
