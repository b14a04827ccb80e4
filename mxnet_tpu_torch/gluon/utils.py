"""Gluon utilities: counterpart of ``mxnet_tpu/gluon/utils.py``
(``split_data``, ``split_and_load``, ``clip_global_norm``,
``check_sha1``) on torch tensors.

``download`` is not ported: it needs a network (ROADMAP Queue A item 13).
"""
from __future__ import annotations

import hashlib
import warnings

import numpy as np
import torch

from ..context import default_device

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` into ``num_slice`` slices (the
    last takes the remainder when ``even_split`` is False)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's a multiple of the number of "
            "devices, or set even_split=False." % (
                str(tuple(data.shape)), num_slice, batch_axis))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [data.narrow(batch_axis, i * step,
                        (step if i < num_slice - 1 else size - i * step))
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and put one slice on each device of ``ctx_list``
    (``torch.device``s or names; ``[None]`` is the default device)."""
    devices = [default_device(c) for c in ctx_list]
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    if len(devices) == 1:
        return [data.to(devices[0])]
    slices = split_data(data, len(devices), batch_axis, even_split)
    return [s.to(d) for s, d in zip(slices, devices)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (tensors, or NDArrays such as ``Parameter.grad()``
    whose tensors are scaled) in place so that their global 2-norm is at
    most ``max_norm``; returns the norm before scaling (a Python float).

    As the reference: each array's sum of squares in its dtype, summed on
    the host as Python floats, a host ``sqrt``, a warning when the norm is
    not finite, and ``arr *= max_norm / (norm + 1e-8)`` when that is below
    1. The per-array sums come to the host in one transfer."""
    if not arrays:
        raise ValueError("clip_global_norm: no arrays")
    arrays = [getattr(a, "_data", a) for a in arrays]
    sums = torch.stack([(a.reshape(-1) * a.reshape(-1)).sum().double()
                        for a in arrays]).tolist()
    total_norm = sum(sums)
    total_norm = np.sqrt(total_norm)
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr.mul_(float(scale))
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
