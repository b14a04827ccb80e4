"""Runtime feature introspection: counterpart of ``mxnet_tpu/runtime.py``.

The reference's feature names, with the port's values: ``CUDA`` (a CUDA
device is present), ``CUDNN`` and ``NCCL`` with it, ``TRITON`` where the
package imports; ``RING_ATTENTION`` (``parallel.ring_attention``);
``DIST_KVSTORE`` where ``torch.distributed`` is built in (the ``dist_*``
kvstores across processes); ``TPU``, ``PALLAS``, ``XLA`` and ``JIT``
never.
"""
from __future__ import annotations

import importlib.util

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return "[%s %s]" % ("✔" if self.enabled else "✖", self.name)


def _has(mod):
    return importlib.util.find_spec(mod) is not None


def _detect():
    cuda = torch.cuda.is_available()
    return {
        "TPU": False,
        "CPU": True,
        "XLA": False,
        "JIT": False,
        "AUTOGRAD": True,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": torch.distributed.is_available(),
        "RING_ATTENTION": True,
        "PALLAS": False,
        "TRITON": _has("triton"),
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "TENSORRT": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": _has("PIL"),
        "OPENMP": True, "SSE": False, "F16C": False,
        "SIGNAL_HANDLER": True, "DEBUG": False,
    }


class Features(dict):
    """Dict of :class:`Feature` by name, with ``is_enabled``."""

    def __init__(self):
        super().__init__([(k, Feature(k, v)) for k, v in _detect().items()])

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("Feature '%s' is unknown" % feature_name)
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
