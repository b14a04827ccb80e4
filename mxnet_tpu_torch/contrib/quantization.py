"""Post-training INT8 quantization: counterpart of
``mxnet_tpu/contrib/quantization.py``.

- :func:`quantize_net` (Gluon): every ``Dense`` and ungrouped ``Conv2D``
  is swapped for an int8 block that runs ``quantize_v2 -> int8 GEMM or
  convolution summed in int32 -> dequantize`` (``ops/quantized_ops.py``);
  inside a ``Sequential``/``HybridSequential`` a ``Conv2D`` (no fused
  activation) followed by a ``BatchNorm`` is folded into one int8 conv
  (the ``BatchNorm`` becomes an identity). With ``calib_data`` and
  ``calib_mode="naive"`` the activation ranges are the min and max seen
  over the calibration forwards, then frozen; otherwise each batch
  quantizes over its own range.
- :func:`quantize_model` (Symbol): the weights quantized to int8 and
  stored dequantized.
- :func:`quantize_params`, :class:`CalibrationCollector` (``naive`` and
  the KL ``entropy`` threshold).

An int8 block's int8 weight (``qweight``), weight range (``wrange``),
bias (``qbias``) and calibrated range (``calib``, NaN until calibrated)
are registered ``Constant`` parameters, so ``save_parameters``/
``load_parameters`` carry a quantized net, in the reference's ``.params``
names, between the packages. The calibrated range stays on the device
and every call reads it there (NaN picks the batch's own range, by
``torch.where``), so a value loaded or set in place later is seen at the
next call, a CUDA-graph replay's included. Weights are
quantized on the host in numpy, as the reference does, so both packages
hold the same int8 values.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..context import Context
from ..ndarray.ndarray import NDArray

__all__ = ["quantize_model", "quantize_net", "quantize_params",
           "CalibrationCollector"]


def _minmax_scale(arr):
    m = float(np.abs(arr).max()) if arr.size else 1.0
    return m / 127.0 if m > 0 else 1.0


def _entropy_scale(arr, num_bins=2048, num_quantized_bins=255):
    """The KL-divergence threshold search over ``|arr|``'s histogram."""
    arr = np.abs(np.asarray(arr).ravel())
    mx_val = arr.max() if arr.size else 1.0
    if mx_val == 0:
        return 1.0
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, mx_val))
    best_kl = np.inf
    best_t = mx_val
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, num_bins // 64)):
        t = edges[i] if i < len(edges) else mx_val
        p = hist[:i].astype(np.float64).copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        factor = i / num_quantized_bins
        q = np.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        p_n = p / p.sum()
        q_n = q / q.sum() if q.sum() else q
        mask = p_n > 0
        kl = float(np.sum(p_n[mask] * np.log(
            p_n[mask] / np.maximum(q_n[mask], 1e-12))))
        if kl < best_kl:
            best_kl = kl
            best_t = t
    return best_t / 127.0


def _host(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def quantize_params(params, per_channel=True):
    """Float parameters as ``(int8 values, scales)`` dicts: per output
    channel for arrays of two or more dimensions."""
    qparams = {}
    scales = {}
    for name, p in params.items():
        arr = _host(p)
        if arr.ndim >= 2 and per_channel:
            ax = tuple(range(1, arr.ndim))
            s = np.maximum(np.abs(arr).max(axis=ax), 1e-12) / 127.0
            q = np.clip(np.round(arr / s.reshape((-1,) + (1,) *
                                                 (arr.ndim - 1))),
                        -127, 127).astype(np.int8)
        else:
            s = np.float32(_minmax_scale(arr))
            q = np.clip(np.round(arr / s), -127, 127).astype(np.int8)
        qparams[name] = q
        scales[name] = s
    return qparams, scales


class CalibrationCollector:
    """Each layer's outputs over the calibration forwards, and the scale
    they give (``naive``: min/max; ``entropy``: the KL threshold)."""

    def __init__(self, mode="naive"):
        assert mode in ("naive", "entropy")
        self.mode = mode
        self._samples = {}

    def collect(self, name, arr):
        self._samples.setdefault(name, []).append(_host(arr).ravel())

    def scales(self):
        out = {}
        for name, chunks in self._samples.items():
            arr = np.concatenate(chunks)
            out[name] = (_minmax_scale(arr) if self.mode == "naive"
                         else _entropy_scale(arr))
        return out


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=None, calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=logging, **kwargs):
    """Symbol-path quantization: ``(sym, qarg_params, aux_params)`` with
    every ``*weight`` not excluded quantized to int8 per output channel
    and stored dequantized (in float32, on ``ctx`` or its own device)."""
    from ..ndarray import ndarray as _nd
    excluded = set(excluded_sym_names or [])
    qargs = {}
    for name, p in arg_params.items():
        if name in excluded or not name.endswith("weight"):
            qargs[name] = p
            continue
        q, s = quantize_params({name: p})
        qv = q[name].astype(np.float32)
        sv = s[name]
        deq = qv * (sv.reshape((-1,) + (1,) * (qv.ndim - 1))
                    if np.ndim(sv) else sv)
        qargs[name] = _nd.array(deq.astype("float32"), ctx=ctx or (
            p.ctx if isinstance(p, NDArray) else None))
    logger.info("quantized %d weight tensors to int8", len(qargs))
    return sym, qargs, aux_params


def _int8_blocks():
    """The int8 blocks (built on first use: ``gluon`` imports late)."""
    from ..gluon.block import HybridBlock
    from ..gluon.parameter import Constant
    from ..ops import quantized_ops as _q

    def _const_param(name, arr, dtype, device):
        p = Constant(name, np.asarray(arr, dtype=dtype))
        p.initialize(ctx=Context.from_device(device))
        return p

    class _Int8Layer(HybridBlock):
        """int8 weight, weight range, bias and calibrated activation range
        as registered ``Constant`` parameters; ``calib`` is (min, max),
        NaN until calibrated (then each batch uses its own range)."""

        def __init__(self, weight, bias, act, device):
            super().__init__()
            w = weight.astype(np.float32)
            amax = max(float(np.abs(w).max()), 1e-12)
            q = np.clip(np.round(w / (amax / 127.0)), -127,
                        127).astype(np.int8)
            self.qweight = _const_param("qweight", q, "int8", device)
            self.wrange = _const_param(
                "wrange", np.array([-amax, amax], np.float32), "float32",
                device)
            self.qbias = None if bias is None else _const_param(
                "qbias", bias.astype(np.float32), "float32", device)
            self.calib = _const_param(
                "calib", np.array([np.nan, np.nan], np.float32), "float32",
                device)
            self._act = act
            self._calibrating = False
            self._range = None      # the range seen while calibrating

        @property
        def _wq(self):
            return self.qweight.tensor()

        @property
        def _b(self):
            return None if self.qbias is None else self.qbias.tensor()

        def _wrange(self):
            w = self.wrange.tensor()
            return w[0:1], w[1:2]

        def _freeze_calibration(self):
            if self._range is not None:
                self.calib.set_data(np.asarray(self._range, np.float32))

        def _quantize_in(self, x):
            if self._calibrating:
                lo, hi = (float(v) for v in torch.aminmax(x.detach()))
                if self._range is None:
                    self._range = [lo, hi]
                else:
                    self._range = [min(self._range[0], lo),
                                   max(self._range[1], hi)]
                return _q.quantize_v2.fn(x)
            c = self.calib.tensor()
            own = torch.stack(torch.aminmax(x.detach())).to(torch.float32)
            rng = torch.where(torch.isnan(c[0]), own, c)
            return _q.quantize_v2.fn(x, min_calib_range=rng[0],
                                     max_calib_range=rng[1])

        def _finish(self, y):
            return y if self._act is None else self._act(y)

    class _Int8Dense(_Int8Layer):
        def __init__(self, dense):
            w = dense.weight.tensor()
            super().__init__(_host(w), None if dense.bias is None
                             else _host(dense.bias.tensor()), dense.act,
                             w.device)
            self._units = dense._units
            self._flatten = dense._flatten

        def forward(self, x):
            qx, xmn, xmx = self._quantize_in(x)
            wmn, wmx = self._wrange()
            acc, omn, omx = _q.quantized_fully_connected.fn(
                qx, self._wq, None, xmn, xmx, wmn, wmx, no_bias=True,
                num_hidden=self._units, flatten=self._flatten)
            y = _q.dequantize.fn(acc, omn, omx)
            if self._b is not None:
                y = y + self._b
            return self._finish(y)

    class _Int8Conv(_Int8Layer):
        def __init__(self, conv, weight_override=None, bias_override=None):
            w = conv.weight.tensor()
            wn = weight_override if weight_override is not None \
                else _host(w)
            if bias_override is not None:
                b = bias_override
            else:
                b = None if conv.bias is None else _host(conv.bias.tensor())
            super().__init__(wn, b, getattr(conv, "act", None), w.device)
            self._kwargs = dict(conv._kwargs)

        def forward(self, x):
            qx, xmn, xmx = self._quantize_in(x)
            wmn, wmx = self._wrange()
            k = self._kwargs
            acc, omn, omx = _q.quantized_conv.fn(
                qx, self._wq, None, xmn, xmx, wmn, wmx, kernel=k["kernel"],
                stride=k["stride"], pad=k["pad"], dilate=k["dilate"],
                num_filter=k["num_filter"], no_bias=True)
            y = _q.dequantize.fn(acc, omn, omx)
            if self._b is not None:
                y = y + self._b.reshape((1, -1) + (1,) * (y.dim() - 2))
            return self._finish(y)

    class _FoldedIdentity(HybridBlock):
        """A ``BatchNorm`` folded into the conv before it."""

        def forward(self, x):
            return x

    return _Int8Dense, _Int8Conv, _FoldedIdentity


def _fold_bn(conv, bn):
    """The conv's ``(weight, bias)`` with the BatchNorm's inference
    transform folded in: ``w * g / sqrt(v + eps)`` per output channel,
    ``beta + (b - mean) * g / sqrt(v + eps)``."""
    w = _host(conv.weight.tensor()).astype(np.float32)
    b = (np.zeros(w.shape[0], np.float32) if conv.bias is None
         else _host(conv.bias.tensor()).astype(np.float32))
    gamma = _host(bn.gamma.tensor()).astype(np.float32)
    beta = _host(bn.beta.tensor()).astype(np.float32)
    mean = _host(bn.running_mean.tensor()).astype(np.float32)
    var = _host(bn.running_var.tensor()).astype(np.float32)
    eps = bn._kwargs.get("eps", 1e-5)
    scale = gamma / np.sqrt(var + eps)
    w2 = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
    b2 = beta + (b - mean) * scale
    return w2, b2


def quantize_net(network, quantized_dtype="int8", quantize_mode="full",
                 exclude_layers=None, exclude_layers_match=None,
                 calib_data=None, data_shapes=None, calib_mode="none",
                 num_calib_examples=None, ctx=None, logger=logging):
    """Swap ``network``'s ``Dense``/``Conv2D`` blocks for int8 ones in
    place (see the module docstring) and return it. Layers not yet
    initialized, grouped convolutions and excluded names stay float."""
    from ..gluon import nn as gnn
    from ..gluon.block import Block
    _Int8Dense, _Int8Conv, _FoldedIdentity = _int8_blocks()
    exclude = set(exclude_layers or [])
    match = tuple(exclude_layers_match or ())
    swapped = []

    def _excluded(name):
        return name in exclude or any(m in name for m in match)

    def _ready(p):
        return p._tensors is not None

    def visit(block):
        items = [(k, c) for k, c in block._modules.items()
                 if isinstance(c, Block)]
        folds = {}
        folded_keys = set()
        if isinstance(block, (gnn.HybridSequential, gnn.Sequential)):
            for (k1, c1), (k2, c2) in zip(items, items[1:]):
                if (isinstance(c1, gnn.Conv2D)
                        and isinstance(c2, gnn.BatchNorm)
                        and getattr(c1, "act", None) is None
                        and _ready(c1.weight) and _ready(c2.gamma)
                        and c1._kwargs.get("num_group", 1) == 1
                        and not _excluded(c1.name)
                        and not _excluded(c2.name)):
                    folds[k1] = (c1, c2, k2)
                    folded_keys.add(k2)
        for key, child in items:
            qb = None
            if key in folds:
                c1, c2, k2 = folds[key]
                w2, b2 = _fold_bn(c1, c2)
                qb = _Int8Conv(c1, weight_override=w2, bias_override=b2)
                block._modules[k2] = _FoldedIdentity()
            elif _excluded(child.name):
                pass
            elif isinstance(child, gnn.Dense) and _ready(child.weight):
                qb = _Int8Dense(child)
            elif isinstance(child, gnn.Conv2D) and \
                    _ready(child.weight) and \
                    child._kwargs.get("num_group", 1) == 1:
                qb = _Int8Conv(child)
            if qb is not None:
                block._modules[key] = qb
                swapped.append(qb)
            elif key not in folded_keys:
                visit(child)

    visit(network)
    if isinstance(network, Block):
        network._clear_all_cached_ops()
    seen = 0
    if calib_data is not None and calib_mode != "none":
        for qb in swapped:
            qb._calibrating = True
        with torch.no_grad():
            for batch in calib_data:
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                if not isinstance(x, NDArray):
                    x = NDArray(np.asarray(x))
                # eagerly: a calibration forward reads ranges to the host
                network._nd_forward(x)
                seen += x.shape[0]
                if num_calib_examples and seen >= num_calib_examples:
                    break
        for qb in swapped:
            qb._calibrating = False
            qb._freeze_calibration()
        logger.info("calibrated %d layers on %d examples", len(swapped),
                    seen)
    logger.info("quantize_net: %d layers swapped to int8", len(swapped))
    return network
