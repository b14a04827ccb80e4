"""Recurrent layers: counterpart of ``mxnet_tpu/ops/rnn.py``.

The reference runs one direction of one layer as one ``lax.scan`` (XLA,
not Pallas): the input-to-hidden product of every step hoisted out as one
``(T*B, I) x (I, G*H)`` matmul, and only the hidden-to-hidden product in
the loop. The gate orders are LSTM ``i, f, g, o`` and GRU ``r, z, n``
with ``r`` applied to ``h W_hn + b_hn``: cuDNN's and ``torch._VF``'s
orders. Which path runs, by the data's device and dtype:

- **CUDA**: ``torch._VF.{lstm,gru,rnn_tanh,rnn_relu}`` with
  ``num_layers=1`` and no dropout, one call a (layer, direction), which
  runs cuDNN's RNN (``"cudnn"`` in :func:`path_counts`) in float32,
  float16 and bfloat16: the card's torch (2.11, cuDNN 9.2) takes bfloat16
  there too (its profile shows cuDNN's ``elemWiseRNNcell<__nv_bfloat16>``
  kernels). With cuDNN switched off (``torch.backends.cudnn.enabled``)
  the same call runs torch's native cell loop (``"native"``). The
  layer's tensors are separate parameters, not views of one buffer, so
  cuDNN copies them into its flat weight buffer on every call (torch
  warns that they are "not part of single contiguous chunk of memory").
- **CPU**: the plain version, :func:`plain_layer`: the reference's scan as
  a per-step loop of torch ops with the input product hoisted
  (``"plain"``). :func:`force_plain` sends the CUDA calls there too, to
  hold the cuDNN path against it on the card.

A cuDNN error is raised, never caught and sent to another path.

The fused ``RNN`` op (``RNN``, ``_npx_rnn``) takes the reference's flat
parameter vector (every weight, then every bias; layer-major,
direction-minor, ``i2h`` before ``h2h``). Its dropout between layers in
training does not reproduce the reference's threefry draw (ROADMAP C3): it
is the port's lowbias32 ``Dropout``, its mask drawn on the data's device
from key words folded from the op's key and the layer's index
(:func:`layer_key`), the kept values scaled by ``1/(1-p)``.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from .nn import Dropout
from .registry import bind_key, bind_train, register

__all__ = ["rnn_scan_layer", "RNN", "rnn_param_size", "plain_layer",
           "force_plain", "path_counts", "reset_path_counts", "layer_path",
           "layer_key"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# calls of each path, one a (layer, direction), counted where the call is
# made (a CUDA-graph replay counts nothing)
_COUNTS = {"cudnn": 0, "native": 0, "plain": 0}
_local = threading.local()


def path_counts():
    """``{"cudnn", "native", "plain"}``: calls of each path so far."""
    return dict(_COUNTS)


def reset_path_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


@contextlib.contextmanager
def force_plain():
    """Run every layer through :func:`plain_layer` in this thread, on the
    card too."""
    prev = getattr(_local, "plain", False)
    _local.plain = True
    try:
        yield
    finally:
        _local.plain = prev


def layer_path(data):
    """The path a layer over ``data`` takes: ``"cudnn"``, ``"native"`` or
    ``"plain"``."""
    if not data.is_cuda or getattr(_local, "plain", False):
        return "plain"
    return "cudnn" if torch.backends.cudnn.enabled else "native"


def _bias(b, w):
    return b if b is not None else torch.zeros(
        w.shape[0], dtype=w.dtype, device=w.device)


def plain_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0=None, mode="lstm"):
    """One direction of one layer over ``x`` ``(T, B, I)``, forward in
    time: the reference's scan step for step. Returns ``(ys, h_T)`` or,
    for LSTM, ``(ys, h_T, c_T)``."""
    T, B, I = x.shape
    gx = F.linear(x.reshape(T * B, I), w_ih, b_ih).reshape(T, B, -1)
    h, c = h0, c0
    ys = []
    for t in range(T):
        gh = F.linear(h, w_hh, b_hh)
        if mode == "lstm":
            i, f, g, o = (gx[t] + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            xr, xz, xn = gx[t].chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(gx[t] + gh)
        elif mode == "rnn_relu":
            h = torch.relu(gx[t] + gh)
        else:
            raise ValueError("unknown RNN mode %s" % mode)
        ys.append(h)
    ys = torch.stack(ys, dim=0)
    return (ys, h, c) if mode == "lstm" else (ys, h)


def _vf_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0, mode):
    """The same layer through ``torch._VF`` (cuDNN, or torch's native
    loop with cuDNN off)."""
    if b_ih is None and b_hh is None:
        params, has_biases = [w_ih, w_hh], False
    else:
        params, has_biases = [w_ih, w_hh, _bias(b_ih, w_ih),
                              _bias(b_hh, w_hh)], True
    states = [h0] if c0 is None else [h0, c0]
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x] + params + states)
    hx = [s.unsqueeze(0).contiguous() for s in states]
    if mode == "lstm":
        ys, hT, cT = torch._VF.lstm(x, hx, params, has_biases, 1, 0.0, train,
                                    False, False)
        return ys, hT[0], cT[0]
    ys, hT = getattr(torch._VF, mode)(x, hx[0], params, has_biases, 1, 0.0,
                                      train, False, False)
    return ys, hT[0]


def rnn_scan_layer(data, w_ih, w_hh, b_ih, b_hh, h0, c0=None,
                   mode="lstm", reverse=False):
    """One direction of one recurrent layer over a full ``(T, B, I)``
    sequence; ``reverse`` runs it backward in time (flipped in, flipped
    out). Returns ``(output (T, B, H), h_T)``, and ``c_T`` for LSTM. The
    path follows the module docstring (:func:`layer_path`)."""
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %s" % mode)
    x = torch.flip(data, (0,)) if reverse else data
    path = layer_path(data)
    _COUNTS[path] += 1
    if path == "plain":
        out = plain_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0, mode)
    else:
        out = _vf_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0, mode)
    if reverse:
        out = (torch.flip(out[0], (0,)),) + tuple(out[1:])
    return out


def rnn_param_size(num_layers, input_size, state_size, bidirectional=False,
                   mode="lstm"):
    """The flat parameter vector's length (the reference's
    ``GetRnnParamSize``)."""
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    size = G * state_size * D
    first = (input_size + state_size + 2) * size
    rest = (state_size * D + state_size + 2) * size
    return first + (num_layers - 1) * rest


def _split_rnn_params(params, num_layers, input_size, H, D, G):
    """``[layer][direction] = [w_ih, w_hh, b_ih, b_hh]``: views of the
    flat vector, every weight first, then every bias in the same order."""
    off = 0
    weights = []
    for layer in range(num_layers):
        inp = input_size if layer == 0 else H * D
        per_dir = []
        for _ in range(D):
            w_ih = params[off:off + G * H * inp].reshape(G * H, inp)
            off += G * H * inp
            w_hh = params[off:off + G * H * H].reshape(G * H, H)
            off += G * H * H
            per_dir.append([w_ih, w_hh])
        weights.append(per_dir)
    for layer in range(num_layers):
        for d in range(D):
            b_ih = params[off:off + G * H]
            off += G * H
            b_hh = params[off:off + G * H]
            off += G * H
            weights[layer][d] += [b_ih, b_hh]
    return weights


def layer_key(key, layer):
    """The dropout key words after ``layer``: the op's first word, and its
    last word plus ``(layer + 1) * 0x9E3779B9`` in uint32."""
    return (int(key[0]) & 0xFFFFFFFF,
            (int(key[-1]) + (layer + 1) * 0x9E3779B9) & 0xFFFFFFFF)


def RNN(data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, projection_size=None, key=None, train=False,
        **_ignored):
    """Fused multi-layer, (bi)directional RNN, LSTM or GRU over ``data``
    ``(T, B, I)``: ``parameters`` the flat vector, ``state`` ``(L*D, B,
    H)``, ``state_cell`` the LSTM's cells. Returns ``(output,)`` ``(T, B,
    D*H)``, plus the final h (and c) when ``state_outputs``. In training,
    dropout ``p`` between layers (module docstring)."""
    if projection_size not in (None, 0):
        raise NotImplementedError("LSTMP projection_size is not supported")
    mode = str(mode)
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    H = int(state_size)
    L = int(num_layers)
    sets = _split_rnn_params(parameters, L, data.shape[2], H, D, G)
    drop = train and p > 0.0 and key is not None and L > 1
    x = data
    h_finals, c_finals = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            w_ih, w_hh, b_ih, b_hh = sets[layer][d]
            c0 = state_cell[layer * D + d] if mode == "lstm" else None
            res = rnn_scan_layer(x, w_ih, w_hh, b_ih, b_hh,
                                 state[layer * D + d], c0, mode=mode,
                                 reverse=d == 1)
            outs.append(res[0])
            h_finals.append(res[1])
            if mode == "lstm":
                c_finals.append(res[2])
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if drop and layer < L - 1:
            x = Dropout(x, p, key=layer_key(key, layer), train=True)
    if not state_outputs:
        return (x,)
    hN = torch.stack(h_finals, dim=0)
    if mode == "lstm":
        return x, hN, torch.stack(c_finals, dim=0)
    return x, hN


register("_rnn_scan_layer", n_out=0)(rnn_scan_layer)
register("RNN", aliases=("_npx_rnn",), n_out=0,
         state_binders={"key": bind_key, "train": bind_train})(RNN)
