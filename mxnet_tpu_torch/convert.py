"""Carry a ``TransformerLM``'s weights across from the JAX package.

The reference names parameters the Gluon way, with instance counters:
``transformerlm0_blocks_transformerencoderlayer1_multiheadattention0_qkv_weight``,
``transformerlm0_layernorm0_gamma``, ... (``net.collect_params()``). The
counters depend on how many blocks a process built before, so the names
are mapped by their structure after the net's own ``prefix``:

==========================================================  ==========================
reference (after the prefix)                                port (``state_dict``)
==========================================================  ==========================
``embed_weight`` / ``pos_weight`` / ``head_weight``         ``embed.weight`` / ``pos_embed.weight`` / ``head.weight``
``layernorm<n>_{gamma,beta}``                               ``ln_f.{gamma,beta}``
``blocks_<layer><i>_layernorm<j>_{gamma,beta}``             ``blocks.<l>.ln1`` / ``ln2`` (by order of ``j``)
``blocks_<layer><i>_multiheadattention<n>_{qkv,proj}_weight``  ``blocks.<l>.attn.{qkv,proj}.weight``
``blocks_<layer><i>_ffn_{up,down}_{weight,bias}``           ``blocks.<l>.ffn_{up,down}.{weight,bias}``
==========================================================  ==========================

where layer ``l`` is the rank of counter ``i`` among the blocks. A missing
or unexpected name, or a wrong shape, is refused with the name in the
error.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["state_dict_from_mxnet", "load_mxnet_params",
           "mxnet_params_from_state_dict"]

_BLOCK = re.compile(r"^blocks_([a-z]+?)(\d+)_(.+)$")
_LN = re.compile(r"^layernorm(\d+)_(gamma|beta)$")
_ATTN = re.compile(r"^multiheadattention\d+_(qkv|proj)_weight$")
_FFN = re.compile(r"^(ffn_up|ffn_down)_(weight|bias)$")
_TOP = {"embed_weight": "embed.weight", "pos_weight": "pos_embed.weight",
        "head_weight": "head.weight"}


def _ranks(values):
    return {v: r for r, v in enumerate(sorted(set(values)))}


def _torch_name(rest, layer, ln_rank):
    """The port's name for one reference name (after the prefix), or None."""
    if rest in _TOP:
        return _TOP[rest]
    m = _LN.match(rest)
    if m:
        return "ln_f." + m.group(2)
    m = _BLOCK.match(rest)
    if m is None:
        return None
    inner = m.group(3)
    base = "blocks.%d." % layer[int(m.group(2))]
    lm = _LN.match(inner)
    if lm:
        which = ln_rank[int(m.group(2))][int(lm.group(1))]
        return base + ("ln1.", "ln2.")[which] + lm.group(2) \
            if which < 2 else None
    am = _ATTN.match(inner)
    if am:
        return base + "attn.%s.weight" % am.group(1)
    fm = _FFN.match(inner)
    if fm:
        return base + "%s.%s" % fm.groups()
    return None


def _infer_prefix(names):
    for n in names:
        if n.endswith("_embed_weight") and not n.endswith("_pos_embed_weight"):
            return n[:-len("embed_weight")]
    raise ValueError("cannot infer the net's prefix: no '*_embed_weight' "
                     "parameter among %d names" % len(names))


def state_dict_from_mxnet(params, prefix=None):
    """Map reference parameters ``{name: np.ndarray}`` to the port's
    ``{state_dict name: torch.Tensor}`` (CPU tensors). ``prefix`` is the
    reference net's own prefix (``net.prefix``, e.g. ``"transformerlm0_"``);
    None infers it from the embedding's name. Raises :class:`ValueError`
    naming any parameter outside the prefix or outside the structure."""
    names = list(params)
    if prefix is None:
        prefix = _infer_prefix(names)
    rests = {}
    for n in names:
        if not n.startswith(prefix):
            raise ValueError("unexpected parameter %r: outside prefix %r"
                             % (n, prefix))
        rests[n] = n[len(prefix):]
    counters = [int(m.group(2)) for m in map(_BLOCK.match, rests.values())
                if m]
    layer = _ranks(counters)
    ln_ids = {}
    for r in rests.values():
        m = _BLOCK.match(r)
        lm = _LN.match(m.group(3)) if m else None
        if lm:
            ln_ids.setdefault(int(m.group(2)), []).append(int(lm.group(1)))
    ln_rank = {i: _ranks(js) for i, js in ln_ids.items()}
    out = {}
    for n, rest in rests.items():
        t = _torch_name(rest, layer, ln_rank)
        if t is None:
            raise ValueError("unexpected parameter %r: no counterpart in the "
                             "port's TransformerLM" % n)
        if t in out:
            raise ValueError("parameter %r maps onto %r twice" % (n, t))
        out[t] = torch.from_numpy(np.array(params[n], copy=True))
    return out


def load_mxnet_params(model, params, prefix=None):
    """Load reference parameters into a port ``TransformerLM`` in place
    (onto the model's device and dtype). Refuses a missing or unexpected
    name, or a wrong shape, naming the parameter."""
    sd = state_dict_from_mxnet(params, prefix)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError("missing parameter(s) for %s" % ", ".join(missing))
    extra = sorted(set(sd) - set(own))
    if extra:
        raise ValueError("unexpected parameter(s) %s" % ", ".join(extra))
    for name, t in sd.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError("parameter %s has shape %s, the model expects %s"
                             % (name, tuple(t.shape), tuple(own[name].shape)))
    with torch.no_grad():
        for name, t in sd.items():
            own[name].copy_(t)
    return model


def mxnet_params_from_state_dict(state_dict, prefix="transformerlm0_"):
    """The inverse map: a port state dict to reference-style names (with
    counters from 0) and numpy arrays."""
    out = {}
    inv = {v: k for k, v in _TOP.items()}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if name in inv:
            out[prefix + inv[name]] = arr
            continue
        parts = name.split(".")
        if parts[0] == "ln_f":
            out[prefix + "layernorm0_" + parts[1]] = arr
            continue
        if parts[0] != "blocks":
            raise ValueError("unexpected parameter %r" % name)
        base = prefix + "blocks_transformerencoderlayer%s_" % parts[1]
        sub = parts[2:]
        if sub[0] in ("ln1", "ln2"):
            key = "layernorm%d_%s" % (int(sub[0] == "ln2"), sub[1])
        elif sub[0] == "attn":
            key = "multiheadattention0_%s_weight" % sub[1]
        elif sub[0] in ("ffn_up", "ffn_down"):
            key = "%s_%s" % (sub[0], sub[1])
        else:
            raise ValueError("unexpected parameter %r" % name)
        out[base + key] = arr
    return out
