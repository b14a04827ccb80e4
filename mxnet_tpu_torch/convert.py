"""Carry a model's weights across from the JAX package.

The reference names parameters the Gluon way, with instance counters
(``net.collect_params()``): ``transformerlm0_blocks_transformerencoderlayer1_
multiheadattention0_qkv_weight``, ``bertmodel0_encoder_layer0_
_maskedattention0_qkv_weight``, ... The counters depend on how many blocks
a process built before, so the names are mapped by their structure after
the net's own ``prefix``. ``TransformerLM``:

==========================================================  ==========================
reference (after the prefix)                                port (``state_dict``)
==========================================================  ==========================
``embed_weight`` / ``pos_weight`` / ``head_weight``         ``embed.weight`` / ``pos_embed.weight`` / ``head.weight``
``layernorm<n>_{gamma,beta}``                               ``ln_f.{gamma,beta}``
``blocks_<layer><i>_layernorm<j>_{gamma,beta}``             ``blocks.<l>.ln1`` / ``ln2`` (by order of ``j``)
``blocks_<layer><i>_multiheadattention<n>_{qkv,proj}_weight``  ``blocks.<l>.attn.{qkv,proj}.weight``
``blocks_<layer><i>_ffn_{up,down}_{weight,bias}``           ``blocks.<l>.ffn_{up,down}.{weight,bias}``
==========================================================  ==========================

``BERTModel``:

==========================================================  ==========================
reference (after the prefix)                                port (``state_dict``)
==========================================================  ==========================
``encoder_{word,segment,pos}_embed_weight``                 ``encoder.{word,segment,pos}_embed.weight``
``encoder_layernorm<n>_{gamma,beta}``                       ``encoder.ln.{gamma,beta}``
``encoder_layer<i>_layernorm<j>_{gamma,beta}``              ``encoder.layers.<l>.ln1`` / ``ln2`` (by order of ``j``)
``encoder_layer<i>__maskedattention<n>_{qkv,proj}_weight``  ``encoder.layers.<l>.attn.{qkv,proj}.weight``
``encoder_layer<i>_ffn_{up,down}_{weight,bias}``            ``encoder.layers.<l>.ffn_{up,down}.{weight,bias}``
``{pooler,mlm_transform,mlm_decoder,nsp}_{weight,bias}``    ``{pooler,...}.{weight,bias}``
``layernorm<n>_{gamma,beta}``                               ``mlm_ln.{gamma,beta}``
==========================================================  ==========================

where layer ``l`` is the rank of counter ``i`` among the layers. A
``PretrainStep`` holds its ``BERTModel`` as ``bert``; its reference names
carry an outer prefix (``pretrainstep0_bertmodel0_``), which ``prefix``
takes.

:func:`load_mxnet_params` also reads a ``.params`` file
(:mod:`mxnet_tpu_torch.ndarray.serialization`), with its names in any of
three formats: ``export``'s ``arg:``/``aux:`` full names, plain full names,
or ``save_parameters``' structural names (``encoder.word_embed.weight``,
``blocks.0.attn.qkv.weight``, ...). Structural names equal the port's,
except that BERT's encoder keys its layers by child index
(``encoder.5.attn.qkv.weight``: five children register before the first
layer), mapped by the rank of that index. A missing, unexpected or
duplicate name, or a wrong shape, is refused with the name in the error.

Every other ``gluon.Block`` (the model zoo, a user's block) names its
parameters as the reference does, through the same name scopes: its full
names (``resnetv10_stage1_conv0_weight``) equal the reference's up to the
net's own prefix (``resnetv1<k>_``, whose counter depends on the process),
and its ``save_parameters`` names (``features.5.0.body.0.weight``) equal
the reference's. :func:`load_mxnet_params` maps the file's prefix onto
the net's, and :func:`mxnet_params_from_state_dict` writes the names back,
with ``export``'s ``arg:``/``aux:`` marks when asked (``aux:`` for
BatchNorm's moving statistics, as the reference's ``export`` marks its
auxiliary states). The RNN family is such a block: ``RNNModel``
(``rnnmodel<n>_embedding<n>_weight``, ``rnnmodel<n>_lstm<n>_l<i>_{i2h,
h2h}_{weight,bias}``, ``rnnmodel<n>_dense<n>_{weight,bias}``; a tied
decoder's bias is ``embedding<n>_bias`` and its weight the embedding's), a
bare ``RNN``/``LSTM``/``GRU`` (``lstm<n>_l<i>_...``) and the cells
(``lstm<n>_i2h_weight``); :func:`state_dict_from_mxnet` maps those names
by structure onto ``encoder.weight``, ``rnn.l0_i2h_weight``,
``decoder.bias``, ... (a bare layer's or a cell's leaves as they are).
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from .models.bert import BERTModel, PretrainStep
from .models.transformer import TransformerLM
from .ndarray.serialization import load_ndarrays

__all__ = ["state_dict_from_mxnet", "load_mxnet_params",
           "mxnet_params_from_state_dict", "reference_names",
           "reference_structural_names"]

# the reference's BERTEncoder registers five children (three embeddings,
# the LayerNorm, the Dropout) before its layers, which it keys by index
_BERT_LAYER0 = 5

_NORM = re.compile(
    r"^(?P<scope>(?:encoder_)?)layernorm\d+_(?P<leaf>gamma|beta)$")
_LN = re.compile(r"^layernorm(\d+)_(gamma|beta)$")
_ATTN = re.compile(r"^_?[a-z]*attention\d+_(qkv|proj)_weight$")
_FFN = re.compile(r"^(ffn_up|ffn_down)_(weight|bias)$")


class _Arch:
    """One model family's name map: its top-level names, its layer names
    (``layer`` matches a layer's reference name, ``path`` is the port's)
    and the reference-name pieces used when writing names back."""

    def __init__(self, name, top, norms, layer, path, layer_prefix, attn,
                 prefix):
        self.name = name
        self.top = top
        self.norms = norms
        self.layer = re.compile(layer)
        self.path = path
        self.layer_prefix = layer_prefix
        self.attn = attn
        self.prefix = prefix


_LM = _Arch(
    "TransformerLM",
    top={"embed_weight": "embed.weight", "pos_weight": "pos_embed.weight",
         "head_weight": "head.weight"},
    norms={"": "ln_f"},
    layer=r"^blocks_[a-z]+?(?P<i>\d+)_(?P<inner>.+)$", path="blocks",
    layer_prefix="blocks_transformerencoderlayer%d_",
    attn="multiheadattention0_", prefix="transformerlm0_")
_BERT = _Arch(
    "BERTModel",
    top=dict([("encoder_%s_embed_weight" % e, "encoder.%s_embed.weight" % e)
              for e in ("word", "segment", "pos")]
             + [("%s_%s" % (h, leaf), "%s.%s" % (h, leaf))
                for h in ("pooler", "mlm_transform", "mlm_decoder", "nsp")
                for leaf in ("weight", "bias")]),
    norms={"encoder_": "encoder.ln", "": "mlm_ln"},
    layer=r"^encoder_layer(?P<i>\d+)_(?P<inner>.+)$", path="encoder.layers",
    layer_prefix="encoder_layer%d_", attn="_maskedattention0_",
    prefix="bertmodel0_")


def _ranks(values):
    return {v: r for r, v in enumerate(sorted(set(values)))}


def _arch_of(model):
    """``(arch, outer)``: the name map of ``model``'s family and the port
    name prefix of the mapped model within it (``"bert."`` in a
    ``PretrainStep``)."""
    if isinstance(model, PretrainStep):
        return _arch_of(model.bert)[0], "bert."
    if isinstance(model, BERTModel):
        return _BERT, ""
    if isinstance(model, TransformerLM):
        return _LM, ""
    raise TypeError("no reference name map for %s" % type(model).__name__)


def _infer_prefix(names, arch):
    end = "encoder_word_embed_weight" if arch is _BERT else "embed_weight"
    for n in names:
        if n.endswith(end) and not n.endswith("_pos_embed_weight"):
            return n[:-len(end)]
    raise ValueError("cannot infer the net's prefix: no '*%s' parameter "
                     "among %d names" % (end, len(names)))


def _full_names(rests, arch):
    """``{reference name: port name or None}`` for names after the
    prefix."""
    counters, ln_ids = [], {}
    for r in rests.values():
        m = arch.layer.match(r)
        if m:
            i = int(m.group("i"))
            counters.append(i)
            lm = _LN.match(m.group("inner"))
            if lm:
                ln_ids.setdefault(i, []).append(int(lm.group(1)))
    layer = _ranks(counters)
    ln_rank = {i: _ranks(js) for i, js in ln_ids.items()}
    return {n: _full_name(rest, arch, layer, ln_rank)
            for n, rest in rests.items()}


def _full_name(rest, arch, layer, ln_rank):
    if rest in arch.top:
        return arch.top[rest]
    m = arch.layer.match(rest)
    if m is None:
        m = _NORM.match(rest)
        if m and m.group("scope") in arch.norms:
            return "%s.%s" % (arch.norms[m.group("scope")], m.group("leaf"))
        return None
    i, inner = int(m.group("i")), m.group("inner")
    base = "%s.%d." % (arch.path, layer[i])
    lm = _LN.match(inner)
    if lm:
        which = ln_rank[i][int(lm.group(1))]
        return base + ("ln1.", "ln2.")[which] + lm.group(2) \
            if which < 2 else None
    am = _ATTN.match(inner)
    if am:
        return base + "attn.%s.weight" % am.group(1)
    fm = _FFN.match(inner)
    if fm:
        return base + "%s.%s" % fm.groups()
    return None


def _structural_names(names, arch):
    """``{save_parameters name: port name}``: BERT's layers keyed by child
    index become ``encoder.layers.<rank>``; a ``PretrainStep``'s outer
    ``bert.`` is dropped."""
    bare = {n: n[len("bert."):] if n.startswith("bert.") else n
            for n in names}
    if arch is not _BERT:
        return bare
    layer_key = re.compile(r"^encoder\.(\d+)\.(.+)$")
    idx = _ranks(int(m.group(1)) for m in map(layer_key.match, bare.values())
                 if m)
    out = {}
    for n, b in bare.items():
        m = layer_key.match(b)
        out[n] = "encoder.layers.%d.%s" % (idx[int(m.group(1))], m.group(2)) \
            if m else b
    return out


def _read(params):
    """``params`` as ``{name: np.ndarray}``: a dict, or a ``.params``
    file's named arrays, with ``export``'s ``arg:``/``aux:`` dropped."""
    if isinstance(params, (str, os.PathLike)):
        arrays, names = load_ndarrays(params)
        if not names:
            raise ValueError("%s holds %d unnamed arrays, not parameters"
                             % (params, len(arrays)))
        params = dict(zip(names, arrays))
    out = {}
    for n, a in params.items():
        key = n[4:] if n[:4] in ("arg:", "aux:") else n
        if key in out:
            raise ValueError("parameter %r appears twice" % key)
        out[key] = a
    return out


# the RNN family's names after the net's prefix: RNNModel's children, a
# bare layer's {l,r}<i>_ leaves, a cell's i2h/h2h (h2r: LSTMPCell) leaves
_RNN_FAMILY = re.compile(r"(?:^|_)(?:[lr]\d+_)?(?:i2h|h2h|h2r)_(?:weight|bias)$")
_RNN_PREFIX = re.compile(r"^[a-z]+(?:_(?:relu|tanh))?\d+_")
_RNN_LEAF = re.compile(r"^(?:[lr]\d+_)?(?:i2h|h2h|h2r)_(?:weight|bias)$")
_RNN_CHILD = [(re.compile(r"^embedding\d+_weight$"), "encoder.weight"),
              (re.compile(r"^embedding\d+_bias$"), "decoder.bias"),
              (re.compile(r"^dense\d+_(weight|bias)$"), r"decoder.\1"),
              (re.compile(r"^(?:lstm|gru|rnn_relu|rnn_tanh)\d+_(.+)$"),
               r"rnn.\1")]


def _rnn_state_dict_names(names, prefix):
    """``{reference name: state_dict name}`` of an ``RNNModel`` (its
    children by structure: ``encoder``, ``rnn``, ``decoder``), a bare
    ``RNN``/``LSTM``/``GRU`` or a cell, from full names after ``prefix``
    (None: the first name's ``<alias><n>_``) or structural names."""
    if all("." in n for n in names):
        return {n: n for n in names}
    if prefix is None:
        m = _RNN_PREFIX.match(names[0])
        if m is None:
            raise ValueError("cannot infer the net's prefix from %r"
                             % names[0])
        prefix = m.group(0)
    out = {}
    for n in names:
        if not n.startswith(prefix):
            raise ValueError("unexpected parameter %r: outside prefix %r"
                             % (n, prefix))
        rest = n[len(prefix):]
        if _RNN_LEAF.match(rest):
            out[n] = rest
            continue
        for pat, repl in _RNN_CHILD:
            if pat.match(rest):
                out[n] = pat.sub(repl, rest)
                break
        else:
            out[n] = None
    return out


def state_dict_from_mxnet(params, prefix=None):
    """Map reference parameters (``{name: np.ndarray}`` or a ``.params``
    file) to a port ``{state_dict name: torch.Tensor}`` (CPU tensors) of a
    ``TransformerLM``, a ``BERTModel``, or the RNN family (``RNNModel``, a
    bare ``RNN``/``LSTM``/``GRU``, a cell), whichever the names describe.
    Full names follow ``prefix``, the reference net's own (``net.prefix``,
    e.g. ``"transformerlm0_"``; None infers it from the word embedding's
    name, or an RNN net's first name); structural names (with a ``.``)
    need none. A tied ``RNNModel`` (an ``embedding<n>_bias``, no
    ``dense<n>_weight``) gives its embedding as ``decoder.weight`` too, as
    the port's state dict holds it. Raises :class:`ValueError` naming any
    parameter outside the prefix or the structure, or mapped twice."""
    params = _read(params)
    names = list(params)
    if any(_RNN_FAMILY.search(n) for n in names):
        mapped = _rnn_state_dict_names(names, prefix)
        out = {}
        for n, t in mapped.items():
            if t is None:
                raise ValueError("unexpected parameter %r: no counterpart "
                                 "in the port's RNN family" % n)
            if t in out:
                raise ValueError("parameter %r maps onto %r twice" % (n, t))
            out[t] = torch.from_numpy(np.array(params[n], copy=True))
        if "decoder.bias" in out and "encoder.weight" in out and \
                "decoder.weight" not in out:
            out["decoder.weight"] = out["encoder.weight"]
        return out
    arch = _BERT if any("word_embed" in n for n in names) else _LM
    if names and all("." in n for n in names):
        mapped = _structural_names(names, arch)
    else:
        if prefix is None:
            prefix = _infer_prefix(names, arch)
        rests = {}
        for n in names:
            if not n.startswith(prefix):
                raise ValueError("unexpected parameter %r: outside prefix %r"
                                 % (n, prefix))
            rests[n] = n[len(prefix):]
        mapped = _full_names(rests, arch)
    out = {}
    for n, t in mapped.items():
        if t is None:
            raise ValueError("unexpected parameter %r: no counterpart in the "
                             "port's %s" % (n, arch.name))
        if t in out:
            raise ValueError("parameter %r maps onto %r twice" % (n, t))
        out[t] = torch.from_numpy(np.array(params[n], copy=True))
    return out


def _scoped(model):
    """Whether ``model`` is a block named by its scopes (no name map)."""
    from .gluon.block import Block
    return isinstance(model, Block) and not isinstance(
        model, (TransformerLM, BERTModel, PretrainStep))


def _file_prefix(names, model):
    """The reference net's prefix in ``names``: the net's own alias with
    the reference's counter."""
    alias = re.sub(r"\d+_$", "", model.prefix)
    for n in names:
        m = re.match(r"^%s\d+_" % re.escape(alias), n)
        if m:
            return m.group(0)
    raise ValueError("cannot infer the net's prefix: no name starts with "
                     "%r and a counter" % alias)


def _load_scoped(model, params, prefix, ctx):
    from .gluon.parameter import load_param_from_array
    params = _read(params)
    names = list(params)
    if names and all("." in n for n in names):
        own = model._collect_params_with_prefix()
        mapped = {n: n for n in names}
    else:
        own = model.collect_params()
        pre = _file_prefix(names, model) if prefix is None else prefix
        mapped = {}
        for n in names:
            if not n.startswith(pre):
                raise ValueError("unexpected parameter %r: outside prefix %r"
                                 % (n, pre))
            mapped[n] = model.prefix + n[len(pre):]
    missing = sorted(set(own) - set(mapped.values()))
    if missing:
        raise ValueError("missing parameter(s) for %s" % ", ".join(missing))
    extra = sorted(n for n, t in mapped.items() if t not in own)
    if extra:
        raise ValueError("unexpected parameter(s) %s" % ", ".join(extra))
    for n, t in mapped.items():
        shape, want = tuple(np.shape(params[n])), own[t].shape
        if want is not None and (len(want) != len(shape) or any(
                w not in (0, s) for w, s in zip(want, shape))):
            raise ValueError("parameter %s has shape %s, the model expects %s"
                             % (n, shape, want))
    for n, t in mapped.items():
        load_param_from_array(own[t], np.asarray(params[n]), ctx)
    model._clear_all_cached_ops()
    return model


def _scoped_params(model, prefix, export):
    from .gluon.nn import BatchNorm
    aux = {id(p) for m in model.modules() if isinstance(m, BatchNorm)
           for p in (m.running_mean, m.running_var)}
    out = {}
    for name, p in model.collect_params().items():
        if prefix is not None:
            name = prefix + name[len(model.prefix):]
        if export:
            name = ("aux:" if id(p) in aux else "arg:") + name
        t = p._reduce()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def load_mxnet_params(model, params, prefix=None, ctx=None):
    """Load reference parameters into a port ``TransformerLM``,
    ``BERTModel`` or ``PretrainStep`` in place (onto the model's device and
    dtype), or into any other ``gluon.Block`` (the model zoo) through its
    ``Parameter``s (deferred ones take the file's shapes and are made on
    ``ctx``, the current context when None). ``params`` is ``{name:
    np.ndarray}`` or the name of a ``.params`` file, with names in any of
    the formats of the module docstring. Refuses a missing or unexpected
    name, or a wrong shape, naming the parameter."""
    if _scoped(model):
        return _load_scoped(model, params, prefix, ctx)
    outer = _arch_of(model)[1]
    sd = {outer + k: v for k, v in
          state_dict_from_mxnet(params, prefix).items()}
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


def _reference_namer(arch, outer, prefix):
    """``name(port name) -> reference full name`` for one model family."""
    inv = {v: k for k, v in arch.top.items()}
    inv.update(("%s.%s" % (port, leaf), "%slayernorm0_%s" % (scope, leaf))
               for scope, port in arch.norms.items()
               for leaf in ("gamma", "beta"))
    layer = re.compile(r"^%s\.(\d+)\.(.+)$" % re.escape(arch.path))

    def name(port_name):
        bare = port_name[len(outer):] if port_name.startswith(outer) \
            else None
        m = layer.match(bare) if bare is not None else None
        if bare in inv:
            return prefix + inv[bare]
        if m is None:
            raise ValueError("unexpected parameter %r" % port_name)
        sub = m.group(2).split(".")
        if sub[0] in ("ln1", "ln2"):
            key = "layernorm%d_%s" % (int(sub[0] == "ln2"), sub[1])
        elif sub[0] == "attn":
            key = "%s%s_weight" % (arch.attn, sub[1])
        elif sub[0] in ("ffn_up", "ffn_down"):
            key = "%s_%s" % (sub[0], sub[1])
        else:
            raise ValueError("unexpected parameter %r" % port_name)
        return prefix + arch.layer_prefix % int(m.group(1)) + key
    return name


def _default_prefix(arch, outer):
    return ("pretrainstep0_" if outer else "") + arch.prefix


def reference_names(model, prefix=None):
    """``{port parameter name: reference full name}`` of a
    ``TransformerLM``, ``BERTModel`` or ``PretrainStep``, in the order of
    ``model.named_parameters()``, which is the reference's registration
    order. ``prefix`` defaults as in :func:`mxnet_params_from_state_dict`."""
    arch, outer = _arch_of(model)
    name = _reference_namer(arch, outer, _default_prefix(arch, outer)
                            if prefix is None else prefix)
    return {n: name(n) for n, _ in model.named_parameters()}


def reference_structural_names(model):
    """``{port parameter name: the reference's save_parameters name}`` of
    a ``TransformerLM``, ``BERTModel`` or ``PretrainStep``: the port's
    names, except that BERT's encoder layers are keyed by child index
    (``encoder.layers.0.`` is ``encoder.5.``)."""
    arch, outer = _arch_of(model)
    layer = re.compile(r"^(%sencoder\.)layers\.(\d+)\.(.+)$"
                       % re.escape(outer))
    out = {}
    for n, _ in model.named_parameters():
        m = layer.match(n) if arch is _BERT else None
        out[n] = "%s%d.%s" % (m.group(1), _BERT_LAYER0 + int(m.group(2)),
                              m.group(3)) if m else n
    return out


def mxnet_params_from_state_dict(state_dict, prefix=None, export=False):
    """The inverse map: a port model, or its state dict, to reference-style
    full names (counters from 0) and numpy arrays. The family comes from
    the model's type (from its names for a state dict); ``prefix``
    defaults to ``transformerlm0_``, ``bertmodel0_``, or
    ``pretrainstep0_bertmodel0_`` for a ``PretrainStep``. Any other
    ``gluon.Block`` gives its ``collect_params()`` names (its own prefix
    replaced by ``prefix`` when given; bfloat16 values as float32), marked
    ``arg:``/``aux:`` as the reference's ``export`` writes them when
    ``export``."""
    if _scoped(state_dict):
        return _scoped_params(state_dict, prefix, export)
    if isinstance(state_dict, torch.nn.Module):
        arch, outer = _arch_of(state_dict)
        state_dict = state_dict.state_dict()
    else:
        outer = "bert." if all(n.startswith("bert.") for n in state_dict) \
            else ""
        arch = _BERT if any("word_embed" in n for n in state_dict) else _LM
    name = _reference_namer(arch, outer, _default_prefix(arch, outer)
                            if prefix is None else prefix)
    return {name(n): t.detach().cpu().numpy() for n, t in state_dict.items()}
