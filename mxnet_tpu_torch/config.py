"""Environment-variable knobs the port reads.

Counterpart of ``mxnet_tpu/config.py``: the same ``MXNET_*`` names and
defaults, for only the knobs that the generation-serving slice reads.
:func:`get` is a typed read of the environment, so a knob set after import
takes effect at its next read.
"""
from __future__ import annotations

import os

__all__ = ["get", "KNOBS"]


class Knob:
    __slots__ = ("name", "default", "typ", "doc")

    def __init__(self, name, default, typ, doc):
        self.name = name
        self.default = default
        self.typ = typ
        self.doc = doc


def _k(name, default, typ, doc):
    return name, Knob(name, default, typ, doc)


KNOBS = dict([
    _k("MXNET_GEN_SLOTS", 8, int,
       "generation serving: KV-cache arena slots == max sequences decoded "
       "per step (serving/generation/kvcache.py)"),
    _k("MXNET_GEN_MAX_SEQ", 256, int,
       "generation serving: per-slot KV capacity (prompt + generated), "
       "capped to the model's max_len"),
    _k("MXNET_GEN_LADDER", "16,32,64,128", str,
       "generation serving: prefill bucket ladder (comma-separated rungs; "
       "prompts pad up to a rung)"),
    _k("MXNET_GEN_MAX_NEW_TOKENS", 128, int,
       "generation serving: default per-request token budget"),
    _k("MXNET_GEN_TOP_K", 0, int,
       "generation serving: top-k sampling filter (0 = off; per-request "
       "temperature stays dynamic)"),
    _k("MXNET_GEN_QUEUE_SIZE", 64, int,
       "generation serving: waiting-request bound before ServerBusy "
       "backpressure (serving/generation/scheduler.py)"),
    _k("MXNET_FLASH_ATTENTION", 1, int,
       "dispatch dot_product_attention to the CUDA flash-attention kernel "
       "when its gate holds (ops/nn.py; 0 = always take the plain path)"),
])


def get(name, default=None):
    """Typed env read. Unknown names fall back to raw ``os.environ``."""
    knob = KNOBS.get(name)
    raw = os.environ.get(name)
    if knob is None:
        return raw if raw is not None else default
    if raw is None:
        return knob.default if default is None else default
    try:
        return knob.typ(raw)
    except (TypeError, ValueError):
        return knob.default
