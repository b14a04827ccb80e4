"""Model zoo (counterpart of ``mxnet_tpu.models``): the transformer LM."""
from .transformer import (MultiHeadAttention, TransformerEncoderLayer,
                          TransformerLM, transformer_lm_base,
                          transformer_lm_small, transformer_lm_tiny)

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerLM",
           "transformer_lm_tiny", "transformer_lm_small",
           "transformer_lm_base"]
