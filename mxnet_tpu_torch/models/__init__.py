"""Model zoo (counterpart of ``mxnet_tpu.models``): the transformer LM
(with its tensor-parallel ``tp_rules``), BERT with its pretraining step,
the stage-stacked Mixture-of-Experts LM and the LSTM word language
model."""
from .bert import (BERTEncoder, BERTModel, BERTPretrainingLoss, PretrainLoss,
                   PretrainStep, bert_base, bert_tiny, synthetic_batch)
from .lstm_lm import RNNModel
from .moe_transformer import MoETransformerLM, moe_lm_tiny
from .transformer import (MultiHeadAttention, TransformerEncoderLayer,
                          TransformerLM, tp_rules, transformer_lm_base,
                          transformer_lm_small, transformer_lm_tiny)

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerLM",
           "transformer_lm_tiny", "transformer_lm_small",
           "transformer_lm_base", "BERTModel", "BERTEncoder",
           "BERTPretrainingLoss", "bert_tiny", "bert_base", "PretrainStep",
           "PretrainLoss", "synthetic_batch", "RNNModel", "tp_rules",
           "MoETransformerLM", "moe_lm_tiny"]
