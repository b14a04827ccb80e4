"""Counterpart of ``mxnet_tpu.gluon.nn``: the basic, convolution, pooling,
normalization and activation layers."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)
from .activations import ELU, GELU, LeakyReLU, PReLU, SELU, Swish

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Activation", "Conv1D", "Conv2D",
           "Conv3D", "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "ReflectionPad2D", "LeakyReLU", "PReLU", "ELU",
           "SELU", "Swish", "GELU"]
