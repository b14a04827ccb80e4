"""Gluon vision data (counterpart of ``mxnet_tpu.gluon.data.vision``)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms
