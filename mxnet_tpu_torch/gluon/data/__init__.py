"""Gluon data API (counterpart of ``mxnet_tpu.gluon.data``)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, DataLoaderSkipLimit
from . import vision
