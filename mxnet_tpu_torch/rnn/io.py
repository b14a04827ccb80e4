"""Bucketed sentence iterators: counterpart of ``mxnet_tpu/rnn/io.py``.

``encode_sentences`` and ``BucketSentenceIter``: sentences padded with
``invalid_label`` into the smallest bucket that holds them, batches of one
bucket each, the label the data shifted by one step. ``reset`` shuffles
with the global ``random.shuffle`` (the batch order) and
``numpy.random.shuffle`` (each bucket's rows), as the reference does, so
the same seeds give the same batches. The arrays are host NDArrays (CPU).
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from ..context import cpu as _cpu
from ..io.io import DataIter, DataBatch, DataDesc
from ..ndarray import ndarray as _nd

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """MXNet's rnn/io.py:33."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert (new_vocab or unknown_token), \
                    "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """MXNet's rnn/io.py:81."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                data_name, (batch_size, self.default_bucket_key),
                layout=layout)]
            self.provide_label = [DataDesc(
                label_name, (batch_size, self.default_bucket_key),
                layout=layout)]
        else:
            self.provide_data = [DataDesc(
                data_name, (self.default_bucket_key, batch_size),
                layout=layout)]
            self.provide_label = [DataDesc(
                label_name, (self.default_bucket_key, batch_size),
                layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(_nd.array(buck, ctx=_cpu(),
                                         dtype=self.dtype))
            self.ndlabel.append(_nd.array(label, ctx=_cpu(),
                                          dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(
                             self.data_name, data.shape,
                             layout=self.layout)],
                         provide_label=[DataDesc(
                             self.label_name, label.shape,
                             layout=self.layout)])
