"""Sentence bucketing (counterpart of ``incubator_mxnet_tpu/rnn/io.py``;
MXNet's ``python/mxnet/rnn/io.py``): ``encode_sentences`` and
``BucketSentenceIter`` for ``BucketingModule``.

Batches are numpy arrays made on the host and handed over as CPU
NDArrays; the module copies each into its bound buffers on its own
context. The shuffle is the JAX package's: Python's ``random.shuffle`` of
the batch index list, then numpy's global shuffle of each bucket, so
seeding both gives its batches; ``generator`` (a
``numpy.random.RandomState`` or ``Generator``) draws both shuffles
instead.
"""
from __future__ import annotations

import logging
import random as pyrandom

import numpy as onp

from .. import ndarray as nd
from ..context import cpu
from ..io.io import DataIter, DataBatch, DataDesc

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sequences to int ids, building the vocabulary as it goes
    unless one is given. Returns (encoded sentences, vocabulary)."""
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
                assert new_vocab, "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Each sentence padded with ``invalid_label`` to the smallest bucket
    that holds it (longer ones are dropped); a batch holds one bucket's
    sentences, its label the data one token on, and its ``bucket_key`` is
    the bucket's length. Without ``buckets``, every length with at least
    ``batch_size`` sentences is one."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", generator=None):
        super().__init__(batch_size)
        if not buckets:
            counts = onp.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
        buckets.sort()
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets) if b >= len(sent)),
                        None)
            if buck is None:
                ndiscard += 1
                continue
            buff = onp.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[: len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [onp.asarray(x, dtype=dtype) for x in self.data]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self.generator = generator
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.reset()

    def _shape(self):
        return (self.batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key,
                                          self.batch_size)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, self._shape(), self.dtype)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, self._shape(), self.dtype)]

    def reset(self):
        """Shuffle the batch order and each bucket's sentences."""
        self.curr_idx = 0
        if self.generator is None:
            pyrandom.shuffle(self.idx)
            for buck in self.data:
                onp.random.shuffle(buck)
        else:
            self.generator.shuffle(self.idx)
            for buck in self.data:
                self.generator.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = onp.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j: j + self.batch_size]
        label = self.ndlabel[i][j: j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        return DataBatch([nd.array(data, ctx=cpu())],
                         [nd.array(label, ctx=cpu())],
                         pad=0, bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                self.dtype)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 self.dtype)])
