"""gluon.contrib.data (counterpart of
``incubator_mxnet_tpu/gluon/contrib/data.py``; MXNet's
``gluon/contrib/data/{sampler,text}.py``): ``IntervalSampler`` and the
``WikiText2`` / ``WikiText103`` language-model datasets.

The datasets read the corpus from a local ``root`` (``wiki.<segment>.tokens``,
one token stream a split, MXNet's layout) and never download. Without the
file they raise ``FileNotFoundError``: the JAX package makes a synthetic
Zipf corpus there, seeded by Python's ``hash`` of the segment name, which
changes from process to process (``PYTHONHASHSEED``), so the port does not
carry it over.
"""
from __future__ import annotations

import os

import numpy as onp

from ..data.dataset import Dataset
from ..data.sampler import Sampler

__all__ = ["IntervalSampler", "WikiText2", "WikiText103"]


class IntervalSampler(Sampler):
    """[0, length) at stride ``interval``, rolling over to each skipped
    start with ``rollover``."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for start in range(self._interval if self._rollover else 1):
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class _WikiText(Dataset):
    """The token stream cut into ``seq_len`` segments; item i is (segment,
    the segment shifted by one token), ready for language-model training;
    ``vocab`` maps each word to its id in order of first appearance."""

    def __init__(self, root, segment, seq_len):
        self._root = os.path.expanduser(root)
        self._seq_len = seq_len
        path = os.path.join(self._root, "wiki.%s.tokens" % segment)
        if not os.path.exists(path):
            raise FileNotFoundError(
                "%s: no %s corpus here (it is read from a local root and "
                "never downloaded)" % (path, type(self).__name__))
        with open(path, encoding="utf-8") as f:
            words = f.read().split()
        vocab = {}
        ids = onp.array([vocab.setdefault(w, len(vocab)) for w in words],
                        dtype="int32")
        self.vocab = vocab
        n_seg = (len(ids) - 1) // seq_len
        ids = ids[: n_seg * seq_len + 1]
        self._data = ids[:-1].reshape(n_seg, seq_len)
        self._label = ids[1:].reshape(n_seg, seq_len)

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._data)


class WikiText2(_WikiText):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-2"),
                 segment="train", seq_len=35):
        super().__init__(root, segment, seq_len)


class WikiText103(_WikiText):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-103"),
                 segment="train", seq_len=35):
        super().__init__(root, segment, seq_len)
