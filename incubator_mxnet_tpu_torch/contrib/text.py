"""Text utilities: a vocabulary and token embeddings (counterpart of
``incubator_mxnet_tpu/contrib/text.py``; MXNet's
``python/mxnet/contrib/text/{utils,vocab,embedding}.py``).

Embeddings load from local files in the ``token v1 v2 ...`` text format;
the downloadable GloVe/fastText catalogs raise, as in the reference. The
vectors are an NDArray on the current context (``ctx`` to choose).
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as onp

from .. import ndarray as nd

__all__ = ["count_tokens_from_str", "Vocabulary", "TokenEmbedding",
           "CustomEmbedding", "register", "create", "get_pretrained_file_names"]

_EMBED_REGISTRY = {}


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """MXNet's text/utils.py count_tokens_from_str."""
    source_str = re.sub(r"\s+", " ",
                        source_str.replace(seq_delim, token_delim)).strip()
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None else Counter()
    counter.update(t for t in source_str.split(token_delim) if t)
    return counter


class Vocabulary:
    """Token <-> index mapping (MXNet's text/vocab.py Vocabulary).

    Index 0 is the unknown token; ``reserved_tokens`` follow it; the rest
    are counter keys sorted by frequency (ties broken alphabetically).
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        assert min_freq > 0
        self._unknown_token = unknown_token
        reserved_tokens = list(reserved_tokens or [])
        assert len(set(reserved_tokens)) == len(reserved_tokens), \
            "reserved tokens must not repeat"
        assert unknown_token not in reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        self._reserved_tokens = reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq < min_freq:
                    break
                if tok != unknown_token and tok not in reserved_tokens:
                    self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """MXNet's vocab.py to_indices: unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self):
                raise ValueError("token index %d out of range [0, %d)"
                                 % (i, len(self)))
        out = [self._idx_to_token[i] for i in idxs]
        return out[0] if single else out


class TokenEmbedding(Vocabulary):
    """A pretrained embedding over a vocabulary (MXNet's
    text/embedding.py): ``token v1 v2 ...`` lines from a local file;
    tokens the file lacks get ``init_unknown_vec`` (zeros by default)."""

    def __init__(self, file_path=None, vocabulary=None, init_unknown_vec=None,
                 encoding="utf8", ctx=None, **kwargs):
        counter = Counter(
            {t: 1 for t in (vocabulary.idx_to_token[1:] if vocabulary
                            else [])})
        super().__init__(counter if vocabulary else None, **kwargs)
        self._vec_len = 0
        self._token_to_vec = {}
        if file_path:
            self._load_embedding(file_path, encoding)
        if vocabulary is None and self._token_to_vec:
            # the vocabulary FROM the file: all its tokens, file order
            for t in self._token_to_vec:
                if t not in self._token_to_idx:
                    self._token_to_idx[t] = len(self._idx_to_token)
                    self._idx_to_token.append(t)
        unk = init_unknown_vec(self._vec_len) if init_unknown_vec \
            else onp.zeros(self._vec_len, "float32")
        mat = onp.stack([self._token_to_vec.get(t, unk)
                         for t in self._idx_to_token]) if self._vec_len else \
            onp.zeros((len(self), 0), "float32")
        self._idx_to_vec = nd.array(mat, ctx=ctx)

    def _load_embedding(self, path, encoding):
        with open(path, encoding=encoding) as f:
            for ln, line in enumerate(f):
                parts = line.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                tok, vals = parts[0], parts[1:]
                if self._vec_len == 0:
                    self._vec_len = len(vals)
                elif len(vals) != self._vec_len:
                    raise ValueError(
                        "line %d of %s has %d values, expected %d"
                        % (ln + 1, path, len(vals), self._vec_len))
                self._token_to_vec[tok] = onp.asarray(vals, "float32")

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """MXNet's embedding.py get_vecs_by_tokens."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            if t not in self._token_to_idx and lower_case_backup:
                t = t.lower()
            idxs.append(self._token_to_idx.get(t, 0))
        if single:
            return self._idx_to_vec[idxs[0]]
        return self._idx_to_vec[onp.asarray(idxs)]

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else tokens
        arr = onp.array(self._idx_to_vec.asnumpy())  # writable copy
        vec = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else onp.asarray(new_vectors)
        vec = vec.reshape(len(toks), -1)
        for t, v in zip(toks, vec):
            if t not in self._token_to_idx:
                raise ValueError("token %r not in the embedding" % t)
            arr[self._token_to_idx[t]] = v
        self._idx_to_vec = nd.array(arr, ctx=self._idx_to_vec.context)


class CustomEmbedding(TokenEmbedding):
    """MXNet's embedding.py CustomEmbedding: a user's embedding file."""


def register(cls):
    """MXNet's embedding.py register."""
    _EMBED_REGISTRY[cls.__name__.lower()] = cls
    return cls


register(CustomEmbedding)


def create(embedding_name, **kwargs):
    """MXNet's embedding.py create. The named pretrained catalogs
    (glove/fasttext) need downloads and are not available: use
    CustomEmbedding with a local file."""
    name = embedding_name.lower()
    if name not in _EMBED_REGISTRY:
        raise ValueError(
            "embedding %r unavailable (downloadable catalogs are out of "
            "scope; have: %s — use CustomEmbedding with a local file)"
            % (embedding_name, sorted(_EMBED_REGISTRY)))
    return _EMBED_REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """MXNet's embedding.py get_pretrained_file_names: empty catalogs."""
    return {} if embedding_name is None else []
