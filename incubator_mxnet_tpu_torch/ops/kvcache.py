"""Paged (blocked) KV cache for autoregressive decode (counterpart of
``incubator_mxnet_tpu/ops/kvcache.py``): the vLLM-style pool behind
``serving/generate.py``'s continuous-batching engine.

The cache is one preallocated pool of fixed-size **blocks**
(``MXTPU_GEN_BLOCK_SIZE`` token slots each); a sequence owns a list of
block ids (its **block table**) and returns them to the free list the
moment it retires, so pool occupancy tracks the live token count, not the
worst case.

- ``BlockAllocator``: host-side free-list bookkeeping (LIFO reuse,
  all-or-nothing allocation), as in the JAX package.
- ``write_seq`` / ``append_token`` / ``gather_layer`` /
  ``paged_attention``: plain torch indexing on the pool, capture-safe (no
  host read, no data-dependent shape). The JAX package's are pure
  functions over a donated pool; here the writes update the pool **in
  place** (``index_put_``) and return it, so a captured decode step
  updates the cache where it lies.

Out-of-range writes. The JAX package scatters with ``mode="drop"`` and
``num_blocks`` (one past the last block) as the "nowhere" index, so
padded positions and inactive batch rows write nothing. Torch has no drop
mode, and an index past the tensor is a device-side assert that ends the
process. So ``make_pool`` allocates one private block past the
``num_blocks`` the pool reports: the pool is a view of the first
``num_blocks`` blocks of that storage, and every write whose block id is
out of range (``num_blocks`` itself, padding, an inactive row) lands in
the private block instead, which nothing reads. ``pool_shape`` and
``pool_bytes`` report the pool without it, as the JAX package's. Gathers
clamp out-of-range table entries into the pool, as JAX's default gather
mode does; callers mask by length.

Pool layout: ``(num_blocks, block_size, layers, 2, heads, head_dim)``.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

__all__ = ["KVCacheOOM", "BlockAllocator", "pool_shape", "make_pool",
           "pool_bytes", "blocks_for", "write_seq", "append_token",
           "gather_layer", "paged_attention"]


class KVCacheOOM(RuntimeError):
    """The pool has fewer free blocks than the allocation needs; the
    engine's join path turns this into admission backpressure."""


class BlockAllocator:
    """Host-side free list over ``num_blocks`` pool blocks.

    LIFO reuse (the most recently freed block is handed out first), so a
    retired sequence's blocks are the ones a joining sequence receives.
    Thread-safe; ``used + free == total`` holds at every exit and double
    frees raise."""

    def __init__(self, num_blocks):
        if num_blocks <= 0:
            raise ValueError("need at least one block, got %d" % num_blocks)
        self.total = int(num_blocks)
        self._lock = threading.Lock()
        # stack order: block 0 on top so first alloc is [0, 1, ...]
        self._free = list(range(self.total - 1, -1, -1))
        self._held = set()

    @property
    def used(self):
        with self._lock:
            return self.total - len(self._free)

    @property
    def free_count(self):
        with self._lock:
            return len(self._free)

    def alloc(self, n):
        """Take ``n`` blocks, or raise KVCacheOOM taking none."""
        n = int(n)
        if n < 0:
            raise ValueError("alloc(%d)" % n)
        with self._lock:
            if n > len(self._free):
                raise KVCacheOOM(
                    "need %d KV block(s), %d free of %d — raise "
                    "MXTPU_GEN_KV_BLOCKS or lower the admission load"
                    % (n, len(self._free), self.total))
            taken = [self._free.pop() for _ in range(n)]
            self._held.update(taken)
        return taken

    def free(self, blocks):
        """Return blocks to the free list (newest freed reused first)."""
        with self._lock:
            for b in blocks:
                b = int(b)
                if b not in self._held:
                    raise ValueError("double free of KV block %d" % b)
                self._held.discard(b)
                self._free.append(b)


def blocks_for(tokens, block_size):
    """Blocks needed to hold ``tokens`` positions (ceil division, >= 1)."""
    return max(1, -(-int(tokens) // int(block_size)))


def pool_shape(num_blocks, block_size, layers, heads, head_dim):
    """The pool's shape: the one place the layout is spelled."""
    return (num_blocks, block_size, layers, 2, heads, head_dim)


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def make_pool(num_blocks, block_size, layers, heads, head_dim,
              dtype=torch.float32, device="cpu"):
    """The preallocated pool, zero-filled (unwritten slots read as zeros:
    finite, so a masked row never produces NaN scores). Its storage holds
    one private block past the ``num_blocks`` it shows, for out-of-range
    writes (see the module's docstring)."""
    full = torch.zeros(pool_shape(num_blocks + 1, block_size, layers, heads,
                                  head_dim), dtype=_dtype(dtype),
                       device=device)
    return full[:num_blocks]


def pool_bytes(num_blocks, block_size, layers, heads, head_dim,
               dtype=torch.float32):
    """Bytes one pool of ``num_blocks`` occupies (its private block
    aside), for sizing against the card's memory."""
    n = num_blocks * block_size * layers * 2 * heads * head_dim
    return int(n) * torch.empty((), dtype=_dtype(dtype)).element_size()


def _with_private_block(pool):
    """The pool's tensor with its private block (index ``num_blocks``)."""
    n = pool.shape[0]
    if torch.compiler.is_compiling():
        # an export traces the pool as a slice of its program input, which
        # holds the private block (the storage check reads no fake size)
        return pool.as_strided((n + 1,) + tuple(pool.shape[1:]),
                               pool.stride(), pool.storage_offset())
    need = (pool.storage_offset() + (n + 1) * pool.stride(0)) \
        * pool.element_size()
    if not pool.is_contiguous() or pool.untyped_storage().nbytes() < need:
        raise ValueError("a KV pool must come from kvcache.make_pool (its "
                         "storage holds one block past the pool for "
                         "out-of-range writes)")
    return pool.as_strided((n + 1,) + tuple(pool.shape[1:]), pool.stride(),
                           pool.storage_offset())


def _on(x, pool, dtype=None):
    """``x`` as a tensor on the pool's device (a no-op for one already
    there, as inside a capture)."""
    return torch.as_tensor(x, dtype=dtype, device=pool.device)


def _nowhere(blk, n):
    """Block ids out of [0, n) replaced by ``n``, the private block."""
    return torch.where((blk >= 0) & (blk < n), blk, n)


def write_seq(pool, blocks, k, v, length):
    """Write one sequence's prefill K/V into its blocks, in place.

    ``blocks``: (max_blocks,) int32 block table row; ``k``/``v``:
    (L_pad, layers, heads, head_dim); positions ``>= length`` are padding
    and land in the private block. Returns ``pool``."""
    full = _with_private_block(pool)
    n, bs = pool.shape[0], pool.shape[1]
    blocks = _on(blocks, pool).long()
    k, v = _on(k, pool, pool.dtype), _on(v, pool, pool.dtype)
    length = _on(length, pool)
    pos = torch.arange(k.shape[0], device=pool.device)
    col = (pos // bs).clamp(max=blocks.shape[0] - 1)
    blk = torch.where(pos < length, _nowhere(blocks[col], n), n)
    kv = torch.stack([k, v], dim=2)      # (L_pad, layers, 2, heads, hd)
    full.index_put_((blk, pos % bs), kv)
    return pool


def append_token(pool, block_tables, lengths, layer, k, v, active=None):
    """Append one decode step's K/V at position ``lengths[i]`` of every
    row, for one layer, in place.

    ``block_tables``: (B, max_blocks) int32; ``lengths``: (B,) int32 (the
    position written); ``k``/``v``: (B, heads, head_dim). Rows where
    ``active`` is False land in the private block. Returns ``pool``."""
    full = _with_private_block(pool)
    n, bs = pool.shape[0], pool.shape[1]
    block_tables = _on(block_tables, pool).long()
    lengths = _on(lengths, pool).long()
    rows = torch.arange(block_tables.shape[0], device=pool.device)
    col = (lengths // bs).clamp(0, block_tables.shape[1] - 1)
    blk = _nowhere(block_tables[rows, col], n)
    if active is not None:
        blk = torch.where(_on(active, pool, torch.bool), blk, n)
    kv = torch.stack([_on(k, pool, pool.dtype), _on(v, pool, pool.dtype)],
                     dim=1)             # (B, 2, heads, hd)
    full.index_put_((blk, lengths % bs, torch.full_like(blk, layer)), kv)
    return pool


def gather_layer(pool, block_tables, layer):
    """One layer's cached K and V for every row in block-table order:
    -> (keys, values), each (B, max_blocks * block_size, heads, head_dim).
    Out-of-range table entries clamp into the pool; callers mask by
    length."""
    n = pool.shape[0]
    idx = _on(block_tables, pool).long().clamp(0, n - 1)
    g = pool[:, :, layer][idx]          # (B, max_blocks, bs, 2, h, d)
    b, mb, bs = g.shape[0], g.shape[1], g.shape[2]
    g = g.reshape(b, mb * bs, 2, g.shape[4], g.shape[5])
    return g[:, :, 0], g[:, :, 1]


def paged_attention(q, keys, values, lengths):
    """Masked single-token attention over the gathered cache.

    ``q``: (B, heads, head_dim); ``keys``/``values``: (B, T, heads,
    head_dim) from ``gather_layer``; ``lengths``: (B,) the count of valid
    positions (>= 1). Scores in fp32, positions ``>= length`` at -inf, as
    the JAX package's."""
    # the JAX package's float32 scale, 1 / sqrt(float32(d))
    scale = float(onp.float32(1.0) / onp.sqrt(onp.float32(q.shape[-1])))
    s = torch.einsum("bhd,bthd->bht", q, keys).float() * scale
    t = torch.arange(keys.shape[1], device=keys.device)
    mask = t[None, :] < torch.as_tensor(lengths,
                                        device=keys.device)[:, None]
    s = torch.where(mask[:, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1).to(values.dtype)
    return torch.einsum("bht,bthd->bhd", p, values)
