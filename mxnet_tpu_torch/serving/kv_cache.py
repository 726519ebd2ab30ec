"""Paged KV-cache allocator: fixed-size blocks in a preallocated pool.

Counterpart of ``mxnet_tpu/serving/kv_cache.py``. The K/V cache is one
preallocated device pool of fixed-size *blocks* (``block_size`` tokens
each), and every request holds a *block table*: token position ``p``
maps to slot ``(table[p // block_size], p % block_size)``. Admission
allocates ceil(len/block_size) blocks, decode one more whenever a
request crosses a block boundary, finish/cancel/evict frees them all.

Block 0 is the *scratch sink*: padded batch rows and masked-out lanes
of a step write their K/V there, so real blocks stay clean. The pool
hands out blocks 1..num_blocks-1.

The pool tensors are updated IN PLACE by the step (the JAX package's
arrays are functional and the engine swaps in the returned ones); that
saves a second copy of the pool on the card, and is why the port's pool
has no ``swap``. Speculative decoding keeps the draft model's K/V in a
:meth:`PagedKVPool.mirror` of the target's pool.

Backpressure: ``alloc`` returns None when the free list can't cover a
request; the scheduler treats None as the OOM signal.
"""
from __future__ import annotations

import torch

from ..context import resolve_device

__all__ = ["PagedKVPool", "blocks_for_tokens"]


def blocks_for_tokens(num_tokens, block_size):
    """Blocks needed to hold ``num_tokens`` (ceil division, min 1)."""
    return max(1, -(-int(num_tokens) // int(block_size)))


class PagedKVPool:
    """Preallocated paged K/V device pool + free-list block allocator.

    Storage is two tensors shaped ``[num_layers, num_blocks, block_size,
    num_heads, head_dim]`` (K and V) on ``device``.
    """

    def __init__(self, num_layers, num_heads, head_dim, num_blocks,
                 block_size, dtype="float32", device=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the scratch "
                             "sink), got %d" % num_blocks)
        if block_size < 1:
            raise ValueError("block_size must be >= 1, got %d" % block_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        # LIFO free list (reuse the most recently freed blocks first)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._hwm = 0  # high-water mark of blocks in use

    # -- allocator -----------------------------------------------------------
    @property
    def capacity(self):
        """Usable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return self.capacity - len(self._free)

    def utilization(self):
        """Fraction of usable blocks currently allocated, 0..1."""
        return self.num_used / float(self.capacity)

    def high_water_mark(self):
        """Peak blocks-in-use since construction."""
        return self._hwm

    def alloc(self, n):
        """Take ``n`` blocks off the free list; ``None`` when the pool
        can't cover them."""
        n = int(n)
        if n < 0:
            raise ValueError("alloc(%d)" % n)
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._hwm = max(self._hwm, self.num_used)
        return blocks

    def free(self, blocks):
        """Return blocks to the free list (double-free raises)."""
        for b in blocks:
            b = int(b)
            if not 1 <= b < self.num_blocks:
                raise ValueError("free of invalid block %d" % b)
            if b in self._free:
                raise ValueError("double free of block %d" % b)
        self._free.extend(int(b) for b in blocks)

    def mirror(self, num_layers, num_heads, head_dim, dtype="float32"):
        """A second pool with the same block geometry (num_blocks,
        block_size) on the same device but its own K/V shape: the draft
        model's pool in speculative decoding. Equal block counts keep
        the target and draft block tables in lockstep, so every paired
        alloc/free succeeds or fails together."""
        return PagedKVPool(num_layers, num_heads, head_dim,
                           self.num_blocks, self.block_size, dtype=dtype,
                           device=self.device)
