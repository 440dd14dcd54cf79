"""Paged KV arena: one block pool shared by every request in flight
(counterpart of ``kata_xpu_device_plugin_tpu/guest/kv_arena.py``).

The slotted arena ``[L, max_batch, max_len, KV, D]`` charges every admitted
request the full ``max_len`` up front. The pool carves the KV memory into
blocks of ``block_size`` tokens; each request holds a block table mapping
its logical positions to physical blocks and grows it as it decodes, so
admission is by token budget and ``max_batch`` becomes a count of cheap
table rows.

- :class:`KVPool`: the device-resident pool, leaves ``[L, 1, num_blocks *
  block_size, KV, D]`` (bf16, or int8 :class:`..ops.quant.QTensor` pairs)
  from ``init_kv_caches``, with the host-side free list and per-block
  reference counts. Two blocks are reserved: ZERO is never written, so an
  unmapped table entry reads the zeros a fresh dense arena would hold;
  SCRATCH is the table filler and absorbs writes that must not land
  anywhere real. Reads remap SCRATCH to ZERO, so SCRATCH's contents never
  surface.
- Pool ops: copies between contiguous per-request caches (what
  ``prefill_batch`` produces) and pool blocks, and the gather/scatter pair
  preemption spills and restores with. They update the pool IN PLACE where
  the JAX package donates it.

Physical block ``t`` occupies pool rows ``t * block_size .. (t + 1) *
block_size``: the layout the paged decode kernel addresses, its KV tile
being one pool block.

The prefix tier, the host offload tier and block-sharded placement are
not ported yet.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..models.transformer import (
    PAGED_SCRATCH_BLOCK,
    PAGED_ZERO_BLOCK,
    DecoderConfig,
    init_kv_caches,
)
from ..ops.quant import QTensor

ZERO_BLOCK = PAGED_ZERO_BLOCK
SCRATCH_BLOCK = PAGED_SCRATCH_BLOCK
RESERVED_BLOCKS = 2


# ----- device ops ------------------------------------------------------------


def _leaves(tree) -> list:
    """The tensors of a cache pair ``(k, v)``, QTensor payloads and scales
    alike, in a fixed order."""
    out = []
    for c in tree:
        out.extend(c if isinstance(c, QTensor) else (c,))
    return out


def _rows_of(table: torch.Tensor, block_size: int) -> torch.Tensor:
    """Pool row indices of the blocks in ``table`` (any shape), flattened."""
    return (table.long()[..., None] * block_size
            + torch.arange(block_size, device=table.device)).reshape(-1)


def _pad_rows(seq: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``seq`` cut or zero-padded to ``n`` rows along ``axis``."""
    have = seq.shape[axis]
    if have >= n:
        return seq.narrow(axis, 0, n)
    pad = list(seq.shape)
    pad[axis] = n - have
    return torch.cat([seq, seq.new_zeros(pad)], dim=axis)


def pool_write_seq(pool, caches, row: int, table: torch.Tensor,
                   block_size: int):
    """Scatter row ``row`` of a contiguous cache pair (leaves ``[L, N, S,
    ...]``) into pool blocks, in place: cache rows ``[j*bs, (j+1)*bs)`` land
    in pool block ``table[j]``. SCRATCH entries mask chunks that must not
    land. Rows past the cache's length pad with zeros: they fall inside
    the request's own last block, past its prompt, and decode overwrites
    them before it attends to them. Returns the pool."""
    dest = _rows_of(table, block_size)
    for p, c in zip(_leaves(pool), _leaves(caches)):
        p[:, 0, dest] = _pad_rows(c[:, row], 1, dest.numel())
    return pool


def pool_write_batch(pool, caches, tables: torch.Tensor, block_size: int):
    """Batched :func:`pool_write_seq`: cache row ``i`` lands in blocks
    ``tables[i]``, one scatter per leaf for a whole admission group. Real
    blocks of distinct requests are disjoint; rows colliding on SCRATCH are
    don't-care, nothing reads them. Returns the pool."""
    n, nb = tables.shape
    dest = _rows_of(tables, block_size)
    for p, c in zip(_leaves(pool), _leaves(caches)):
        seq = _pad_rows(c[:, :n], 2, nb * block_size)
        p[:, 0, dest] = seq.reshape((seq.shape[0], n * nb * block_size)
                                    + tuple(seq.shape[3:]))
    return pool


def pool_gather_rows(pool, table: torch.Tensor, block_size: int):
    """Gather the token rows of blocks ``table`` out of the pool into a
    contiguous pair with leaves ``[L, len(table)*bs, ...]``: the preemption
    spill read (the caller copies it to the host)."""
    src = _rows_of(table, block_size)

    def take(p):
        return p[:, 0, src]

    return tuple(QTensor(*map(take, c)) if isinstance(c, QTensor) else take(c)
                 for c in pool)


def pool_scatter_rows(pool, rows, table: torch.Tensor, block_size: int):
    """Inverse of :func:`pool_gather_rows`, in place: land contiguous token
    rows (leaves ``[L, len(table)*bs, ...]``) into blocks ``table``: the
    preemption restore write. SCRATCH entries absorb the padding tail.
    Returns the pool."""
    dest = _rows_of(table, block_size)
    for p, r in zip(_leaves(pool), _leaves(rows)):
        p[:, 0, dest] = r
    return pool


# ----- the pool --------------------------------------------------------------


class KVPool:
    """Device-resident paged KV pool plus host-side block accounting.

    ``pool_tokens`` sizes the arena (rounded down to whole blocks; two are
    reserved). Blocks are reference counted: :meth:`try_alloc` hands out
    blocks at count 1, :meth:`ref` adds a holder, and :meth:`unref` returns
    a block to the free list when its last holder lets go."""

    def __init__(self, cfg: DecoderConfig, pool_tokens: int,
                 block_size: int = 16, *, kv_quant: bool = False, dtype=None,
                 shards: int = 1, device=None) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1:
            raise NotImplementedError(
                "block-sharded pools (shards > 1) are not ported yet: they "
                "come with tensor-parallel serving")
        num_blocks = int(pool_tokens) // int(block_size)
        if num_blocks - RESERVED_BLOCKS < 1:
            raise ValueError(
                f"pool_tokens={pool_tokens} holds {num_blocks} blocks of "
                f"{block_size} across {shards} shard(s) — need at least "
                f"{RESERVED_BLOCKS + 1} (two reserved + one usable)"
            )
        self.cfg = cfg
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.shards = 1
        self.kv_quant = bool(kv_quant)
        self.dtype = dtype or cfg.dtype
        self.arena = init_kv_caches(
            cfg, 1, num_blocks * self.block_size, device=device,
            dtype=self.dtype, quantized=kv_quant,
        )
        self._free: deque[int] = deque(range(RESERVED_BLOCKS, num_blocks))
        self._refs = np.zeros(num_blocks, np.int64)

    # -- block accounting -----------------------------------------------------

    @property
    def blocks_total(self) -> int:
        """Usable (non-reserved) blocks."""
        return self.num_blocks - RESERVED_BLOCKS

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.blocks_total - self.blocks_free

    @property
    def capacity_tokens(self) -> int:
        return self.blocks_total * self.block_size

    def occupancy(self) -> float:
        return round(self.blocks_in_use / max(1, self.blocks_total), 4)

    def try_alloc(self, n: int) -> Optional[list[int]]:
        """``n`` blocks at count 1, or None: all or nothing, since a partial
        grant would deadlock two growing lanes against each other."""
        if n < 0:
            raise ValueError(f"try_alloc({n})")
        if self.blocks_free < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._refs[out] += 1
        return out

    def ref(self, blocks) -> None:
        """Add a holder to already allocated blocks."""
        for b in blocks:
            assert self._refs[b] > 0, f"ref of unallocated block {b}"
            self._refs[b] += 1

    def unref(self, blocks) -> None:
        """Drop one holder per block; a block at count 0 returns to the
        free list."""
        for b in blocks:
            assert b >= RESERVED_BLOCKS, f"unref of reserved block {b}"
            self._refs[b] -= 1
            assert self._refs[b] >= 0, f"block {b} over-released"
            if self._refs[b] == 0:
                self._free.append(b)

    def stats(self) -> dict:
        return {
            "block_size": self.block_size,
            "blocks_total": self.blocks_total,
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": self.blocks_free,
            "capacity_tokens": self.capacity_tokens,
            "occupancy": self.occupancy(),
            "shards": self.shards,
            "shard_occupancy": [self.occupancy()],
        }
