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
  the JAX package donates it: the decode graph holds the pool's addresses.
- :class:`HostKVTier`: the bounded host-RAM store below the pool, the
  accounting and payloads of demoted prefix segments and preempted
  sessions' spills. On CUDA its payloads sit in pinned memory
  (:func:`rows_to_host`), so uploads from it are asynchronous.
- :class:`PagedPrefixTier`: the radix prefix store of
  :mod:`.prefix_cache` homed inside the pool. Segments are block lists; a
  hit shares the fully covered blocks with the admitted request's table
  (pool reference counts, read-only) and the partly covered boundary block
  is copied on write into a private block; LRU eviction returns blocks to
  the free list decode allocates from, or, with a host tier, demotes the
  segment to host RAM, and a later hit promotes it back verbatim.

Physical block ``t`` occupies pool rows ``t * block_size .. (t + 1) *
block_size``: the layout the paged decode kernel addresses, its KV tile
being one pool block.

Block-sharded placement (``shards > 1``, the ``"blocks"`` layout of
tensor-parallel serving): shard ``s`` holds blocks ``[s·shard_blocks,
(s+1)·shard_blocks)``, a sub-pool of whole blocks with a free list of its
own; a lane's table mixes shards freely. With every shard on one device
(:mod:`.tp_serving`) the sub-pools are views of the one pool tensor, so
the pool ops below, the prefix tier's and the host tier's, move rows as
they do unsharded.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import obs
from ..models.transformer import (
    PAGED_SCRATCH_BLOCK,
    PAGED_ZERO_BLOCK,
    DecoderConfig,
    init_kv_caches,
)
from ..ops.quant import QTensor
from .prefix_cache import PrefixHit, RadixStore, cache_leaves

ZERO_BLOCK = PAGED_ZERO_BLOCK
SCRATCH_BLOCK = PAGED_SCRATCH_BLOCK
RESERVED_BLOCKS = 2


# ----- device ops ------------------------------------------------------------


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
    for p, c in zip(cache_leaves(pool), cache_leaves(caches)):
        p[:, 0, dest] = _pad_rows(c[:, row], 1, dest.numel())
    return pool


def pool_write_batch(pool, caches, tables: torch.Tensor, block_size: int):
    """Batched :func:`pool_write_seq`: cache row ``i`` lands in blocks
    ``tables[i]``, one scatter per leaf for a whole admission group. Real
    blocks of distinct requests are disjoint; rows colliding on SCRATCH are
    don't-care, nothing reads them. Returns the pool."""
    n, nb = tables.shape
    dest = _rows_of(tables, block_size)
    for p, c in zip(cache_leaves(pool), cache_leaves(caches)):
        seq = _pad_rows(c[:, :n], 2, nb * block_size)
        p[:, 0, dest] = seq.reshape((seq.shape[0], n * nb * block_size)
                                    + tuple(seq.shape[3:]))
    return pool


def pool_gather_rows(pool, table: torch.Tensor, block_size: int):
    """Gather the token rows of blocks ``table`` out of the pool into a
    contiguous pair with leaves ``[L, len(table)*bs, ...]``: the preemption
    spill read (the caller copies it to the host)."""
    src = _rows_of(table, block_size)
    return map_rows(pool, lambda p: p[:, 0, src])


def pool_scatter_rows(pool, rows, table: torch.Tensor, block_size: int):
    """Inverse of :func:`pool_gather_rows`, in place: land contiguous token
    rows (leaves ``[L, len(table)*bs, ...]``) into blocks ``table``: the
    preemption restore write. SCRATCH entries absorb the padding tail.
    Returns the pool."""
    dest = _rows_of(table, block_size)
    for p, r in zip(cache_leaves(pool), cache_leaves(rows)):
        p[:, 0, dest] = r
    return pool


def pool_materialize(pool, table: torch.Tensor, length: int,
                     cfg: DecoderConfig, max_len: int, quantized: bool, dtype,
                     n: int, block_size: int):
    """A fresh ``[L, n, max_len, ...]`` cache pair with the pool rows of
    blocks ``table`` landed in every row at positions ``[0, length)``: the
    caches ``prefill_suffix`` resumes from (``n > 1``: one shared prefix
    fanned out to a same-match admission group)."""
    caches = init_kv_caches(cfg, n, max_len, device=table.device, dtype=dtype,
                            quantized=quantized)
    src = _rows_of(table, block_size)[:length]
    for c, p in zip(cache_leaves(caches), cache_leaves(pool)):
        c[:, :, :length] = p[:, 0, src][:, None]
    return caches


def map_rows(rows, fn):
    """``fn`` applied to every tensor of a cache or rows pair, the pair's
    structure (QTensor or plain) kept; a cycle arena's tuple of pairs maps
    pair by pair."""
    def one(c):
        if isinstance(c, QTensor):
            return QTensor(*map(fn, c))
        if isinstance(c, tuple):
            return tuple(one(x) for x in c)
        return fn(c)

    return tuple(one(c) for c in rows)


def rows_to_host(rows):
    """A rows pair the gather just made, copied to the host: on CUDA into
    pinned buffers by ``non_blocking`` copies on the current stream, behind
    the work that writes the rows, so an upload from them is asynchronous
    as well. Nothing reads the buffers on the host; a copy back to the card
    from the same stream, or from one that waits for an event recorded
    after this call, finds them complete. On the CPU the rows themselves."""
    def down(t):
        if not t.is_cuda:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    return map_rows(rows, down)


def table_tensor(blocks, device: torch.device) -> torch.Tensor:
    """Block ids (a list or an array) as an int32 table on ``device``: on
    CUDA uploaded from a pinned copy without waiting, ordered on the
    current stream, so that a table made while a chunk is in flight does
    not wait for the chunk."""
    t = torch.tensor(np.asarray(blocks, np.int32))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def rows_to_device(rows, device):
    """Upload a host rows pair on the current stream (asynchronous from
    pinned buffers)."""
    return map_rows(rows, lambda t: t.to(device, non_blocking=True))


# ----- the pool --------------------------------------------------------------


class KVPool:
    """Device-resident paged KV pool plus host-side block accounting.

    ``pool_tokens`` sizes the arena (rounded down to whole blocks, and to a
    multiple of ``shards``; two are reserved, both on shard 0). Blocks are
    reference counted: :meth:`try_alloc` hands out blocks at count 1,
    :meth:`ref` adds a holder, and :meth:`unref` returns a block to its
    shard's free list when its last holder lets go. On a sharded pool
    :meth:`try_alloc` draws each block from the emptiest shard, in the
    JAX package's order, so the sub-pools fill evenly."""

    def __init__(self, cfg: DecoderConfig, pool_tokens: int,
                 block_size: int = 16, *, kv_quant: bool = False, dtype=None,
                 shards: int = 1, device=None) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        num_blocks = int(pool_tokens) // int(block_size)
        num_blocks = (num_blocks // shards) * shards
        if num_blocks - RESERVED_BLOCKS < 1:
            raise ValueError(
                f"pool_tokens={pool_tokens} holds {num_blocks} blocks of "
                f"{block_size} across {shards} shard(s) — need at least "
                f"{RESERVED_BLOCKS + 1} (two reserved + one usable)"
            )
        self.cfg = cfg
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.shards = int(shards)
        self.shard_blocks = num_blocks // self.shards
        self.kv_quant = bool(kv_quant)
        self.dtype = dtype or cfg.dtype
        self.arena = init_kv_caches(
            cfg, 1, num_blocks * self.block_size, device=device,
            dtype=self.dtype, quantized=kv_quant,
        )
        self.device = cache_leaves(self.arena)[0].device
        self._fresh_lists()

    def _fresh_lists(self) -> None:
        self._free: list[deque[int]] = [
            deque(b for b in range(s * self.shard_blocks,
                                   (s + 1) * self.shard_blocks)
                  if b >= RESERVED_BLOCKS)
            for s in range(self.shards)]
        self._refs = np.zeros(self.num_blocks, np.int64)

    def reset(self, shards: Optional[int] = None) -> None:
        """The pool as a new one of the same size would be, in place: every
        block free in the constructor's order, no holder, the arena zeroed
        (the ZERO and scratch blocks restored). The tensors stay where they
        are: a decode graph holds their addresses. ``shards`` re-partitions
        the sub-pools (the blocks layout after a mesh shrink); it must
        divide the block count. The JAX server builds a fresh pool here."""
        if shards is not None:
            if shards < 1 or self.num_blocks % shards:
                raise ValueError(f"{self.num_blocks} blocks do not split "
                                 f"into {shards} shards")
            self.shards = int(shards)
            self.shard_blocks = self.num_blocks // self.shards
        for t in cache_leaves(self.arena):
            t.zero_()
        self._fresh_lists()

    # -- block accounting -----------------------------------------------------

    @property
    def blocks_total(self) -> int:
        """Usable (non-reserved) blocks."""
        return self.num_blocks - RESERVED_BLOCKS

    @property
    def blocks_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.blocks_total - self.blocks_free

    @property
    def capacity_tokens(self) -> int:
        return self.blocks_total * self.block_size

    def occupancy(self) -> float:
        return round(self.blocks_in_use / max(1, self.blocks_total), 4)

    def shard_of(self, block: int) -> int:
        """The shard that holds ``block`` (0 on an unsharded pool)."""
        return block // self.shard_blocks

    def shard_occupancy(self) -> list[float]:
        """Each shard's blocks in use over its usable blocks (shard 0's
        count leaves out the two reserved blocks)."""
        out = []
        for s, free in enumerate(self._free):
            usable = self.shard_blocks - (RESERVED_BLOCKS if s == 0 else 0)
            out.append(round((usable - len(free)) / max(1, usable), 4))
        return out

    def try_alloc(self, n: int) -> Optional[list[int]]:
        """``n`` blocks at count 1, or None: all or nothing, since a partial
        grant would deadlock two growing lanes against each other. Each
        block comes from the shard with the most free blocks (the lowest
        such shard on a tie)."""
        if n < 0:
            raise ValueError(f"try_alloc({n})")
        if self.blocks_free < n:
            return None
        out = [max(self._free, key=len).popleft() for _ in range(n)]
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
                self._free[self.shard_of(b)].append(b)

    def stats(self) -> dict:
        return {
            "block_size": self.block_size,
            "blocks_total": self.blocks_total,
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": self.blocks_free,
            "capacity_tokens": self.capacity_tokens,
            "occupancy": self.occupancy(),
            "shards": self.shards,
            "shard_occupancy": self.shard_occupancy(),
        }


# ----- the host-RAM tier -------------------------------------------------------


@dataclass
class _HostEntry:
    """One host-resident KV parcel: ``rows`` the spilled pair (None for an
    entry that only accounts for a payload held elsewhere, as the serving
    loop's preemption spills), ``tokens`` its length, ``pinned`` state in
    flight that must not LRU out and may overflow the capacity."""

    tokens: int
    rows: Any = None
    tick: int = 0
    pinned: bool = False


class HostKVTier:
    """Bounded host-RAM store below the pool: cold KV (demoted prefix
    segments, preempted sessions' spills) parks here instead of holding
    device memory. Accounting and payloads only: what demotes and when to
    upload is its clients' policy (:class:`PagedPrefixTier`, the server's
    preemption), and it never touches the device itself.

    ``capacity_tokens`` bounds the unpinned (cache) population; a client
    makes room with :meth:`room` before :meth:`put` and evicts its own LRU
    entries, since it owns the index state a drop must clean up."""

    def __init__(self, capacity_tokens: int, block_size: int) -> None:
        if capacity_tokens < 1:
            raise ValueError(
                f"host tier capacity must be >= 1 token, got {capacity_tokens}")
        self.capacity_tokens = int(capacity_tokens)
        self.block_size = int(block_size)
        self._entries: dict[Any, _HostEntry] = {}
        self._tick = 0

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def room(self, tokens: int) -> bool:
        return self.tokens_used + int(tokens) <= self.capacity_tokens

    def put(self, key, tokens: int, rows: Any = None, *,
            pinned: bool = False) -> bool:
        """Store (or account again) one parcel. An unpinned put respects the
        capacity (False: no room); a pinned one always lands."""
        if not pinned and not self.room(tokens):
            return False
        self._entries[key] = _HostEntry(tokens=int(tokens), rows=rows,
                                        tick=self._next_tick(), pinned=pinned)
        return True

    def get(self, key) -> Optional[_HostEntry]:
        entry = self._entries.get(key)
        if entry is not None:
            entry.tick = self._next_tick()
        return entry

    def pop(self, key) -> Optional[_HostEntry]:
        return self._entries.pop(key, None)

    def drop_unpinned(self) -> int:
        """Drop every unpinned entry and return how many; pinned session
        spills stay."""
        dead = [k for k, e in self._entries.items() if not e.pinned]
        for k in dead:
            del self._entries[k]
        return len(dead)

    def lru_unpinned(self) -> Optional[Any]:
        """The least recently used unpinned key, or None."""
        victims = [(e.tick, k) for k, e in self._entries.items() if not e.pinned]
        return min(victims, key=lambda v: v[0])[1] if victims else None

    @property
    def tokens_used(self) -> int:
        return sum(e.tokens for e in self._entries.values())

    @property
    def blocks_used(self) -> int:
        return sum(-(-e.tokens // self.block_size) for e in self._entries.values())

    @property
    def entries(self) -> int:
        return len(self._entries)

    def occupancy(self) -> float:
        return round(self.tokens_used / self.capacity_tokens, 4)

    def stats(self) -> dict:
        return {
            "capacity_tokens": self.capacity_tokens,
            "tokens_used": self.tokens_used,
            "blocks_used": self.blocks_used,
            "entries": self.entries,
            "occupancy": self.occupancy(),
        }


# ----- the shared-prefix tier --------------------------------------------------


@dataclass(eq=False)  # identity: segments key the host tier
class _TierSegment:
    """One cached prefix: rows ``[0, length)`` live in ``blocks`` (the last
    one perhaps partly covered). ``refs`` counts in-flight hit pins,
    ``tick`` is the LRU clock, ``nodes`` the radix entries pointing here.
    ``host=True``: demoted, its rows in the :class:`HostKVTier`, no blocks,
    its radix entries kept so that a later hit can promote it."""

    blocks: list
    length: int
    refs: int = 0
    tick: int = 0
    nodes: list = field(default_factory=list)
    host: bool = False


# A tier's hit: ``length`` prefix tokens in ``segment.blocks``.
TierHit = PrefixHit


class PagedPrefixTier(RadixStore):
    """The radix prefix store of :mod:`.prefix_cache` as a tier of one
    :class:`KVPool`: segments are pool block lists, hit admissions share
    the fully covered blocks with their own tables (a partly covered
    boundary block is copied on write by the admission scatter), and
    eviction returns blocks to the free list decode grows from, so the
    cache and decode split one memory budget. Inserts skip under pool
    pressure rather than take a live lane's blocks.

    With a :class:`HostKVTier`, pool pressure demotes the LRU unpinned
    segment to host RAM (a block gather and a copy into pinned memory) in
    place of dropping it, and a later hit promotes it back: fresh blocks,
    an upload, the restore scatter, every row verbatim. The server drains
    this tier before it preempts a lane. Every move writes the pool in
    place."""

    def __init__(self, pool: KVPool, cfg: DecoderConfig, buckets: tuple, *,
                 host_tier: Optional[HostKVTier] = None, label: str = "",
                 on_demote=None, on_prefetch=None) -> None:
        super().__init__(buckets, label)
        # The server's metric counters of tier traffic, called per move.
        self._on_demote, self._on_prefetch = on_demote, on_prefetch
        self.pool = pool
        self.cfg = cfg
        self.kv_quant = pool.kv_quant
        self.dtype = pool.dtype
        self.host_tier = host_tier
        self.demotions = 0
        self.prefetches = 0
        self.host_evictions = 0
        self.prefetch_stalls = 0

    def _resident(self, seg: _TierSegment) -> bool:
        """A demoted segment is promoted first; when the pool cannot hold
        it now, the lookup is a miss and the segment stays on the host."""
        if not seg.host or self._promote(seg):
            return True
        self.prefetch_stalls += 1
        return False

    def shared_blocks(self, hit: TierHit) -> list:
        """The segment's blocks the match covers fully: those an admitted
        table may reference read-only (the caller takes the pool
        references). A partly covered boundary block is never shared."""
        return list(hit.segment.blocks[: hit.length // self.pool.block_size])

    def _store_rows(self, caches, row: int, bound: int) -> Optional[_TierSegment]:
        """Rows ``[0, bound)`` of cache row ``row`` into tier-owned blocks;
        unpinned segments give way first, live lanes never."""
        bs = self.pool.block_size
        nb = -(-bound // bs)
        blocks = self.pool.try_alloc(nb)
        while blocks is None:
            if not self.evict_one():
                return None
            blocks = self.pool.try_alloc(nb)
        pool_write_seq(self.pool.arena, caches, row,
                       table_tensor(blocks, self.pool.device), bs)
        return _TierSegment(blocks, bound)

    def evict_one(self) -> bool:
        """Relieve the pool by one segment: demote the LRU unpinned
        device-resident segment to the host tier, or, without one or when
        the host budget cannot take it, drop it. False when every
        device-resident segment is pinned."""
        victims = [s for s in self._segments if s.refs == 0 and not s.host]
        if not victims:
            return False
        seg = min(victims, key=lambda s: s.tick)
        if self.host_tier is not None and self._demote(seg):
            return True
        self._drop(seg)
        self.pool.unref(seg.blocks)
        self.evictions += 1
        obs.emit("serving", "prefix_evict", store=self.label,
                 tokens=seg.length, blocks=len(seg.blocks),
                 segments_left=len(self._segments), tier="kv_pool")
        return True

    def _demote(self, seg: _TierSegment) -> bool:
        """Park ``seg`` in the host tier: make room there (dropping its own
        LRU demoted segments first), gather the segment's block rows and
        copy them into pinned host memory on the current stream, free the
        blocks. Decode never writes a tier block, so the copy needs no
        fence: whatever reuses the blocks later is ordered behind it on the
        stream. The radix entries stay."""
        while not self.host_tier.room(seg.length):
            if not self._evict_host_one():
                return False
        rows = rows_to_host(pool_gather_rows(
            self.pool.arena, table_tensor(seg.blocks, self.pool.device),
            self.pool.block_size))
        self.host_tier.put(seg, seg.length, rows=rows)
        self.pool.unref(seg.blocks)
        nb = len(seg.blocks)
        seg.blocks = []
        seg.host = True
        seg.tick = self._next_tick()
        self.demotions += 1
        if self._on_demote is not None:
            self._on_demote()
        obs.emit("serving", "kv_demote", store=self.label, tokens=seg.length,
                 blocks=nb, host_tokens=self.host_tier.tokens_used,
                 host_entries=self.host_tier.entries)
        return True

    def _promote(self, seg: _TierSegment) -> bool:
        """Bring a demoted segment back into fresh blocks (making room by
        evicting or demoting colder segments), upload its rows on the
        current stream and scatter them verbatim. False when the pool
        cannot hold it now; the segment stays on the host."""
        entry = self.host_tier.get(seg)
        if entry is None or entry.rows is None:
            # A host flag without a host entry: drop the segment, a miss.
            if seg in self._segments:
                self._drop(seg)
            return False
        bs = self.pool.block_size
        nb = -(-seg.length // bs)
        # Pinned while blocks are found: a demotion the pressure loop makes
        # must not drop this entry to make room for itself.
        entry.pinned = True
        try:
            blocks = self.pool.try_alloc(nb)
            while blocks is None:
                if not self.evict_one():
                    return False
                blocks = self.pool.try_alloc(nb)
        finally:
            entry.pinned = False
        self.host_tier.pop(seg)
        pool_scatter_rows(self.pool.arena,
                          rows_to_device(entry.rows, self.pool.device),
                          table_tensor(blocks, self.pool.device), bs)
        seg.blocks = blocks
        seg.host = False
        seg.tick = self._next_tick()
        self.prefetches += 1
        if self._on_prefetch is not None:
            self._on_prefetch()
        obs.emit("serving", "kv_prefetch", store=self.label, tokens=seg.length,
                 blocks=nb, host_tokens=self.host_tier.tokens_used)
        return True

    def _evict_host_one(self) -> bool:
        """Drop the host tier's LRU unpinned entry when it is one of this
        tier's segments (session spills are pinned), radix entries and
        all."""
        key = self.host_tier.lru_unpinned()
        if not isinstance(key, _TierSegment):
            return False
        self.host_tier.pop(key)
        self._drop(key)
        self.host_evictions += 1
        obs.emit("serving", "prefix_evict", store=self.label,
                 tokens=key.length, blocks=0,
                 segments_left=len(self._segments), tier="kv_host")
        return True

    def materialize(self, hit: TierHit, max_len: int, n: int = 1):
        """A fresh ``[L, n, max_len, ...]`` cache pair with the hit's prefix
        rows in every row at ``[0, hit.length)``."""
        bs = self.pool.block_size
        nb = -(-hit.length // bs)
        table = table_tensor(hit.segment.blocks[:nb], self.pool.device)
        return pool_materialize(self.pool.arena, table, hit.length, self.cfg,
                                max_len, self.kv_quant, self.dtype, n, bs)

    @property
    def tokens_used(self) -> int:
        """Device-resident tier tokens (demoted ones count in the host
        tier)."""
        return sum(s.length for s in self._segments if not s.host)

    @property
    def blocks_used(self) -> int:
        """Pool blocks the tier's segments hold a reference on (some may
        also sit in lane tables)."""
        return sum(len(s.blocks) for s in self._segments)

    def occupancy(self) -> float:
        """Tier fill as a share of the whole pool, the budget it lives in."""
        return round(self.tokens_used / max(1, self.pool.capacity_tokens), 4)

    def stats(self) -> dict:
        return {
            "capacity_tokens": self.pool.capacity_tokens,
            "tokens_used": self.tokens_used,
            "occupancy": self.occupancy(),
            **self._counters(),
            "demotions": self.demotions,
            "prefetches": self.prefetches,
            "host_evictions": self.host_evictions,
            "prefetch_stalls": self.prefetch_stalls,
            "host_segments": sum(1 for s in self._segments if s.host),
        }
