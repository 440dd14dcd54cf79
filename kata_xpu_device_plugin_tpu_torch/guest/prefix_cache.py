"""Shared-prefix KV cache: a device-resident prefix store with a host-side
radix (token-trie) index (counterpart of
``kata_xpu_device_plugin_tpu/guest/prefix_cache.py``).

Serving traffic is dominated by prompts that share a long common prefix:
the system prompt, a few-shot template, a conversation header. Cold
admission prefills that prefix again for every request. The store keeps
prefix KV on the device, indexed by token ids, so that a hit prefills only
the suffix (``models.transformer.prefill_suffix``):

- **Device side**: one KV arena of ``capacity_tokens`` rows per layer, the
  leaf layout of a one-slot serving cache (``[L, 1, cap, KV, D]``, bf16 or
  int8 :class:`..ops.quant.QTensor` pairs). Segments are contiguous token
  ranges in it; every copy in and out is a device-to-device torch copy.
- **Host side**: a :class:`RadixIndex` (path-compressed token trie) maps
  token prefixes to segments, with pins (a segment an in-flight request
  holds is never evicted) and LRU eviction of unpinned segments.

Every cached boundary is a ``prefill_buckets`` value: insertion registers
an entry at each bucket boundary of the stored prefix, and
:meth:`PrefixStore.lookup` returns the longest bucket-aligned match, capped
at ``len(prompt) - 1`` so that at least one suffix token remains to give
the first token's logits. A stored segment covers only real prompt tokens,
never bucket padding.

The paged server keeps the same index inside its block pool instead
(:class:`.kv_arena.PagedPrefixTier`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .. import obs, resolve_device
from ..models.transformer import DecoderConfig, init_kv_caches
from ..ops.quant import QTensor

# ----- radix index -----------------------------------------------------------


class _Node:
    """One radix-tree node. ``edges`` maps a first token to ``(label,
    child)``, ``label`` the compressed edge's whole token array; ``entry``
    is the value registered at exactly this node's depth (None for
    structural nodes)."""

    __slots__ = ("edges", "entry", "depth", "parent", "pkey")

    def __init__(self, depth: int, parent: Optional["_Node"], pkey: int = -1):
        self.edges: dict[int, tuple[np.ndarray, _Node]] = {}
        self.entry: Any = None
        self.depth = depth
        self.parent = parent
        self.pkey = pkey  # first token of the edge leading here (prune key)


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class RadixIndex:
    """Path-compressed token trie mapping exact-length token prefixes to
    opaque values; host code over numpy int arrays."""

    def __init__(self) -> None:
        self._root = _Node(0, None)
        self._entries = 0

    def __len__(self) -> int:
        return self._entries

    def longest_match(self, tokens: np.ndarray) -> tuple[int, Any]:
        """The deepest registered entry along ``tokens`` (an entry counts
        only when its whole depth matches): ``(depth, value)``, or ``(0,
        None)`` when nothing matches."""
        tokens = np.asarray(tokens)
        node, i = self._root, 0
        best: tuple[int, Any] = (0, None)
        while i < len(tokens):
            edge = node.edges.get(int(tokens[i]))
            if edge is None:
                break
            label, child = edge
            m = _common_len(label, tokens[i:])
            if m < len(label):
                break  # diverged mid-edge: the child's depth is not reached
            node, i = child, i + m
            if node.entry is not None:
                best = (node.depth, node.entry)
        return best

    def insert(self, tokens: np.ndarray, value: Any) -> _Node:
        """Register ``value`` at exactly ``len(tokens)`` and return the node
        (the handle :meth:`remove` takes). An entry already at that depth
        stays: the first writer wins."""
        tokens = np.asarray(tokens, np.int32)
        node, i = self._root, 0
        while i < len(tokens):
            t = int(tokens[i])
            edge = node.edges.get(t)
            if edge is None:
                child = _Node(len(tokens), node, t)
                node.edges[t] = (tokens[i:].copy(), child)
                node, i = child, len(tokens)
                break
            label, child = edge
            m = _common_len(label, tokens[i:])
            if m == len(label):
                node, i = child, i + m
                continue
            # Split the edge where it diverges (node.depth == i at every
            # loop head: the walk only advances over whole labels).
            mid = _Node(i + m, node, t)
            node.edges[t] = (label[:m], mid)
            mid.edges[int(label[m])] = (label[m:], child)
            child.parent, child.pkey = mid, int(label[m])
            node, i = mid, i + m
        if node.entry is None and value is not None:
            node.entry = value
            self._entries += 1
        return node

    def remove(self, node: _Node) -> None:
        """Clear ``node``'s entry and prune the structural nodes that are
        left without entry or children, up the parent chain."""
        if node.entry is not None:
            node.entry = None
            self._entries -= 1
        while node.parent is not None and node.entry is None and not node.edges:
            parent = node.parent
            parent.edges.pop(node.pkey, None)
            node = parent


# ----- arena allocation ------------------------------------------------------


class _FreeList:
    """First-fit allocator over one token range; ``free`` coalesces
    neighbours, so eviction churn cannot fragment the arena for good."""

    def __init__(self, capacity: int) -> None:
        self._free: list[tuple[int, int]] = [(0, capacity)] if capacity else []

    def alloc(self, n: int) -> Optional[int]:
        for i, (off, size) in enumerate(self._free):
            if size >= n:
                if size == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + n, size - n)
                return off
        return None

    def free(self, off: int, n: int) -> None:
        self._free.append((off, n))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for o, s in self._free:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((o, s))
        self._free = merged


@dataclass
class _Segment:
    """One contiguous prefix's KV rows in the store arena. ``refs`` counts
    the in-flight requests pinning it; ``tick`` is the LRU clock; ``nodes``
    are the radix entries (one a bucket boundary) pointing into it."""

    offset: int
    length: int
    refs: int = 0
    tick: int = 0
    nodes: list = field(default_factory=list)


@dataclass(frozen=True)
class PrefixHit:
    """A pinned lookup: ``length`` prefix tokens of ``segment`` (a store
    arena range or a tier block list). Held for the request's life and
    released once."""

    segment: Any
    length: int


def cache_leaves(caches) -> list:
    """The tensors of a cache pair ``(k, v)``, QTensor payloads and scales
    alike, in a fixed order; of a cycle arena's tuple of pairs, pair by
    pair."""
    out = []
    for c in caches:
        if isinstance(c, QTensor):
            out.extend(c)
        elif isinstance(c, tuple):
            out.extend(cache_leaves(c))
        else:
            out.append(c)
    return out


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for t in cache_leaves(caches))


# ----- the stores --------------------------------------------------------------


class RadixStore:
    """What both prefix stores share: the radix index of bucket-aligned
    prefixes over segments, pins, the LRU clock, the lookup counters and
    the insert rules. A subclass keeps the rows: :meth:`_store_rows` puts a
    new segment's rows somewhere (or finds no room), :meth:`_resident`
    says whether a matched segment can serve now. Not thread-safe: share
    a store only between servers driven from one thread."""

    def __init__(self, buckets: tuple, label: str = "") -> None:
        self.label = label  # the owning server's, on this store's events
        buckets = tuple(sorted(buckets))
        if not buckets:
            raise ValueError(
                f"{type(self).__name__} needs a prefill_buckets ladder: "
                "matches are bucket-aligned")
        self.buckets = buckets
        self._index = RadixIndex()
        self._segments: list = []
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        self.inserts = 0
        self.insert_skips = 0  # no room with every segment pinned

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _resident(self, seg) -> bool:
        return True

    def lookup(self, prompt: np.ndarray) -> Optional[PrefixHit]:
        """The longest bucket-aligned cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` (one suffix token must remain to give the first
        token's logits), pinned; None on a miss (counted). The caller owns
        exactly one :meth:`release` of a hit."""
        prompt = np.asarray(prompt)
        depth, seg = self._index.longest_match(prompt[: len(prompt) - 1])
        if seg is None or not self._resident(seg):
            self.misses += 1
            return None
        seg.refs += 1
        seg.tick = self._next_tick()
        self.hits += 1
        self.tokens_reused += depth
        return PrefixHit(seg, depth)

    def release(self, hit: PrefixHit) -> None:
        hit.segment.refs -= 1
        assert hit.segment.refs >= 0, "prefix hit released twice"

    def cancel(self, hit: PrefixHit) -> None:
        """Release a hit that was never used (the request went cold) and
        turn its lookup into a miss."""
        self.release(hit)
        self.hits -= 1
        self.tokens_reused -= hit.length
        self.misses += 1

    def unlookup(self, hit: Optional[PrefixHit]) -> None:
        """Reverse one :meth:`lookup` wholly, counters and pin: the request
        stays queued (a paged reservation failed) and looks up again when
        it is offered again, so retries count nothing."""
        if hit is not None:
            self.cancel(hit)
        self.misses -= 1

    def insert(self, prompt: np.ndarray, caches: Any, row: int) -> bool:
        """Store ``prompt``'s longest bucket-aligned proper prefix from row
        ``row`` of a freshly prefilled cache pair (leaves ``[L, N, S,
        ...]``), registering an entry at every bucket boundary of it. True
        when a segment was stored. A prefix stored already only repairs
        its boundaries; with no room the insert is skipped, never an
        error."""
        prompt = np.asarray(prompt, np.int32)
        bound = next((b for b in reversed(self.buckets) if b <= len(prompt) - 1),
                     None)
        if bound is None:
            return False  # shorter than every bucket: nothing to key
        have, have_seg = self._index.longest_match(prompt[:bound])
        if have >= bound:
            self._register(prompt, have_seg, bound)
            return False
        seg = self._store_rows(caches, row, bound)
        if seg is None:
            self.insert_skips += 1
            return False
        seg.tick = self._next_tick()
        self._register(prompt, seg, bound)
        self._segments.append(seg)
        self.inserts += 1
        return True

    def _register(self, prompt: np.ndarray, seg, upto: int) -> None:
        """Point every bucket boundary ``<= upto`` of ``prompt`` that has no
        entry yet at ``seg``, whose rows cover it. Boundaries an existing
        segment serves are left alone; this also repairs a shallow
        boundary lost when its own segment was evicted while a deeper one
        survived."""
        for b in self.buckets:
            if b > upto or b > seg.length:
                break
            depth, _ = self._index.longest_match(prompt[:b])
            if depth < b:
                seg.nodes.append(self._index.insert(prompt[:b], seg))

    def _drop(self, seg) -> None:
        for node in seg.nodes:
            self._index.remove(node)
        self._segments.remove(seg)

    def _counters(self) -> dict:
        return {
            "segments": len(self._segments),
            "entries": len(self._index),
            "hits": self.hits,
            "misses": self.misses,
            "tokens_reused": self.tokens_reused,
            "inserts": self.inserts,
            "insert_skips": self.insert_skips,
            "evictions": self.evictions,
        }


class PrefixStore(RadixStore):
    """Device-resident prefix KV store: segments are contiguous token ranges
    of one arena.

    >>> store = PrefixStore(cfg, capacity_tokens=4096, buckets=(64, 256))
    >>> srv = GenerationServer(params, cfg, prefill_buckets=(64, 256),
    ...                        prefix_store=store)

    One store may back several slotted servers of one device. ``buckets``
    must equal their ``prefill_buckets``; ``kv_quant=None`` resolves as the
    server does (``KATA_TPU_KV_QUANT``, else int8); ``device`` defaults to
    CUDA. Under capacity pressure unpinned segments evict LRU first."""

    def __init__(self, cfg: DecoderConfig, capacity_tokens: int,
                 buckets: tuple, *, kv_quant: Optional[bool] = None,
                 dtype=None, device=None, label: str = "") -> None:
        super().__init__(buckets, label)
        if capacity_tokens < self.buckets[0]:
            raise ValueError(
                f"capacity_tokens={capacity_tokens} cannot hold even the "
                f"smallest bucket ({self.buckets[0]})")
        from .serving import resolve_kv_quant  # serving imports this module

        self.cfg = cfg
        self.capacity_tokens = int(capacity_tokens)
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.dtype = dtype or cfg.dtype
        self.device = resolve_device(device)
        self.arena = init_kv_caches(cfg, 1, self.capacity_tokens,
                                    device=self.device, dtype=self.dtype,
                                    quantized=self.kv_quant)
        self._freelist = _FreeList(self.capacity_tokens)

    def _store_rows(self, caches, row: int, bound: int) -> Optional[_Segment]:
        offset = self._freelist.alloc(bound)
        while offset is None:
            if not self._evict_one():
                return None
            offset = self._freelist.alloc(bound)
        for s, c in zip(cache_leaves(self.arena), cache_leaves(caches)):
            s[:, 0, offset:offset + bound] = c[:, row, :bound]
        return _Segment(offset, bound)

    def _evict_one(self) -> bool:
        """Drop the least recently used unpinned segment; False when every
        segment is pinned."""
        victims = [s for s in self._segments if s.refs == 0]
        if not victims:
            return False
        seg = min(victims, key=lambda s: s.tick)
        self._drop(seg)
        self._freelist.free(seg.offset, seg.length)
        self.evictions += 1
        obs.emit("serving", "prefix_evict", store=self.label,
                 tokens=seg.length, offset=seg.offset,
                 segments_left=len(self._segments))
        return True

    def materialize(self, hit: PrefixHit, max_len: int, n: int = 1):
        """A fresh ``[L, n, max_len, ...]`` cache pair with the hit's prefix
        rows in every row at positions ``[0, hit.length)``, what
        ``prefill_suffix`` resumes from at ``offset=hit.length``; ``n > 1``
        fans one prefix out to a same-match admission group."""
        caches = init_kv_caches(self.cfg, n, max_len, device=self.device,
                                dtype=self.dtype, quantized=self.kv_quant)
        off, m = hit.segment.offset, hit.length
        for c, s in zip(cache_leaves(caches), cache_leaves(self.arena)):
            c[:, :, :m] = s[:, :, off:off + m]
        return caches

    @property
    def tokens_used(self) -> int:
        return sum(s.length for s in self._segments)

    def occupancy(self) -> float:
        return round(self.tokens_used / self.capacity_tokens, 4)

    def stats(self) -> dict:
        """Cumulative counters and occupancy (a snapshot; resets nothing)."""
        return {"capacity_tokens": self.capacity_tokens,
                "tokens_used": self.tokens_used,
                "occupancy": self.occupancy(), **self._counters()}
