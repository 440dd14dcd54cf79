"""Ulysses sequence parallelism: all-to-all head-parallel attention
(counterpart of ``kata_xpu_device_plugin_tpu/parallel/ulysses.py``).

Where the ring keeps queries in place and moves K/V blocks around, Ulysses
reshuffles once: an all-to-all turns the sequence-cut ``[B, S/n, H, D]``
shards into head-cut ``[B, S, H/n, D]`` ones, each shard runs
full-sequence attention over its head group (the flash kernels apply
directly: it is plain self-attention), and the reverse all-to-all restores
the sequence cut. Every shard sits on the mesh's one device (:mod:`.mesh`),
so the all-to-alls are reshuffles of per-shard tensors
(:func:`..ops.collectives.all_to_all`).

GQA: when the KV heads divide the degree, k and v are reshuffled like q;
when the degree is a multiple of the KV heads, every shard takes the one
KV head its query heads map to, from the gathered sequence; otherwise it
raises, as JAX does.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..ops import collectives
from .mesh import AXIS_SEQ, Mesh


def _seq_to_heads(parts: list) -> list:
    """``[B, S_loc, H, D]`` shards -> ``[B, S, H_loc, D]`` shards: each
    shard's heads cut across the group, the sequence concatenated."""
    return collectives.all_to_all(parts, split_dim=2, concat_dim=1)


def _heads_to_seq(parts: list) -> list:
    return collectives.all_to_all(parts, split_dim=1, concat_dim=2)


def make_ulysses_attention(mesh: Mesh, axis: str = AXIS_SEQ,
                           attn_fn: Optional[Callable] = None):
    """Returns ``ulysses_attn(q, k, v)`` on GLOBAL ``[B, S, H, D]`` tensors
    cut over ``axis`` in S (a drop-in ``attn_fn``, like
    :func:`.ring.make_ring_attention`). ``attn_fn`` runs each head group's
    full-sequence attention and defaults to
    :func:`..ops.attention.flash_attention` (the flash kernels on the card,
    the plain version on the CPU)."""
    if attn_fn is None:
        from ..ops.attention import flash_attention

        attn_fn = flash_attention
    n = mesh.shape[axis]

    def ulysses_attn(q, k, v, causal: bool = True, q_offset=None,
                     window: int = 0, logits_softcap: float = 0.0):
        if not causal or q_offset is not None:
            raise ValueError("ulysses attention supports causal self-attention only")
        B, S, H, D = q.shape
        KV = k.shape[2]
        if H % n:
            raise ValueError(f"Ulysses needs n_heads % sp == 0, got H={H}, sp={n}")
        if S % n:
            raise ValueError(f"sequence length {S} does not divide into {n} "
                             f"{axis} shards")
        qh = _seq_to_heads(list(q.chunk(n, dim=1)))
        if KV % n == 0:
            kh = _seq_to_heads(list(k.chunk(n, dim=1)))
            vh = _seq_to_heads(list(v.chunk(n, dim=1)))
        elif n % KV == 0:
            # Few KV heads, several shards a KV head: each shard takes the
            # one KV head its query-head group maps to, whole sequence (the
            # all-gather of the sequence shards is k and v themselves on
            # one device).
            group, h_loc = H // KV, H // n
            starts = [i * h_loc // group for i in range(n)]
            kh = [k[:, :, s:s + 1] for s in starts]
            vh = [v[:, :, s:s + 1] for s in starts]
        else:
            raise ValueError(
                f"Ulysses sp degree {n} must divide n_kv_heads={KV} or be a "
                "multiple of it (ring attention has no such constraint)")
        kw = {}
        if window:
            kw["window"] = window
        if logits_softcap:
            kw["logits_softcap"] = logits_softcap
        outs = [attn_fn(a, b, c, causal=True, q_offset=None, **kw)
                for a, b, c in zip(qh, kh, vh)]
        return collectives.all_gather(_heads_to_seq(outs), dim=1)

    return ulysses_attn
