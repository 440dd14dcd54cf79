"""Ring attention: sequence parallelism over a mesh's ``seq`` axis
(counterpart of ``kata_xpu_device_plugin_tpu/parallel/ring.py``).

The sequence is cut into n shards of ``S_loc`` rows. Shard ``idx`` keeps
its queries and meets every key/value block in turn: at hop ``t`` it holds
the block that started on shard ``(idx - t) mod n`` (the neighbour hop,
:func:`..ops.collectives.ppermute`), and a running ``(m, l, acc)`` online
softmax in fp32 merges the blocks. Causal masking is judged on GLOBAL
positions. Every shard lives on the mesh's one device
(:mod:`.mesh`), so a hop rotates a list of views and moves no bytes.

Each live block pair goes either through the K1 block kernels
(:func:`..ops.flash.flash_block_attention`: the pair's output and
logsumexp, merged here in fp32 torch ops; on the CPU their plain
versions) or through the einsum online softmax, the JAX package's XLA path
and numerics oracle. Pairs wholly above the causal frontier (``src >
idx``) are skipped on both paths, with no launch: JAX's flash path skips
them, and on its einsum path they add exactly zero. With a window the
hops stop at ``t_last = min(n - 1, (S_loc + window - 2) // S_loc)``, past
which no block reaches a query's band.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import collectives, flash
from ..ops.attention import NEG_INF
from .mesh import AXIS_SEQ, Mesh


def _ring_hops(n: int, S: int, window: int) -> int:
    """The last hop a shard takes (JAX ``t_last``)."""
    return min(n - 1, (S + window - 2) // S) if window > 0 else n - 1


def _merge_block(state, out_blk, lse):
    """One block's ``(out [B, S, H, D], lse [B, S, H])`` into the running
    ``(m, l, acc)`` (JAX ``accumulate_flash``): m and l ``[B, H, S, 1]``,
    acc fp32 ``[B, S, H, D]``, the block's output taken to fp32 first. A
    shard's first block starts the state as the merge into the empty one
    would (m = lse, l = 1, acc = out: exp(NEG_INF - lse) = 0 and exp(0) =
    1), without the fp32 zeros."""
    lse = lse.transpose(1, 2)[..., None]
    if state is None:
        return lse, torch.ones_like(lse), out_blk.float()
    m, l, acc = state
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(m - m_new)  # rescale of the running sum
    beta = torch.exp(lse - m_new)  # weight of this block's partial
    return (m_new, l * alpha + beta,
            acc * alpha.transpose(1, 2) + out_blk.float() * beta.transpose(1, 2))


def _einsum_block(state, q, k_blk, v_blk, q0, k0, softcap, window):
    """One block by the einsum online softmax (JAX ``accumulate``), k/v
    expanded to q's heads, everything in fp32."""
    B, S, H, D = q.shape
    if state is None:
        state = (torch.full((B, H, S, 1), NEG_INF, device=q.device),
                 torch.zeros((B, H, S, 1), device=q.device),
                 torch.zeros((B, S, H, D), device=q.device))
    m, l, acc = state
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float())
    logits = logits * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    q_pos = q0 + torch.arange(S, device=q.device)
    k_pos = k0 + torch.arange(S, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m_cur = logits.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr.transpose(1, 2) + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk.float())
    return m_new, l, acc


def _local_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n: int, use_flash: bool = False, softcap: float = 0.0,
                          window: int = 0) -> torch.Tensor:
    """The causal ring over ``n`` shards of the global q ``[B, S, H, D]``
    and k/v ``[B, S, KV, D]`` (JAX ``_local_ring_attention``, which runs
    inside ``shard_map``; here every shard's program runs in turn on one
    device, hop by hop). Returns ``[B, S, H, D]`` in q's dtype."""
    B, S_all, H, D = q.shape
    S = S_all // n
    if not use_flash:
        G = H // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qs = list(q.split(S, dim=1))
    k_blks, v_blks = list(k.split(S, dim=1)), list(v.split(S, dim=1))
    t_last = _ring_hops(n, S, window)
    states = [None] * n
    for t in range(t_last + 1):
        if t:  # the hop: block j moves on to shard j + 1
            k_blks = collectives.ppermute(k_blks)
            v_blks = collectives.ppermute(v_blks)
        for idx in range(n):
            src = (idx - t) % n
            if src > idx:
                continue  # wholly above the frontier: no launch at all
            if use_flash:
                out_blk, lse = flash.flash_block_attention(
                    qs[idx], k_blks[idx], v_blks[idx], q_offset=idx * S,
                    k_offset=src * S, softcap=softcap, window=window)
                states[idx] = _merge_block(states[idx], out_blk, lse)
            else:
                states[idx] = _einsum_block(
                    states[idx], qs[idx], k_blks[idx], v_blks[idx], idx * S,
                    src * S, softcap, window)
    outs = []
    for _, l, acc in states:
        denom = torch.where(l == 0.0, torch.ones_like(l), l).transpose(1, 2)
        outs.append((acc / denom).to(q.dtype))
    return collectives.all_gather(outs, dim=1)


def make_ring_attention(mesh: Mesh, axis: str = AXIS_SEQ,
                        use_flash: Optional[bool] = None, batch_axes=None,
                        head_axis: Optional[str] = None,
                        kv_head_axis: Optional[str] = None):
    """Returns ``ring_attn(q, k, v)`` on GLOBAL ``[B, S, H, D]`` tensors cut
    over ``axis`` in S: a drop-in ``attn_fn`` for the sequence-parallel
    model. ``use_flash=None`` takes the K1 block kernels on a CUDA tensor,
    as JAX takes its Pallas kernel on a TPU, and raises ``ValueError`` where
    the shard shapes have none (``ops.flash.supports(S_loc, S_loc, D)``
    fails): on the card the kernels run or the call fails. On a CPU tensor
    it, and ``use_flash=False`` anywhere, takes the einsum path (the plain
    reference). ``use_flash=True`` on the CPU runs the block path with the
    kernels' plain versions. JAX's ``flash_interpret`` (Pallas interpret
    mode) has no counterpart.

    ``batch_axes`` cuts the batch over those mesh axes and ``head_axis`` /
    ``kv_head_axis`` the query / KV heads (a seq x fsdp x model mesh): each
    (batch shard, head shard) block runs a ring of its own, as each group
    of devices sharing those coordinates does under JAX's ``shard_map``."""
    from .flash_spmd import _count, join

    n = mesh.shape[axis]
    nb = _count(mesh, batch_axes)
    nh, nkv = _count(mesh, head_axis), _count(mesh, kv_head_axis)
    if nh != nkv:
        raise ValueError(f"query heads cut {nh} ways but KV heads {nkv}")

    def ring_attn(q, k, v, causal: bool = True, q_offset=None, window: int = 0,
                  logits_softcap: float = 0.0):
        if not causal or q_offset is not None:
            raise ValueError("ring attention supports causal self-attention only")
        B, S, H, D = q.shape
        if S % n:
            raise ValueError(f"sequence length {S} does not divide into {n} "
                             f"{axis} shards")
        if B % nb or H % nh or k.shape[2] % nkv:
            raise ValueError(f"q {tuple(q.shape)} / kv heads {k.shape[2]} do "
                             f"not divide over {nb} batch and {nh} head shards")
        engage = q.is_cuda if use_flash is None else use_flash
        if engage and q.is_cuda and not flash.supports(S // n, S // n, D):
            raise ValueError(f"no flash block kernel for {axis} shards of "
                             f"S_loc={S // n}, head_dim={D}")
        rows = []
        for qb, kb, vb in zip(q.chunk(nb, 0), k.chunk(nb, 0), v.chunk(nb, 0)):
            rows.append(join(
                [_local_ring_attention(qh, kh, vh, n, use_flash=engage,
                                       softcap=float(logits_softcap),
                                       window=int(window))
                 for qh, kh, vh in zip(qb.chunk(nh, 2), kb.chunk(nh, 2),
                                       vb.chunk(nh, 2))], 2))
        return join(rows, 0)

    return ring_attn
