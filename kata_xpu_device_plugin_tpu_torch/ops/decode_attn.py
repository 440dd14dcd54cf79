"""Decode attention: the CUDA kernels ``csrc/paged_decode.cu`` and
``csrc/dense_decode.cu`` with their plain versions (counterparts of the two
kernels in ``kata_xpu_device_plugin_tpu/ops/decode_attn.py``).

Both kernels are one split-K design in two passes (``csrc/decode_split.cuh``):
a lane's KV tiles are cut into chunks of :func:`decode_chunks` tiles that
run in parallel, each writing unnormalised partials ``(acc, m, l)`` in fp32
to scratch the wrapper allocates, and a combine pass merges a row's live
chunks in ascending order. :func:`paged_decode_split_reference` is the CPU
model of those two passes.

**Paged** (:func:`paged_decode_attention`): each lane's queries attend its
block-table view of a shared pool ``[1, NT, KV, D]`` (bf16, or an int8
:class:`.quant.QTensor` with fp32 scales ``[1, NT, KV, 1]`` dequantized
inside the kernel). A paged server hands it the pool and the lanes' real
tables; the slotted arena reaches it through
:func:`.attention.make_decode_attn_fn`'s zero-copy re-view. ``SQ > 1``
carries a right-aligned span per lane with per-lane query lengths. The
shard-local form (:func:`paged_decode_shard_stats`, the TPU kernel's
``shard_lo``/``shard_blocks`` with ``return_stats``) runs over one shard's
slice of a block-sharded pool, visits only the tiles that shard holds and
returns the fp32 statistics ``(acc, m, l)`` undivided, which
:func:`.attention.merge_shard_stats` merges across shards. Pools
may be views of some KV heads of a wider pool (a head-sharded pool): the
kernel reads them through their row stride.

**Dense** (:func:`decode_attention`): one token per row into a dense bf16
cache ``[B, S, KV, D]`` with one position shared by the batch, the
lock-step decode of ``generate`` under ``KATA_TPU_DECODE_KERNEL=1``.
"""
from __future__ import annotations

import ctypes

import torch

from .attention import NEG_INF, reference_attention
from .quant import QTensor, dequantize_kv

KERNEL_HEAD_DIMS = (64, 128, 256)
# Query heads per KV head: the G heads are the M rows of one m16 tile.
KERNEL_GROUPS = (1, 2, 3, 4, 5, 6, 7, 8)
# The query row is the split pass's z and the combine pass's y dimension.
KERNEL_MAX_SQ = 65535
DENSE_BLOCK_K = 128
# Keys a split-K chunk holds at least: a chunk is ceil(CHUNK_KEYS / bs)
# whole KV tiles, so the partition depends on the tile alone.
CHUNK_KEYS = 128
# The kernels index pool rows (times KV) in 32 bits.
_MAX_ROWS = 2 ** 31


def supports_paged_decode(d: int, block_size: int) -> bool:
    """Shape gate, as in the JAX package: head_dim a multiple of 128 or 64,
    the KV tile (one pool block) a positive multiple of 8."""
    return (d % 128 == 0 or d == 64) and block_size >= 8 and block_size % 8 == 0


def supports_decode(sq: int, sk: int, d: int) -> bool:
    """Shape gate of the dense kernel, as in the JAX package: one query
    token, head_dim a multiple of 128 or 64, the cache length a positive
    multiple of the 128-key block."""
    return (sq == 1 and (d % 128 == 0 or d == 64)
            and sk % DENSE_BLOCK_K == 0 and sk >= DENSE_BLOCK_K)


def check_kernel_shapes(d: int, group: int, block_size: int) -> None:
    """The one gate of the paged CUDA kernel: raise unless it takes
    head_dim ``d``, ``group`` query heads per KV head and KV tile
    ``block_size``. The wrapper calls it before every launch; the serving
    decode builder calls it once, so a server the kernel cannot serve fails
    at construction."""
    if (not supports_paged_decode(d, block_size) or d not in KERNEL_HEAD_DIMS
            or group not in KERNEL_GROUPS):
        raise ValueError(
            f"paged decode kernel: head_dim {d} (need {KERNEL_HEAD_DIMS}), "
            f"group {group} (need {KERNEL_GROUPS}), KV tile {block_size} "
            "(need a positive multiple of 8)"
        )


def check_dense_shapes(sq: int, sk: int, d: int, group: int) -> None:
    """The gate of the dense CUDA kernel: raise unless it takes ``sq``
    query tokens, a cache of ``sk`` positions, head_dim ``d`` and ``group``
    query heads per KV head."""
    if (not supports_decode(sq, sk, d) or d not in KERNEL_HEAD_DIMS
            or group not in KERNEL_GROUPS):
        raise ValueError(
            f"dense decode kernel: one query token (got {sq}), cache length a "
            f"multiple of {DENSE_BLOCK_K} (got {sk}), head_dim {d} (need "
            f"{KERNEL_HEAD_DIMS}), group {group} (need {KERNEL_GROUPS})")


def _grid_k(tables: torch.Tensor, block_size: int, paged_len: int) -> int:
    """Splits visible through a lane's view: ``min(NB, ceil(paged_len/bs))``."""
    return min(tables.shape[1], -(-paged_len // block_size))


def decode_chunks(block_size: int, grid_k: int) -> tuple[int, int]:
    """The split-K partition of a lane's ``grid_k`` KV tiles of
    ``block_size`` keys: ``(tiles_per_chunk, n_chunks)``. Chunk ``c`` holds
    tiles ``[c·T, min((c+1)·T, grid_k))`` with ``T = max(1, ceil(128 /
    block_size))``: T depends on the tile alone, so every caller at one
    tile (the dense kernel and the slotted re-view at 128, a paged and a
    slotted server at one tile, a span row and a single-query call) cuts
    the same keys into the same chunks. The kernels take it from here."""
    tiles = max(1, -(-CHUNK_KEYS // block_size))
    return tiles, -(-grid_k // tiles)


def paged_decode_reference(q, k, v, tables, pos, q_lens=None, *,
                           block_size: int, paged_len: int) -> torch.Tensor:
    """The plain version: gather each lane's view out of the pool, dequantize,
    attend with query row ``j`` at ``pos[b] - (SQ-1) + j``. The view spans
    the kernel's ``grid_k`` splits, so a dead lane whose stale ``pos`` lies
    past ``paged_len`` sees the same keys the kernel reads. Padding rows
    (``j < SQ - q_lens[b]``) have every key masked, so their probabilities
    are uniform: they take the mean of V over the whole view (the kernel's
    mean runs over the visited splits only; nothing reads either)."""
    B, SQ = q.shape[:2]
    bs = block_size
    n = _grid_k(tables, bs, paged_len)
    idx = (tables[:, :n].long() * bs)[:, :, None] + torch.arange(
        bs, device=tables.device)
    idx = idx.reshape(B, -1)
    vv = _view(v, idx, q.dtype)
    out = reference_attention(q, _view(k, idx, q.dtype), vv, causal=True,
                              q_offset=pos.to(q.device) - (SQ - 1))
    if q_lens is not None:
        pad = (torch.arange(SQ, device=q.device)[None, :]
               < SQ - q_lens.to(q.device)[:, None])  # [B, SQ]
        G = q.shape[2] // vv.shape[2]
        mean_v = vv.float().mean(dim=1).repeat_interleave(G, dim=1)  # [B, H, D]
        out = torch.where(pad[:, :, None, None], mean_v[:, None].to(out.dtype),
                          out)
    return out


def _view(c, idx, dtype):
    if isinstance(c, QTensor):
        return dequantize_kv(QTensor(c.q[0][idx], c.scale[0][idx]), dtype)
    return c[0][idx]


def _split_partials(q, k, v, tables, pos, q_lens=None, *, block_size: int,
                    paged_len: int, shard_lo: int = 0, shard_blocks: int = 0):
    """The split pass of the kernels, on the CPU: per query row and chunk,
    the unnormalised partials ``acc [B, SQ, H, C, D]``, ``m`` and ``l``
    ``[B, SQ, H, C]`` (fp32), and each row's live chunk count ``[B, SQ]``.
    A row visits its chunk's tiles up to the one holding its last key;
    ``p = exp(s - m_c)`` at the chunk-local max, rounded to the working
    dtype before the P·V product; a padding row has every logit at
    NEG_INF, so ``p = 1`` on each visited key. Shard-local
    (``shard_blocks > 0``): a tile whose table entry lies outside
    ``[shard_lo, shard_lo + shard_blocks)`` is not visited (its keys take
    ``p = 0`` and stay out of ``m``), owned entries index the shard's pool
    at ``table - shard_lo``, and a chunk with no owned tile has ``m =
    NEG_INF``, ``l = 0``, ``acc = 0``."""
    B, SQ, H, D = q.shape
    bs = block_size
    n = _grid_k(tables, bs, paged_len)
    tiles, n_chunks = decode_chunks(bs, n)
    ck = tiles * bs
    blocks = tables[:, :n].long()
    owned = torch.ones_like(blocks, dtype=torch.bool)
    if shard_blocks:
        blocks = blocks - shard_lo
        owned = (blocks >= 0) & (blocks < shard_blocks)
        blocks = torch.where(owned, blocks, torch.zeros_like(blocks))
    idx = ((blocks * bs)[:, :, None]
           + torch.arange(bs, device=tables.device)).reshape(B, -1)
    kk, vv = _view(k, idx, q.dtype), _view(v, idx, q.dtype)  # [B, n·bs, KV, D]
    KV = kk.shape[2]
    G = H // KV
    span = n_chunks * ck
    pad_keys = span - n * bs
    kk = torch.nn.functional.pad(kk, (0, 0, 0, 0, 0, pad_keys))
    vv = torch.nn.functional.pad(vv, (0, 0, 0, 0, 0, pad_keys))
    pos = pos.to(q.device).long()
    rows = torch.arange(SQ, device=q.device)
    q_len = (torch.full_like(pos, SQ) if q_lens is None
             else q_lens.to(q.device).long())
    pad = rows[None, :] < SQ - q_len[:, None]  # [B, SQ]
    last = torch.where(pad, pos[:, None], pos[:, None] - (SQ - 1) + rows[None, :])
    keys = torch.arange(span, device=q.device)
    visited = (keys < n * bs) & (keys[None, None, :]
                                 < ((last.clamp_min(-1) // bs) + 1)[..., None] * bs)
    owned_keys = torch.nn.functional.pad(
        owned.repeat_interleave(bs, dim=1), (0, pad_keys))  # [B, span]
    visited = visited & owned_keys[:, None, :]
    live = visited & ~pad[..., None] & (keys <= last[..., None])  # [B, SQ, K]
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.reshape(B, SQ, KV, G, D).float(),
                     kk.float()) * (1.0 / float(D) ** 0.5)
    s = torch.where(live[:, :, None, None], s, torch.tensor(NEG_INF))
    s = s.reshape(B, SQ, KV, G, n_chunks, ck)
    vis = visited.reshape(B, SQ, 1, 1, n_chunks, ck)
    m = torch.where(vis, s, torch.tensor(NEG_INF)).amax(-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros(()))
    acc = torch.einsum("bqhgck,bckhd->bqhgcd", p.to(vv.dtype).float(),
                       vv.float().reshape(B, n_chunks, ck, KV, D))
    n_live = torch.where(last < 0, torch.zeros_like(last),
                         (last.clamp_min(0) // ck).clamp_max(n_chunks - 1) + 1)
    return (acc.reshape(B, SQ, H, n_chunks, D), m.reshape(B, SQ, H, n_chunks),
            p.sum(-1).reshape(B, SQ, H, n_chunks), n_live)


def _merge_partials(acc, m, l, n_live, dtype, stats_kv: int = 0):
    """The combine pass: over each row's first ``n_live`` chunks,
    ``sum acc·e^(m-M) / sum l·e^(m-M)`` with ``M`` their max, a zero
    denominator replaced by 1, cast to ``dtype``. ``stats_kv > 0`` (the
    pool's KV heads) returns the undivided fp32 ``(sum acc·e^(m-M) [B,
    SQ, H, D], M, sum l·e^(m-M))``, the last two ``[B, KV, SQ·G]``
    (:func:`to_stat_rows`)."""
    n_chunks = m.shape[-1]
    live = (torch.arange(n_chunks, device=m.device)
            < n_live[:, :, None, None])  # [B, SQ, 1, C]
    mx = torch.where(live, m, torch.tensor(NEG_INF)).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), torch.zeros(()))
    den = (l * w).sum(-1, keepdim=True)
    num = (acc * w[..., None]).sum(-2)
    if stats_kv:
        return (num, to_stat_rows(mx[..., 0], stats_kv),
                to_stat_rows(den[..., 0], stats_kv))
    return (num / torch.where(den == 0, torch.ones(()), den)).to(dtype)


def to_stat_rows(x: torch.Tensor, kv: int) -> torch.Tensor:
    """Per-head values ``[B, SQ, H]`` in the statistics' row order ``[B,
    KV, SQ·G]`` (head ``h = kvh·G + g``), the layout of the TPU kernel's
    ``m``/``l`` outputs without their padding lanes."""
    B, SQ, H = x.shape
    return x.reshape(B, SQ, kv, H // kv).transpose(1, 2).reshape(B, kv, -1)


def from_stat_rows(x: torch.Tensor, sq: int) -> torch.Tensor:
    """Inverse of :func:`to_stat_rows`: ``[B, KV, SQ·G]`` to ``[B, SQ, H]``."""
    B, KV, R = x.shape
    return x.reshape(B, KV, sq, R // sq).transpose(1, 2).reshape(B, sq, -1)


def paged_decode_split_reference(q, k, v, tables, pos, q_lens=None, *,
                                 block_size: int, paged_len: int,
                                 shard_lo: int = 0, shard_blocks: int = 0,
                                 return_stats: bool = False):
    """The CPU model of the kernels' split-K algorithm: the partials of
    every chunk of :func:`decode_chunks`' partition, then the merge, with
    :func:`paged_decode_attention`'s signature; the CPU path of its
    shard-local form and the tests' model of the kernel. Its rounding is
    the kernels': each ``p`` rounded to the working dtype once, at the
    chunk-local max (a scale <= 1, so within 2^-8 relative in bf16), and
    the chunk rescale ``e^(m_c - M)`` in fp32, so it lies within
    :func:`.attention.kernel_tolerance` of the plain version. A tile of
    more than 512 keys is one chunk that the kernels walk in pieces, with
    p at the running max and the same fp32 rescale inside the block; the
    model keeps p at the chunk max there, the same bound with other bits."""
    parts = _split_partials(q, k, v, tables, pos, q_lens, block_size=block_size,
                            paged_len=paged_len, shard_lo=shard_lo,
                            shard_blocks=shard_blocks)
    kv = (k.q if isinstance(k, QTensor) else k).shape[2]
    return _merge_partials(*parts, q.dtype, stats_kv=kv if return_stats else 0)


def _check_pool(q, payloads, rows: int) -> None:
    """The kernels read q in pairs of bf16, copy K and V rows 16 bytes at a
    time and index them in 32 bits."""
    if (q.data_ptr() % 4 or any(t.data_ptr() % 16 for t in payloads)
            or rows >= _MAX_ROWS):
        raise ValueError("decode kernel: q must start 4-byte and K/V 16-byte "
                         "aligned, K/V hold fewer than 2^31 rows x KV heads "
                         f"(got {rows})")


def _partials_scratch(rows: int, d: int, device) -> torch.Tensor:
    """The split pass's fp32 partials, one allocation: ``acc [rows, D]``,
    then ``m [rows]`` and ``l [rows]``; the kernels write all they read."""
    return torch.empty(rows * (d + 2), dtype=torch.float32, device=device)


def _lib():
    from . import _build

    fn = _build.load("paged_decode").paged_decode_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       I, I, I, ctypes.c_float, I, I, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _row_stride(t: torch.Tensor, inner: int) -> int:
    """The row stride, in KV heads, of a pool tensor ``[1, NT, KV, inner]``
    whose rows the kernel reads in place: the whole pool (stride KV) or a
    view of some of a wider pool's heads. Raises unless each row's heads
    lie ``inner`` elements apart with the last axis dense."""
    KV = t.shape[2]
    if (t.stride(3) != 1 and inner > 1) or t.stride(2) != inner or (
            t.shape[1] > 1 and t.stride(1) % inner):
        raise ValueError("paged decode kernel: a pool's heads must be dense "
                         f"rows of {inner} (got strides {t.stride()})")
    ld = t.stride(1) // inner if t.shape[1] > 1 else KV
    if ld < KV:
        raise ValueError(f"paged decode kernel: row stride {ld} < KV {KV}")
    return ld


def paged_decode_attention(q, k, v, tables, pos, q_lens=None, *,
                           block_size: int, paged_len: int) -> torch.Tensor:
    """q ``[B, SQ, H, D]``; k/v pool slices ``[1, NT, KV, D]`` (tensor or
    int8 QTensor), whole pools or views of some KV heads of a wider pool;
    tables ``[B, NB]``, pos ``[B]`` and q_lens ``[B]`` int32.
    ``pos[b]`` is the position of lane b's LAST query row; row ``j`` sits at
    ``pos[b] - (SQ-1) + j``; the leading ``SQ - q_lens[b]`` rows are padding
    and come back finite and unread (``q_lens=None``: every row is real).
    ``tables`` must have SCRATCH entries remapped to ZERO already. On CUDA
    it launches the kernel or raises; on the CPU it runs
    :func:`paged_decode_reference`."""
    if not q.is_cuda:
        _check_shapes(q, k, block_size)
        return paged_decode_reference(q, k, v, tables, pos, q_lens,
                                      block_size=block_size, paged_len=paged_len)
    out = _launch(q, k, v, tables, pos, q_lens, block_size, paged_len)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_shard_stats(q, k, v, tables, pos, q_lens=None, *,
                             block_size: int, paged_len: int, shard_lo: int,
                             shard_blocks: int):
    """The shard-local form of :func:`paged_decode_attention` (the TPU
    kernel's ``shard_lo``/``shard_blocks`` with ``return_stats=True``): k/v
    are one shard's ``[1, shard_blocks·bs, KV, D]`` slice of a block-sharded
    pool holding global blocks ``[shard_lo, shard_lo + shard_blocks)``, and
    only tiles whose table entry the shard holds are visited. Returns
    ``(acc [B, SQ, H, D], m, l [B, KV, SQ·G])`` in fp32, the accumulator
    undivided (the TPU kernel's outputs without their padding lanes); a
    shard holding none of a row's tiles gives ``m = NEG_INF``, ``l = 0``,
    ``acc = 0``. :func:`.attention.merge_shard_stats` merges the shards.
    On CUDA it launches the kernel (counted here, not in
    :func:`paged_decode_attention`) or raises; on the CPU it runs
    :func:`paged_decode_split_reference`."""
    NT = _check_shapes(q, k, block_size)
    if shard_blocks < 1 or NT != shard_blocks * block_size:
        raise ValueError(f"a shard of {shard_blocks} blocks of {block_size} "
                         f"holds {shard_blocks * block_size} rows, the pool "
                         f"slice {NT}")
    if not q.is_cuda:
        return paged_decode_split_reference(
            q, k, v, tables, pos, q_lens, block_size=block_size,
            paged_len=paged_len, shard_lo=shard_lo, shard_blocks=shard_blocks,
            return_stats=True)
    out = _launch(q, k, v, tables, pos, q_lens, block_size, paged_len,
                  shard_lo, shard_blocks)
    paged_decode_shard_stats.launches += 1
    return out


paged_decode_shard_stats.launches = 0


def _check_shapes(q, k, block_size: int) -> int:
    """Raise unless the query heads group the pool's KV heads and the pool
    holds whole blocks; the pool's rows."""
    kq = k.q if isinstance(k, QTensor) else k
    H, NT, KV = q.shape[2], kq.shape[1], kq.shape[2]
    if H % KV or NT % block_size:
        raise ValueError(f"bad decode shapes: H={H} KV={KV} NT={NT} "
                         f"bs={block_size}")
    return NT


def _launch(q, k, v, tables, pos, q_lens, bs: int, paged_len: int,
            shard_lo: int = 0, shard_blocks: int = 0):
    """Check the operands and launch the paged kernel: the output, or, in
    the shard-local form, the statistics."""
    quantized = isinstance(k, QTensor)
    kq = k.q if quantized else k
    B, Sq, H, D = q.shape
    NT, KV = kq.shape[1], kq.shape[2]
    _check_shapes(q, k, bs)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged decode kernel takes bf16 queries, got {q.dtype}")
    check_kernel_shapes(D, H // KV, bs)
    if not 1 <= Sq <= KERNEL_MAX_SQ:
        raise ValueError(f"paged decode kernel takes 1 to {KERNEL_MAX_SQ} query "
                         f"rows per lane, got {Sq}")
    if quantized:
        vq = v.q
        payloads, scales = (k.q, vq), (k.scale, v.scale)
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError("int8 pools must hold int8 payloads")
        if k.scale.dtype != torch.float32 or v.scale.dtype != torch.float32:
            raise TypeError("int8 pools need fp32 scales")
    else:
        payloads, scales = (k, v), ()
        if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
            raise TypeError(f"paged decode kernel takes bf16 pools, got {k.dtype}")
    kv_ld = _row_stride(payloads[0], D)
    if any(_row_stride(t, D) != kv_ld for t in payloads[1:]) or any(
            _row_stride(t, 1) != kv_ld for t in scales):
        raise ValueError("paged decode kernel: K, V and their scales must "
                         "share one row stride")
    tables = tables.to(torch.int32)
    pos = pos.to(torch.int32)
    scalars = (tables, pos)
    if q_lens is not None:
        q_lens = q_lens.to(torch.int32)
        scalars += (q_lens,)
    if pos.shape != (B,) or tables.shape[0] != B or (
            q_lens is not None and q_lens.shape != (B,)):
        raise ValueError("paged decode kernel: tables [B, NB], pos [B] and "
                         "q_lens [B] must match q's batch")
    for t in (q,) + scalars:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged decode kernel: q, tables, pos and q_lens "
                             "must be contiguous and on q's device")
    if any(t.device != q.device for t in payloads + scales):
        raise ValueError("paged decode kernel: the pool must be on q's device")
    _check_pool(q, payloads, NT * kv_ld)
    if shard_blocks:
        out = None
        stats = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                 torch.empty((B, KV, Sq * (H // KV)), dtype=torch.float32,
                             device=q.device))
        stats += (torch.empty_like(stats[1]),)
    else:
        out = torch.empty_like(q)
        stats = (None, None, None)
    kp, vp = (t.data_ptr() for t in payloads)
    ks, vs = (t.data_ptr() for t in scales) if quantized else (None, None)
    grid_k = _grid_k(tables, bs, paged_len)
    tiles, n_chunks = decode_chunks(bs, grid_k)
    part = _partials_scratch(B * Sq * H * n_chunks, D, q.device)
    err = _lib()(
        q.data_ptr(), kp, vp, ks, vs, tables.data_ptr(), pos.data_ptr(),
        None if q_lens is None else q_lens.data_ptr(),
        None if out is None else out.data_ptr(),
        part.data_ptr(), B, Sq, H, KV, D, tables.shape[1], bs, grid_k, tiles,
        n_chunks, int(quantized), 1.0 / float(D) ** 0.5, kv_ld,
        int(shard_lo), int(shard_blocks),
        *(None if t is None else t.data_ptr() for t in stats),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    return stats if shard_blocks else out


# ----- the lock-step dense kernel ------------------------------------------


def decode_attention_reference(q, k, v, pos) -> torch.Tensor:
    """The plain version of :func:`decode_attention`: causal attention of
    the one query token at the shared position ``pos`` over the cache."""
    pos = torch.as_tensor(pos, device=q.device).reshape(())
    return reference_attention(q, k, v, causal=True, q_offset=pos)


def _dense_lib():
    from . import _build

    fn = _build.load("dense_decode").dense_decode_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float,
                       P]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, pos) -> torch.Tensor:
    """q ``[B, 1, H, D]``; k/v the dense cache ``[B, S, KV, D]`` read in
    place; ``pos`` the one position shared by the batch, a 0-dim or ``[1]``
    integer tensor (the kernel reads it on the device: no host sync). On
    CUDA it launches the kernel or raises (bf16 only, ``supports_decode``
    shapes); on the CPU it runs :func:`decode_attention_reference`."""
    B, Sq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if H % KV or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        return decode_attention_reference(q, k, v, pos)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("dense decode kernel takes bf16 queries and a bf16 "
                        f"cache, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_dense_shapes(Sq, S, D, H // KV)
    if not torch.is_tensor(pos) or pos.numel() != 1 or not pos.is_cuda:
        raise ValueError("dense decode kernel reads its position on the "
                         "device: pass a 0-dim or [1] CUDA tensor")
    pos = pos.to(torch.int32).reshape(1)
    for t in (q, k, v, pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("dense decode kernel operands must be contiguous "
                             "and on q's device")
    _check_pool(q, (k, v), B * S * KV)
    out = torch.empty_like(q)
    tiles, n_chunks = decode_chunks(DENSE_BLOCK_K, S // DENSE_BLOCK_K)
    part = _partials_scratch(B * H * n_chunks, D, q.device)
    err = _dense_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, S, H, KV, D, tiles, n_chunks,
        1.0 / float(D) ** 0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"dense_decode kernel launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def shard_stats_tolerance(got, want, q, k) -> dict:
    """How far the shard-local kernel's statistics ``got = (acc, m, l)`` may
    lie from the plain version's ``want`` on the same inputs (``q`` and the
    shard's pool ``k``, bf16 or int8).

    Both sides form each logit from the same exact bf16 products summed in
    fp32 in different orders, so they differ by at most ``e = 2 · D ·
    2^-24 · scale · max|q| · max|k|`` (vector norms, ``scale =
    1/sqrt(D)``); ``m`` may differ by ``e``, and each ``exp(s - m)`` by a
    factor within ``exp(2e)``, so ``l`` (fp32 sums of terms <= 1 over ``n``
    keys) by ``l · (4e + n · 2^-23)``. The normalised ``acc / l`` takes the
    kernels' bound (:func:`.attention.kernel_tolerance`) in the caller.
    Rows with no owned key must be exact on both sides: ``m = NEG_INF``,
    ``l = 0``, ``acc = 0``. Returns the errors, the bounds and ``ok``."""
    acc, m, l = (t.float() for t in got)
    acc_w, m_w, l_w = (t.float() for t in want)
    D = q.shape[-1]
    kk = dequantize_kv(k, torch.float32) if isinstance(k, QTensor) else k.float()
    e = (2 * D * 2.0 ** -24 / float(D) ** 0.5
         * float(q.float().norm(dim=-1).max()) * float(kk.norm(dim=-1).max()))
    n = kk.shape[1]
    empty = m_w <= NEG_INF / 2
    full = ~empty
    res = {
        "m_err": float((m - m_w)[full].abs().max()) if full.any() else 0.0,
        "m_bound": e,
        "l_err_over_bound": float(((l - l_w).abs()
                                   / (l_w * (4 * e + n * 2.0 ** -23)))[full].max())
        if full.any() else 0.0,
        "empty_rows": int(empty.sum()),
        "empty_exact": bool((m[empty] == m_w[empty]).all()
                            and (l[empty] == 0).all()),
    }
    if res["empty_rows"]:
        rows = from_stat_rows(empty, acc.shape[1])  # [B, SQ, H]
        res["empty_exact"] &= bool((acc[rows] == 0).all())
    res["ok"] = (res["m_err"] <= e and res["l_err_over_bound"] <= 1.0
                 and res["empty_exact"])
    return res
