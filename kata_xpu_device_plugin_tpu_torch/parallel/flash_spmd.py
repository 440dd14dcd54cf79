"""The flash kernels per local block of a mesh (counterpart of
``kata_xpu_device_plugin_tpu/parallel/flash_spmd.py``).

Self-attention is independent over batch rows and heads, so on a data x
fsdp x model mesh each shard attends over its local ``[B/(data·fsdp), S,
H/tp, D]`` block with no collective: JAX wraps its Pallas kernel in
``shard_map`` over those axes. Here every shard is on the mesh's one
device and the blocks run in turn, each one launch of the forward kernel
and, through autograd, one of each backward kernel
(:class:`..ops.flash.FlashAttention`). A block is a view of the global
tensor: batch rows are a slice, a head range a strided view, and the
kernels take both through their strides (``ops.flash._kernel_operand``
copies only an operand whose strides or base they cannot read, and counts
the copies).

On a process mesh (:func:`.mesh.process_mesh`) each rank holds its own
block already (its batch rows, its model shard's heads), so the attention
is that one block: one launch of each kernel a call, no cut, no join.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import collectives
from .mesh import AXIS_DATA, AXIS_FSDP, Mesh, is_process_mesh


def _count(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    names = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in names:
        n *= mesh.shape.get(a, 1)
    return n


def join(parts: list, dim: int) -> torch.Tensor:
    """The blocks side by side along ``dim`` (``collectives.all_gather``);
    a lone block as it is, uncopied."""
    return parts[0] if len(parts) == 1 else collectives.all_gather(parts, dim)


def make_sharded_attention(mesh: Mesh, batch_axes=(AXIS_DATA, AXIS_FSDP),
                           head_axis: Optional[str] = None,
                           kv_head_axis: Optional[str] = None,
                           use_flash: Optional[bool] = None):
    """Returns ``attn(q, k, v, causal=True, q_offset=None, window=0,
    logits_softcap=0.0)`` on GLOBAL ``[B, S, H, D]`` tensors: a drop-in
    ``attn_fn`` for dp/fsdp/tp meshes. The batch is cut over
    ``batch_axes``, the query heads over ``head_axis`` and the KV heads
    over ``kv_head_axis``; the blocks' outputs are put back side by side.

    ``use_flash=None`` decides per local block by JAX's rule
    (``ops.attention.flash_eligible`` on the block's own shape): an
    eligible block on the card launches the kernels (and fails if they
    refuse it), any other block takes ``reference_attention``. ``True``
    takes ``flash_attention`` for every block (its plain version on the
    CPU), ``False`` the plain attention. JAX's ``flash_interpret`` (Pallas
    interpret mode) has no counterpart: on the CPU the kernels' plain
    versions stand in. On a process mesh the tensors are this rank's
    local block, attended as one."""
    from ..ops.attention import (
        flash_attention,
        flash_eligible,
        reference_attention,
    )

    nb = _count(mesh, batch_axes)
    nh, nkv = _count(mesh, head_axis), _count(mesh, kv_head_axis)
    if is_process_mesh(mesh):
        nb = nh = nkv = 1

    def sharded_attn(q, k, v, causal: bool = True, q_offset=None,
                     window: int = 0, logits_softcap: float = 0.0):
        if q_offset is not None:
            raise ValueError(
                "sharded flash attention is for self-attention "
                "(training/prefill); decode-into-cache has its own path")
        B, S, H, D = q.shape
        KV = k.shape[2]
        if nh != nkv:
            raise ValueError(
                f"query heads cut {nh} ways but KV heads {nkv}: a block's "
                "query heads would lose their KV group")
        if B % nb or H % nh or KV % nkv:
            raise ValueError(
                f"q {tuple(q.shape)} / kv heads {KV} do not divide over "
                f"{nb} batch, {nh} head and {nkv} kv-head shards")
        if use_flash is None:
            engage = flash_eligible(S, k.shape[1], D, on_cuda=q.is_cuda)
        else:
            engage = use_flash
        fn = flash_attention if engage else reference_attention
        kw = dict(causal=causal, window=int(window),
                  logits_softcap=float(logits_softcap))
        rows = []
        for qb, kb, vb in zip(q.chunk(nb, 0), k.chunk(nb, 0), v.chunk(nb, 0)):
            heads = [fn(qh, kh, vh, **kw) for qh, kh, vh in zip(
                qb.chunk(nh, 2), kb.chunk(nh, 2), vb.chunk(nh, 2))]
            rows.append(join(heads, 2))
        return join(rows, 0)

    return sharded_attn
