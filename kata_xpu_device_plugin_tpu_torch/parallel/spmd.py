"""The sharded training program on one device: what GSPMD makes of the JAX
package's train step over a data x fsdp x model mesh, written out shard by
shard (the forward half of ``kata_xpu_device_plugin_tpu/parallel/
sharding.py``'s ``make_train_step``, and the stage body of its composed
step).

Parameters are the :class:`.sharding.Sharded` pieces of
:data:`.sharding.PARAM_RULES`. A layer runs as GSPMD partitions it:

- FSDP: each model shard gathers its weights over fsdp
  (``collectives.all_gather``) when the layer runs; autograd through the
  gather sums the batch shards' gradients into each piece (the
  reduce-scatter);
- TP: q/k/v and gate/up are column-parallel, wo and w_down row-parallel
  with a sum over the model shards after each (``models.transformer
  ._layer`` with a :class:`LayerShards`, the code tensor-parallel serving
  runs); the attention cuts its own blocks (:mod:`.flash_spmd`,
  :mod:`.ring`);
- the vocabulary: the embedding is a vocab-parallel lookup (each model
  shard masks the tokens outside its rows; the shards are summed) and the
  loss a vocab-parallel cross-entropy (``all_reduce_max`` and
  ``all_reduce_sum`` over the shards' fp32 logits; no ``[B, S, vocab]``
  row is ever gathered).

A batch shard's rows meet only their own rows: every product here is
row-wise, so the rows of all (data x fsdp) batch shards go through one
product, which is each shard's product side by side; the attention, where
a kernel launch has a shape, runs per local block.

Over a process mesh (:func:`.mesh.process_mesh`) the same program runs
with one shard a rank (:class:`GroupShards`): each rank holds its own
rows of the batch and its model shard's pieces, the fsdp gathers, the
sums after the row-parallel products and the vocab-parallel reductions
are collectives over the lines of the fsdp and model axes
(:func:`..ops.collectives.gather_pieces`, :func:`..ops.collectives.
sum_shards`), and each column-parallel product's input enters the
model line through :func:`..ops.collectives.enter_shards`, whose backward
sums the members' partial gradients (Megatron's f and g operators).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint

from ..models import transformer as tfm
from ..ops import collectives
from .mesh import AXIS_FSDP, AXIS_MODEL, Mesh, is_process_mesh
from .sharding import Sharded, heads_divide, layer_leaves, local


def model_size(mesh: Mesh) -> int:
    return mesh.shape.get(AXIS_MODEL, 1)


@dataclass(frozen=True)
class LayerShards:
    """The model axis of a training mesh as ``models.transformer._layer``
    reads it (the counterpart of serving's ``ServingMesh``): ``tp`` shards,
    a sum after each row-parallel product, and attention called once on
    the whole q, k and v, its output cut into the ``tp`` feature slices
    the row-parallel ``wo`` pieces take."""

    tp: int

    def models(self) -> range:
        """The model shards this process computes: all of them."""
        return range(self.tp)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel products: every shard reads
        ``x`` itself."""
        return x

    def reduce(self, parts: list) -> torch.Tensor:
        return collectives.all_reduce_sum(parts)

    def max(self, parts: list) -> torch.Tensor:
        return collectives.all_reduce_max(parts)

    def gather(self, parts: list) -> torch.Tensor:
        return tfm._gather(parts)

    def attend(self, fn: Callable, q, k, v, **kw) -> list:
        B, S, H, D = q.shape
        out = fn(q, k, v, **kw).reshape(B, S, H * D)
        return list(out.tensor_split(self.tp, dim=-1))

    def embed(self, table: Any, tokens: torch.Tensor, cfg) -> torch.Tensor:
        """The vocab-parallel lookup over every model shard: shard m looks
        up the tokens of its rows ``[lo_m, hi_m)`` in each fsdp piece and
        gathers the looked-up rows over fsdp, zeros elsewhere, and the
        shards' rows are summed."""
        rows, lo = [], 0
        for m in range(self.tp):
            parts = _model_rows(table, m)
            hi = lo + parts[0].shape[0]
            inside = (tokens >= lo) & (tokens < hi)
            idx = torch.where(inside, tokens - lo, torch.zeros_like(tokens))
            got = collectives.all_gather([p[idx] for p in parts], dim=-1)
            rows.append(torch.where(inside[..., None], got,
                                    torch.zeros((), dtype=got.dtype,
                                                device=got.device)))
            lo = hi
        return tfm.embed_rows(collectives.all_reduce_sum(rows), cfg)

    def join_logits(self, parts: list) -> torch.Tensor:
        """The model shards' vocab slices side by side."""
        return collectives.all_gather(parts, dim=-1)


class GroupShards:
    """The model axis of a process mesh as ``models.transformer._layer``
    reads it: this rank computes its own model shard (``parts`` are lists
    of one), the sum after each row-parallel product and the vocab-parallel
    reductions run over the model line, and the input of each
    column-parallel product enters the line (:meth:`enter`). When the
    heads divide the axis (``heads_local``) q, k and v stay this rank's
    heads and it attends over them alone; otherwise they are gathered over
    the line, every rank attends over all heads and keeps its own feature
    slice, as :class:`LayerShards` cuts it."""

    def __init__(self, mesh: Mesh, heads_local: bool):
        self.mesh, self.heads_local = mesh, heads_local
        self.tp = mesh.shape.get(AXIS_MODEL, 1)
        self.line = mesh.line(AXIS_MODEL)
        self.m = mesh.coords[AXIS_MODEL]

    def models(self) -> list:
        return [self.m]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.enter_shards(x, self.line)

    def reduce(self, parts: list) -> torch.Tensor:
        (x,) = parts
        return collectives.sum_shards(x, self.line)

    def max(self, parts: list) -> torch.Tensor:
        (x,) = parts
        return collectives.group_all_reduce_max(x.detach(), self.line)

    def gather(self, parts: list) -> torch.Tensor:
        (x,) = parts
        if self.heads_local:
            return x
        return collectives.gather_pieces(x, self.line, x.ndim - 1)

    def attend(self, fn: Callable, q, k, v, **kw) -> list:
        B, S, H, D = q.shape
        out = fn(q, k, v, **kw).reshape(B, S, H * D)
        if self.heads_local:
            return [out]
        return [out.tensor_split(self.tp, dim=-1)[self.m]]

    def embed(self, table: Any, tokens: torch.Tensor, cfg) -> torch.Tensor:
        """The vocab-parallel lookup: this rank's rows (:meth:`lookup`)
        summed over the model line."""
        return tfm.embed_rows(self.reduce([self.lookup(table, tokens)]), cfg)

    def join_logits(self, parts: list) -> torch.Tensor:
        """This rank's vocab slice, gathered over the model line."""
        return collectives.gather_pieces(parts[0], self.line, -1)

    def lookup(self, table: Any, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the vocab-parallel lookup, zeros for the
        tokens outside its vocab range: the fsdp line's tokens looked up in
        this rank's column piece and exchanged (an all-to-all), so that
        each rank ends with every column of its own tokens' rows and no
        table is gathered."""
        piece = table.pieces[0] if isinstance(table, Sharded) else table
        cut = table.cut_axes() if isinstance(table, Sharded) else frozenset()
        lo = self.m * piece.shape[0] if AXIS_MODEL in cut else 0
        fsdp = self.mesh.line(AXIS_FSDP) if AXIS_FSDP in cut else None
        if fsdp is not None:
            tokens = collectives.group_all_gather(tokens, fsdp, dim=0)
        inside = (tokens >= lo) & (tokens < lo + piece.shape[0])
        idx = torch.where(inside, tokens - lo, torch.zeros_like(tokens))
        rows = torch.where(inside[..., None], piece[idx],
                           torch.zeros((), dtype=piece.dtype,
                                       device=piece.device))
        return collectives.exchange(rows, fsdp, 0, rows.ndim - 1)


def mesh_shards(mesh: Mesh, cfg):
    """The model axis's shards a step over ``mesh`` runs across."""
    if is_process_mesh(mesh):
        return GroupShards(mesh, heads_divide(cfg, mesh))
    return LayerShards(model_size(mesh))


def _shards(tp) -> Any:
    """A model-axis count or shards object as the shards object."""
    return tp if isinstance(tp, (LayerShards, GroupShards)) else LayerShards(tp)


def _model_rows(table: Any, m: int) -> list:
    """Model shard ``m``'s rows of an embedding table as its fsdp pieces
    (each a slice of ``d_model``), not gathered: a lookup gathers only the
    rows it reads, as GSPMD partitions a gather."""
    if isinstance(table, Sharded) and AXIS_FSDP in table.spec:
        n = table.cuts[table.spec.index(AXIS_FSDP)]
        return [table.select(**{AXIS_MODEL: m, AXIS_FSDP: f}) for f in range(n)]
    return [local(table, **{AXIS_MODEL: m})]


def vocab_embed(table: Any, tokens: torch.Tensor, cfg, tp) -> torch.Tensor:
    """The vocab-parallel lookup: model shard m holds rows ``[lo_m,
    hi_m)`` of the table and contributes the rows of the tokens in its
    range, zeros elsewhere, and the shards' rows are summed. Exactly one
    shard contributes to each token, so the fp32 sum is the row itself and
    the result equals ``models.transformer.embed`` bit for bit. ``tp``:
    the model shards' count, or their :func:`mesh_shards` (over a process
    mesh, :meth:`GroupShards.lookup`)."""
    return _shards(tp).embed(table, tokens, cfg)


def _vocab_logits(params: dict, x: torch.Tensor, cfg, tp) -> list:
    """Each model shard's fp32 logits ``[..., V_m]`` of the final-normed
    ``x`` (the tied table transposed, or the unembedding's column): over
    a process mesh this rank's shard's alone."""
    shards = _shards(tp)
    x = shards.enter(tfm.rms_norm(x, params["final_norm"], cfg.norm_eps))
    out = []
    for m in shards.models():
        coords = {AXIS_MODEL: m}
        proj = (local(params["embed"], **coords).t() if cfg.tie_embeddings
                else local(params["unembed"], **coords))
        out.append(tfm.project_logits(x, proj, cfg))
    return out


def vocab_nll_sum(params: dict, x: torch.Tensor, targets: torch.Tensor,
                  cfg, tp) -> torch.Tensor:
    """``models.transformer.token_nll_sum`` of the logits of ``x`` without
    gathering them: the row maximum and the sum of exponentials reduce
    over the model shards, and each target's logit comes from the shard
    whose vocab range holds it. fp32 throughout."""
    shards = _shards(tp)
    logits = _vocab_logits(params, x, cfg, shards)
    top = shards.max([l.amax(dim=-1) for l in logits]).detach()
    total = shards.reduce(
        [torch.exp(l - top[..., None]).sum(dim=-1) for l in logits])
    lse = torch.log(total) + top
    picked = []
    lo = shards.models()[0] * logits[0].shape[-1]
    targets = targets.long()
    for l in logits:
        hi = lo + l.shape[-1]
        inside = (targets >= lo) & (targets < hi)
        idx = torch.where(inside, targets - lo, torch.zeros_like(targets))
        got = torch.gather(l, -1, idx[..., None])[..., 0]
        picked.append(torch.where(inside, got, torch.zeros_like(got)))
        lo = hi
    return (lse - shards.reduce(picked)).sum()


def run_layers(layers: dict, x: torch.Tensor, cfg, tp, attn_fn,
               positions: torch.Tensor, first: int = 0, remat: bool = False,
               moe_mesh: Optional[Mesh] = None) -> tuple:
    """The stacked ``layers`` (pieces) over ``x``, layer ``first + i``'s
    window and rope for the i-th: each layer gathers its model shards'
    weights over fsdp and runs ``models.transformer._layer`` across
    :class:`LayerShards`. ``remat`` checkpoints each layer, gathers
    included, so neither its activations nor its gathered weights are
    kept. ``tp``: the model shards' count or :func:`mesh_shards`.
    Returns ``(x, [aux of each layer])``."""
    shards = _shards(tp)
    per_layer = {k: layer_leaves(v) for k, v in layers.items()}
    n = len(next(iter(per_layer.values())))
    auxes = []
    for i in range(n):
        def run(h, i=i):
            layer = [{k: local(v[i], **{AXIS_MODEL: m})
                      for k, v in per_layer.items()} for m in shards.models()]
            return tfm._layer(cfg, attn_fn, h, layer, positions,
                              index=first + i, mesh=shards, moe_mesh=moe_mesh)

        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(run, x,
                                                       use_reentrant=False)
        else:
            x, aux = run(x)
        auxes.append(aux)
    return x, auxes


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def hidden(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
           attn_fn: Optional[Callable] = None, remat: bool = False,
           moe_mesh: Optional[Mesh] = None) -> tuple:
    """The decoder stack up to the final norm over sharded ``params``:
    ``(x [B, S, d], aux)``, ``aux`` the mean of the MoE layers'
    load-balancing terms (fp32 0 for a dense config)."""
    tfm.check_supported(cfg)
    if attn_fn is None:
        from ..ops.attention import flash_attention

        attn_fn = flash_attention
    shards = mesh_shards(mesh, cfg)
    x = vocab_embed(params["embed"], tokens, cfg, shards)
    x, auxes = run_layers(params["layers"], x, cfg, shards, attn_fn,
                          _positions(tokens), remat=remat, moe_mesh=moe_mesh)
    if cfg.moe:
        return x, torch.stack(auxes).mean()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
            attn_fn: Optional[Callable] = None,
            moe_mesh: Optional[Mesh] = None) -> torch.Tensor:
    """fp32 logits ``[B, S, vocab]`` of sharded ``params``: the model
    shards' logits side by side (``models.transformer.forward``'s); over
    a process mesh, this rank's rows, gathered over the model line."""
    x, _ = hidden(params, tokens, cfg, mesh, attn_fn, moe_mesh=moe_mesh)
    shards = mesh_shards(mesh, cfg)
    return shards.join_logits(_vocab_logits(params, x, cfg, shards))


def next_token_loss(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
                    attn_fn: Optional[Callable] = None, remat: bool = False,
                    moe_mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``models.transformer.next_token_loss`` over sharded ``params``: the
    forward on the full sequence, the last position dropped, the
    vocab-parallel cross-entropy, plus the MoE term."""
    x, aux = hidden(params, tokens, cfg, mesh, attn_fn, remat, moe_mesh)
    targets = tokens[:, 1:]
    nll = vocab_nll_sum(params, x[:, :-1], targets, cfg,
                        mesh_shards(mesh, cfg))
    loss = nll / targets.numel()
    if cfg.moe:
        loss = loss + cfg.moe_aux_weight * aux
    return loss
