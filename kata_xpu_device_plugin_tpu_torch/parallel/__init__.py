"""Training (counterpart of ``kata_xpu_device_plugin_tpu/parallel``): the
AdamW train step over dp x fsdp x tp (x seq) meshes, sequence parallelism
(ring attention over the K1 block kernels, or Ulysses), the GPipe pipeline
and the composed pp x fsdp x tp step, the deterministic resumable loader,
sharded checkpoints and the ``fit`` loop. Every shard of a one-process
mesh sits on its one device; a process mesh (:func:`.mesh.process_mesh`)
puts one shard in each rank of a ``torch.distributed`` group (:mod:`.mesh`)."""
from .checkpoint import TrainCheckpointer
from .composed import (
    composed_mesh,
    init_pp_params,
    make_pp_loss,
    make_pp_train_step,
    shard_microbatches,
    to_pp_params,
)
from .flash_spmd import make_sharded_attention
from .loader import TokenBatchLoader, make_loader
from .mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    MESH_AXES,
    Mesh,
    build_mesh,
    default_mesh_shape,
    mesh_1d,
    pipe_mesh,
    process_mesh,
    seq_mesh,
)
from .pipeline import (
    make_pipeline,
    make_transformer_pipeline,
    sequential_reference,
    stack_stage_params,
)
from .ring import make_ring_attention
from .sharding import (
    BATCH_SPEC,
    PARAM_RULES,
    AdamW,
    batch_spec,
    init_sharded_params,
    make_optimizer,
    make_train_step,
    param_shardings,
    shard_batch,
    shard_params,
)
from .trainer import fit
from .ulysses import make_ulysses_attention

__all__ = [
    "composed_mesh", "init_pp_params", "make_pp_loss", "make_pp_train_step",
    "shard_microbatches", "to_pp_params",
    "AXIS_DATA", "AXIS_FSDP", "AXIS_MODEL", "AXIS_SEQ", "build_mesh",
    "default_mesh_shape", "seq_mesh",
    # the port's own: one shard a process
    "process_mesh",
    "AXIS_PIPE", "make_pipeline", "make_transformer_pipeline", "pipe_mesh",
    "sequential_reference", "stack_stage_params",
    "make_ring_attention", "make_sharded_attention", "make_ulysses_attention",
    "BATCH_SPEC", "batch_spec", "PARAM_RULES", "init_sharded_params",
    "make_optimizer", "make_train_step", "param_shardings", "shard_batch",
    "shard_params",
    "TrainCheckpointer", "TokenBatchLoader", "make_loader", "fit",
    # the port's own
    "AdamW", "MESH_AXES", "Mesh", "mesh_1d",
]
