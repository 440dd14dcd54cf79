"""Training (counterpart of ``kata_xpu_device_plugin_tpu/parallel``): the
AdamW train step, the deterministic resumable loader, checkpoints and the
``fit`` loop; meshes (every shard on one device) and sequence parallelism
over a ``seq`` axis, by ring attention (the K1 block kernels) or Ulysses.
FSDP, tensor and pipeline parallelism for training are not ported yet."""
from .checkpoint import TrainCheckpointer
from .loader import TokenBatchLoader
from .mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    MESH_AXES,
    Mesh,
    build_mesh,
    default_mesh_shape,
    mesh_1d,
    seq_mesh,
)
from .ring import make_ring_attention
from .sharding import (
    AdamW,
    batch_spec,
    make_optimizer,
    make_train_step,
    shard_batch,
)
from .trainer import fit
from .ulysses import make_ulysses_attention

__all__ = ["AXIS_DATA", "AXIS_FSDP", "AXIS_MODEL", "AXIS_SEQ", "AdamW",
           "MESH_AXES", "Mesh", "TokenBatchLoader", "TrainCheckpointer",
           "batch_spec", "build_mesh", "default_mesh_shape", "fit",
           "make_optimizer", "make_ring_attention", "make_train_step",
           "make_ulysses_attention", "mesh_1d", "seq_mesh", "shard_batch"]
