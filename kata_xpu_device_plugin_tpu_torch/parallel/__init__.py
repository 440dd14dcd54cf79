"""Training on one device (counterpart of ``kata_xpu_device_plugin_tpu/parallel``):
the AdamW train step, the deterministic resumable loader, checkpoints and
the ``fit`` loop. Meshes, FSDP, tensor, sequence and pipeline parallelism
are not ported yet."""
from .checkpoint import TrainCheckpointer
from .loader import TokenBatchLoader
from .sharding import AdamW, make_optimizer, make_train_step
from .trainer import fit

__all__ = ["AdamW", "TokenBatchLoader", "TrainCheckpointer", "fit",
           "make_optimizer", "make_train_step"]
