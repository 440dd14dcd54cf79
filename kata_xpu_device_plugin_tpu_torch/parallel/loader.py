"""Deterministic, resumable token-batch loader for the training path (a
numpy-only copy of ``TokenBatchLoader`` in
``kata_xpu_device_plugin_tpu/parallel/loader.py``, without the mesh
placement: every shard of a one-process mesh is on one device, and the
step cuts the batch itself; under a process mesh each rank reads its own
batch shard's rows).

- **deterministic**: a ``(seed, epoch)`` pair fixes the sample order
  exactly, the same order as the JAX package's loader;
- **resumable**: ``state_dict()``/``load_state_dict()`` capture the
  cursor, so a restored run continues with the same remaining batches;
- **process-strided**: with ``host_count > 1`` each process takes the
  disjoint ``host_index``-th stride of every global batch (``batch //
  host_count`` rows), the rows JAX's loader gives each host. In a Kata
  guest the two come from the plugin-injected identity through
  ``guest.distributed``'s process group; under a process mesh, from the
  rank's batch shard (its ``(data, fsdp)`` coordinate).

Every batch is the same ``[batch // host_count, seq_len + 1]`` int32 numpy
array (inputs ``[:, :-1]``, targets ``[:, 1:]``, the convention of
:func:`..models.transformer.next_token_loss`); a trailing partial batch is
dropped. On the card, ``seq_len + 1`` must be a flash-kernel length (a
multiple of 32 with a divisor of at least 128), e.g. ``seq_len=2047``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np


class TokenBatchLoader:
    """Iterate ``[batch, seq_len+1]`` windows over a 1-D token stream (any
    integer array-like, e.g. an ``np.memmap``; only the gathered windows
    are copied). Windows are non-overlapping and shuffled per epoch by a
    generator seeded with ``(seed, epoch)``."""

    def __init__(self, tokens: Any, batch: int, seq_len: int, seed: int = 0,
                 shuffle: bool = True, host_count: int = 1, host_index: int = 0):
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D, got {self.tokens.ndim}-D")
        if batch % host_count != 0:
            raise ValueError(f"batch {batch} not divisible by host_count {host_count}")
        if not 0 <= host_index < host_count:
            raise ValueError(f"host_index {host_index} not in [0, {host_count})")
        self.batch, self.seq_len = batch, seq_len
        self.window = seq_len + 1
        self.n_windows = len(self.tokens) // self.window
        if self.n_windows < batch:
            raise ValueError(
                f"stream has {self.n_windows} windows of {self.window} "
                f"tokens; need at least batch={batch}"
            )
        self.seed, self.shuffle = seed, shuffle
        self.host_count, self.host_index = host_count, host_index
        self.epoch = 0
        self.step_in_epoch = 0  # next global batch index within the epoch
        self._order_cache: Optional[tuple[int, np.ndarray]] = None

    @property
    def steps_per_epoch(self) -> int:
        return self.n_windows // self.batch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        order = np.arange(self.n_windows, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        self._order_cache = (epoch, order)
        return order

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.step_in_epoch >= self.steps_per_epoch:
            self.epoch += 1
            self.step_in_epoch = 0
        order = self._epoch_order(self.epoch)
        start = self.step_in_epoch * self.batch
        rows = order[start: start + self.batch]
        # This process's stride of the global batch: every process computes
        # the same order, so the strides are disjoint and cover it.
        rows = rows[self.host_index:: self.host_count]
        batch = np.stack(
            [self.tokens[r * self.window: (r + 1) * self.window] for r in rows]
        ).astype(np.int32)
        self.step_in_epoch += 1
        return batch

    def state_dict(self) -> dict:
        """The full cursor; small and JSON-able (the JAX package's keys)."""
        return {
            "epoch": self.epoch,
            "step_in_epoch": self.step_in_epoch,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "batch": self.batch,
            "seq_len": self.seq_len,
            "n_windows": self.n_windows,
        }

    def load_state_dict(self, state: dict) -> None:
        for k in ("seed", "shuffle", "batch", "seq_len", "n_windows"):
            if state[k] != getattr(self, k):
                raise ValueError(
                    f"loader state mismatch on {k!r}: checkpoint has "
                    f"{state[k]!r}, loader has {getattr(self, k)!r} — "
                    "resuming with a different data order would silently "
                    "repeat or skip samples"
                )
        self.epoch = state["epoch"]
        self.step_in_epoch = state["step_in_epoch"]


def make_loader(tokens: Any, batch: int, seq_len: int, mesh: Any = None,
                seed: int = 0, shuffle: bool = True,
                host_count: Optional[int] = None,
                host_index: Optional[int] = None) -> TokenBatchLoader:
    """A :class:`TokenBatchLoader` (JAX ``make_loader``). Under a process
    mesh (:func:`.mesh.process_mesh`) ``host_count`` and ``host_index``
    default to the mesh's batch shards and this rank's among them
    (``sharding.batch_shards``: the ``(data, fsdp)`` coordinate, so the
    model ranks of one coordinate read the same rows and the coordinates'
    rows cover the global batch once). Otherwise they default to
    ``torch.distributed``'s world size and rank when a process group is
    initialized (in a Kata guest, the one
    ``guest.distributed.initialize_from_env`` forms from the plugin's
    identity), else to 1 and 0. The loader returns the process's own rows,
    the rows a data-parallel rank trains on. A one-process ``mesh`` places
    nothing: every shard is on one device."""
    from .mesh import is_process_mesh

    if is_process_mesh(mesh):
        from .sharding import batch_shards

        index, count = batch_shards(mesh)
        host_count = count if host_count is None else host_count
        host_index = index if host_index is None else host_index
    if host_count is None or host_index is None:
        import torch.distributed as dist

        group = dist.is_available() and dist.is_initialized()
        if host_count is None:
            host_count = dist.get_world_size() if group else 1
        if host_index is None:
            host_index = dist.get_rank() if group else 0
    return TokenBatchLoader(tokens, batch, seq_len, seed=seed, shuffle=shuffle,
                            host_count=host_count, host_index=host_index)
