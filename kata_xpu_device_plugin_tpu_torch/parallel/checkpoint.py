"""Train-state checkpoints (counterpart of ``TrainCheckpointer`` in
``kata_xpu_device_plugin_tpu/parallel/checkpoint.py``, on
``torch.save``/``torch.load`` instead of orbax), whole or sharded.

One file per step, ``step_<n>.pt`` in one directory. A write goes to a
temporary file that is renamed into place only when complete, so a kill
mid-save leaves the previous step as ``latest``. Writes are synchronous:
:meth:`TrainCheckpointer.wait` and :meth:`TrainCheckpointer.close` are
no-ops kept for the JAX package's call pattern.

A sharded state (:class:`.sharding.Sharded` leaves, the LoRA and int8
wrappers) is written piece by piece, each piece its own tensor with its
spec and cuts beside it: no whole tensor is assembled to save. A restore
fills ``state_like``'s layout, as orbax's ``StandardRestore`` does: a leaf
saved with the same cuts is copied piece by piece (bit-equal), any other
is assembled from its saved pieces and cut into the live ones (the same
values under another mesh).

Over a process mesh (``mesh=``, :func:`.mesh.process_mesh`) every rank
saves: each piece is written once, by the rank at coordinate 0 on the
axes that do not cut it (``sharding.owned_pieces``). Rank 0's pieces and
the whole leaves stand in ``step_<n>.pt``, the manifest (step, tree,
cuts, and for each other piece the rank whose ``step_<n>.rank<r>.pt``
holds it); the other ranks write their files first, and rank 0 renames
the manifest into place only after every rank's file is complete, so a
step without its manifest does not exist. Any mesh restores it: a
process mesh reads each rank's pieces, a one-process mesh all of them.
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Optional

import torch

from .mesh import Mesh, is_process_mesh
from .sharding import Sharded, cut_pieces, owned_pieces, piece_index, rank_piece

_NAME = re.compile(r"^step_(\d+)\.pt$")
_RANK_FILE = re.compile(r"^step_(\d+)\.rank\d+\.pt$")


class TrainCheckpointer:
    """Step-indexed checkpoints of a train state — any nest of dicts over
    tensors and Python scalars, e.g. ``{"params", "opt", "step"}`` from
    :func:`.sharding.make_train_step` — keeping the newest
    ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 mesh: Optional[Mesh] = None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh if is_process_mesh(mesh) else None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, rank: int = 0) -> str:
        tail = f".rank{rank}" if rank else ""
        return os.path.join(self.directory, f"step_{int(step)}{tail}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` at ``step`` atomically, then prune to
        ``max_to_keep``. Over a process mesh every rank calls it."""
        if self.mesh is None:
            _write(self._path(step), _encode(state))
        else:
            self._save_ranks(step, state)
        if self.mesh is None or self.mesh.rank == 0:
            steps = self.steps()
            for old in steps[:-self.max_to_keep]:
                os.unlink(self._path(old))
            live = {str(s) for s in steps[-self.max_to_keep:]}
            for name in os.listdir(self.directory):
                m = _RANK_FILE.match(name)
                if m and m.group(1) not in live:
                    os.unlink(os.path.join(self.directory, name))
        if self.mesh is not None:
            _barrier(self.mesh)

    def _save_ranks(self, step: int, state: Any) -> None:
        mesh = self.mesh
        mine = {}
        tree = _encode(state, mesh, mine)
        if mesh.rank:
            if mine:
                _write(self._path(step, mesh.rank), mine)
            _barrier(mesh)  # every rank's file is complete ...
        else:
            _barrier(mesh)
            _write(self._path(step), tree)  # ... before the manifest lands

    def steps(self) -> list[int]:
        """All retained checkpoint steps, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The checkpoint at ``step`` (default: the latest) read into
        ``state_like``'s tensors in place — same shapes, dtypes and devices,
        with no second device copy of the state — and returned with its
        scalars replaced. A mismatched tree or tensor raises."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = _load(self._path(step))
        files = {}

        def piece(ref: dict) -> torch.Tensor:
            rank = ref[_REMOTE]
            if rank not in files:
                files[rank] = _load(self._path(step, rank))
            return files[rank][ref["key"]]

        return _fill(state_like, saved, "state", piece)

    def wait(self) -> None:
        """Writes are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


_SHARDED, _TUPLE, _REMOTE = "__sharded__", "__tuple__", "__rank__"


def _write(path: str, obj: Any) -> None:
    """``obj`` at ``path`` atomically: a temporary file, synced, renamed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _barrier(mesh: Mesh) -> None:
    import torch.distributed as dist

    dist.barrier(group=mesh.procs.group)


def _encode(state: Any, mesh: Optional[Mesh] = None,
            mine: Optional[dict] = None, path: str = "state") -> Any:
    """The state as dicts, lists, tensors and scalars (what ``torch.load``
    reads with ``weights_only``): a Sharded leaf as its spec, cuts, shape
    and pieces; a wrapper as its fields. Over a process ``mesh`` the tree
    of the manifest: rank 0's own pieces in place, each other rank's
    owned piece as a reference to its file, the piece put into ``mine``
    under its key when this rank owns it."""
    if isinstance(state, dict):
        return {k: _encode(v, mesh, mine, f"{path}.{k}")
                for k, v in state.items()}
    if isinstance(state, tuple):
        return {_TUPLE: [_encode(v, mesh, mine, f"{path}[{i}]")
                         for i, v in enumerate(state)]}
    if isinstance(state, Sharded):
        if state.mesh is not None and state.mesh is not mesh:
            raise ValueError(f"{path} lies on a process mesh: save it with "
                             "a TrainCheckpointer of that mesh")
        pieces = list(state.pieces)
        if mesh is not None:
            own = piece_index(state.spec, state.cuts, mesh.coords)
            if owned_pieces(state, mesh)[0] and mesh.rank:
                mine[f"{path}#{own}"] = pieces[0]
            pieces = [pieces[0] if i == own and mesh.rank == 0 else
                      {_REMOTE: _piece_owner(state, i, mesh),
                       "key": f"{path}#{i}"}
                      for i in range(math.prod(state.cuts))]
        return {_SHARDED: {"spec": list(state.spec), "cuts": list(state.cuts),
                           "shape": list(state.shape), "pieces": pieces}}
    return state


def _piece_owner(leaf: Sharded, i: int, mesh: Mesh) -> int:
    """The rank that writes piece ``i`` of ``leaf``: at the piece's
    coordinates on the axes cutting it, 0 on the others."""
    coords = dict.fromkeys(mesh.axis_names, 0)
    for axis, n in reversed(list(zip(leaf.spec, leaf.cuts))):
        if n > 1:
            coords[axis] = i % n
        i //= n
    rank = 0
    for axis, n in zip(mesh.axis_names, mesh.dims):
        rank = rank * n + coords[axis]
    return rank


def _assemble(saved: dict, piece) -> torch.Tensor:
    """The whole tensor of a saved Sharded leaf."""
    pieces = [piece(p) if isinstance(p, dict) else p for p in saved["pieces"]]
    live = Sharded(saved["spec"], saved["cuts"], pieces, saved["shape"])
    return live.select()


def _own_piece(whole: torch.Tensor, live: Sharded) -> list:
    """``whole`` cut into ``live``'s pieces: all of them, or on a process
    mesh this rank's."""
    if live.mesh is None:
        return cut_pieces(whole, live.cuts)
    return [rank_piece(whole, live.spec, live.cuts, live.mesh)]


def _fill(live: Any, saved: Any, path: str, piece) -> Any:
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint tree differs from the state at {path}")
        return {k: _fill(live[k], saved[k], f"{path}.{k}", piece) for k in live}
    if isinstance(live, tuple):
        if not (isinstance(saved, dict) and _TUPLE in saved
                and len(saved[_TUPLE]) == len(live)):
            raise ValueError(f"checkpoint tree differs from the state at {path}")
        return type(live)(*(_fill(a, b, f"{path}[{i}]", piece)
                            for i, (a, b) in enumerate(zip(live, saved[_TUPLE]))))
    sharded = isinstance(saved, dict) and _SHARDED in saved
    if isinstance(live, Sharded):
        if sharded and (tuple(saved[_SHARDED]["cuts"]) == live.cuts
                        and tuple(saved[_SHARDED]["shape"]) == live.shape):
            # The same cut: piece by piece (this rank's, on a process mesh).
            pieces = saved[_SHARDED]["pieces"]
            if live.mesh is not None:
                pieces = [pieces[piece_index(live.spec, live.cuts,
                                             live.mesh.coords)]]
            pieces = [piece(p) if isinstance(p, dict) else p for p in pieces]
        else:
            whole = _assemble(saved[_SHARDED], piece) if sharded else saved
            _check(whole, live.shape, live.dtype, path)
            pieces = _own_piece(whole, live)
        for i, (p, q) in enumerate(zip(live.pieces, pieces)):
            _check(q, p.shape, p.dtype, f"{path}#{i}")
            with torch.no_grad():
                p.copy_(q)
        return live
    if isinstance(live, torch.Tensor):
        saved = _assemble(saved[_SHARDED], piece) if sharded else saved
        _check(saved, live.shape, live.dtype, path)
        with torch.no_grad():
            live.copy_(saved)
        return live
    return saved


def _check(saved: Any, shape, dtype, path: str) -> None:
    if (not isinstance(saved, torch.Tensor) or saved.shape != shape
            or saved.dtype != dtype):
        raise ValueError(f"checkpoint tensor differs from the state at {path}")
