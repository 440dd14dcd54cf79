"""One rank of a process mesh on the CPU, for ``tests/test_torch_procmesh.py``.

The test writes a job (``job.json`` and ``job.npz``: the config's fields,
the mesh shape, each rank's env, the weights as numpy in JAX's tree, the
tokens) into a directory and starts one process a rank:

    python tests/torch_procmesh_worker.py JOB_DIR INDEX

Each joins the gloo group through ``guest.distributed.initialize_from_env``
(``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, and worker ids where the job names
hosts), builds ``process_mesh`` and runs every check of the job, writing
``rank<r>.json`` and ``rank<r>.npz`` beside the job for the test to hold
against JAX and against the one-process mesh. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from kata_xpu_device_plugin_tpu_torch.guest import distributed  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import bridge  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.ops import collectives as c  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.parallel import (  # noqa: E402
    TrainCheckpointer,
    fit,
    make_loader,
    process_mesh,
)
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.parallel.mesh import MESH_AXES  # noqa: E402


def unflatten(flat: dict, prefix: str) -> dict:
    """``{"a/b": x}`` (under ``prefix/``) as ``{"a": {"b": x}}``."""
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, last = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return tree


def tree_items(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict, keys sorted."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], path)
        else:
            yield path, tree[k]


def piece_key(leaf) -> str:
    """Which piece of its leaf this rank holds: the index over its cuts,
    or ``whole``."""
    if not isinstance(leaf, tsh.Sharded):
        return "whole"
    return str(tsh.piece_index(leaf.spec, leaf.cuts, leaf.mesh.coords))


def local_tensor(leaf) -> torch.Tensor:
    return leaf.pieces[0] if isinstance(leaf, tsh.Sharded) else leaf


def collective_checks(line, seed: int) -> dict:
    """Every group collective over ``line`` against its list form on the
    members' tensors (each rank draws them all from the seed), bit for
    bit, and the differentiable forms' gradients against theirs."""
    n, i = line.size, line.index
    xs = [torch.from_numpy(np.random.default_rng(seed + s).standard_normal(
        (2 * n, 3 * n)).astype(np.float32)) for s in range(n)]
    x = xs[i]
    got = {
        "all_reduce_sum": (c.group_all_reduce_sum(x, line), c.all_reduce_sum(xs)),
        "all_reduce_max": (c.group_all_reduce_max(x, line), c.all_reduce_max(xs)),
        "all_gather": (c.group_all_gather(x, line, dim=1), c.all_gather(xs, 1)),
        "reduce_scatter": (c.group_reduce_scatter(x, line, 0),
                           c.reduce_scatter(xs, 0)[i]),
        "all_to_all": (c.group_all_to_all(x, line, 0, 1),
                       c.all_to_all(xs, 0, 1)[i]),
        "ppermute": (c.group_ppermute(x, line), c.ppermute(xs)[i]),
        "ring_all_reduce": (c.group_ring_all_reduce(x, line),
                            c.ring_all_reduce(xs)[i]),
        "overlapped_sum": (c.group_overlapped_sum(x, line, -1),
                           c.all_reduce_sum(xs)),
    }
    out = {k: bool(torch.equal(a, b)) for k, (a, b) in got.items()}
    # Gradients under a cotangent of each member's own (w[s]).
    ws = [torch.from_numpy(np.random.default_rng(seed + 100 + s).standard_normal(
        (2 * n * n, 3 * n)).astype(np.float32)) for s in range(n)]
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((c.gather_pieces(xg, line, 0) * ws[i]).sum(), xg)
    want = c.all_reduce_sum([w.chunk(n)[i] for w in ws])
    out["gather_pieces_grad"] = bool(torch.equal(g, want))
    (g,) = torch.autograd.grad((c.enter_shards(xg, line)
                                * ws[i][:2 * n]).sum(), xg)
    out["enter_shards_grad"] = bool(torch.equal(
        g, c.all_reduce_sum([w[:2 * n] for w in ws])))
    (g,) = torch.autograd.grad((c.sum_shards(xg, line) * ws[i][:2 * n]).sum(), xg)
    out["sum_shards_grad"] = bool(torch.equal(g, ws[i][:2 * n]))
    cots = [torch.from_numpy(np.random.default_rng(seed + 200 + s).standard_normal(
        (2, 3 * n * n)).astype(np.float32)) for s in range(n)]
    (g,) = torch.autograd.grad((c.exchange(xg, line, 0, 1) * cots[i]).sum(), xg)
    out["exchange_grad"] = bool(torch.equal(g, c.all_to_all(cots, 1, 0)[i]))
    return out


def main(job_dir: str, index: int) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    data = dict(np.load(os.path.join(job_dir, "job.npz")))
    summary = distributed.initialize_from_env(job["env"][index],
                                              port=job["port"], device="cpu")
    mesh = process_mesh(job["shape"], device="cpu")
    r = mesh.rank
    out = {"summary": summary, "rank": r, "coords": mesh.coords}
    arrays = {}

    # A shape whose size is not the group's raises.
    try:
        process_mesh({"data": mesh.procs.world.size + 1}, device="cpu")
        out["oversize_raises"] = None
    except ValueError as e:
        out["oversize_raises"] = str(e)

    # Each group collective against the list form, on every line.
    lines = {a: mesh.line(a) for a in MESH_AXES if mesh.line(a).size > 1}
    lines["world"] = mesh.line()
    out["collectives"] = {a: collective_checks(g, 17) for a, g in lines.items()}

    cfg = bridge.config_from_fields(job["cfg"])
    whole = bridge.params_from_numpy(unflatten(data, "params"), cfg, "cpu")
    toks = data["tokens"]

    # init_sharded_params: init_params' values, born as this rank's pieces
    # (each kept for the test, and gathered against the whole draw).
    born = tsh.init_sharded_params(cfg, mesh, seed=4)
    for path, leaf in tree_items(born):
        arrays[f"init/{path}#{piece_key(leaf)}"] = local_tensor(leaf).numpy()
    ref = tt.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    out["init_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            tsh.leaves(tsh.host_param_copy(born)), tsh.leaves(ref)))

    # The train step, two steps.
    opt = tsh.make_optimizer(lr=job["lr"], grad_clip=job["clip"])
    _, step = tsh.make_train_step(cfg, opt, accum_steps=job["accum"],
                                  aux_metrics=True, mesh=mesh)
    sp = tsh.shard_params(whole, mesh)
    out["share"] = {path: [local_tensor(leaf).numel(),
                           int(np.prod(leaf.shape)),
                           list(getattr(leaf, "cuts", ()))]
                    for path, leaf in tree_items(sp)}
    state = {"params": sp, "opt": opt.init(sp), "step": 0}
    losses, norms = [], []
    for _ in range(job["steps"]):
        state, loss, aux = step(state, tsh.shard_batch(toks, mesh))
        losses.append(float(loss))
        norms.append(float(aux["grad_norm"]))
    out["losses"], out["grad_norms"], out["step"] = losses, norms, state["step"]
    for name, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                       ("nu", state["opt"]["nu"])):
        for path, leaf in tree_items(tree):
            arrays[f"piece/{name}/{path}#{piece_key(leaf)}"] = \
                local_tensor(leaf).detach().numpy()
        gathered = tsh.host_param_copy(tree)
        if r == 0:
            for path, t in tree_items(gathered):
                arrays[f"whole/{name}/{path}"] = t.numpy()

    # The loader: this rank's rows of two global batches.
    loader = make_loader(data["stream"], batch=job["loader_batch"], seq_len=15,
                         mesh=mesh, seed=1)
    arrays["rows"] = np.stack([next(loader), next(loader)])

    # A process-mesh checkpoint of the trained state (the test restores it
    # into the one-process mesh), and the one-process checkpoint the test
    # wrote restored here.
    TrainCheckpointer(os.path.join(job_dir, "ckpt_out"), mesh=mesh).save(
        job["steps"], state)
    init_state, _ = tsh.make_train_step(cfg, opt, mesh=mesh)
    back = TrainCheckpointer(os.path.join(job_dir, "ckpt_in"), mesh=mesh
                             ).restore(init_state(9))
    out["restored_step"] = back["step"]
    for name, tree in (("params", back["params"]), ("mu", back["opt"]["mu"]),
                       ("nu", back["opt"]["nu"])):
        gathered = tsh.host_param_copy(tree)
        if r == 0:
            for path, t in tree_items(gathered):
                arrays[f"restored/{name}/{path}"] = t.numpy()

    if job["fit"]:
        out["fit"] = fit_resume(cfg, mesh, data["stream"], job_dir,
                                job["loader_batch"])

    np.savez(os.path.join(job_dir, f"rank{r}.npz"), **arrays)
    with open(os.path.join(job_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def fit_resume(cfg, mesh, stream, job_dir: str, batch: int) -> dict:
    """``fit`` over the mesh with a checkpoint every 2 steps: 4 steps at
    once, and 2 then a resume to 4 in another directory; the resumed
    losses and every piece against the uninterrupted run's."""

    def run(steps: int, name: str):
        pair = tsh.make_train_step(cfg, tsh.make_optimizer(lr=1e-3), mesh=mesh)
        loader = make_loader(stream, batch=batch, seq_len=15, mesh=mesh, seed=1)
        return fit(*pair, loader, steps=steps, seed=2,
                   ckpt_dir=os.path.join(job_dir, name), ckpt_every=2,
                   mesh=mesh)

    full, want = run(4, "fit_a")
    run(2, "fit_b")
    resumed, got = run(4, "fit_b")
    trees = [(resumed["params"], full["params"])] + [
        (resumed["opt"][m], full["opt"][m]) for m in ("mu", "nu")]
    pieces = [(a, b) for x, y in trees
              for a, b in zip(tsh.leaves(x), tsh.leaves(y))]
    return {"want": want, "got": got,
            "pieces_equal": all(torch.equal(a, b) for a, b in pieces),
            "files": sorted(os.listdir(os.path.join(job_dir, "fit_b")))}


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
