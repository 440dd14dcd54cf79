"""PyTorch port, training over a process mesh: one shard a process, in
real gloo processes on the CPU (``tests/torch_procmesh_worker.py``, one
launch a mesh: ``{data: 2}``, ``{model: 2}``, ``{fsdp: 2, model: 2}``),
against JAX's mesh step on the forced host devices of
``tests/conftest.py`` and against the port's one-process mesh of the same
shape, from the same numpy weights and tokens (fp32).

What is held: ``init_sharded_params``' pieces on each rank against the
one-process mesh's and its tree against JAX's ``init_params``; each step's
loss and every leaf after two steps against JAX at ``test_torch_fsdp_tp.py``'s tolerances (fsdp 2 x model 2 with
``accum_steps=2`` and a clip that bites); the same against the
one-process mesh; every piece held by several ranks bit-equal across
them; each rank's pieces its share; each group collective bit-equal to
its list form; the loader's rows by batch coordinate; a process-mesh
checkpoint restored into the one-process mesh and back, bit for bit;
``fit`` resumed bit-equal; ``initialize_from_env`` under ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``; the axes a process mesh does not take yet.

Against the one-process mesh no leaf is required to come out bit-equal:
a rank sums its own rows' gradients and the ranks' sums are then added
(a reduce-scatter over fsdp, an all-reduce over data), where the
one-process step sums all rows in one product; over model the partial
gradients of a column-parallel input are added by the group after each
rank's own accumulation, where one process's autograd adds them in its
own order. Both are the same fp32 arithmetic in another order, so the
losses and moments agree within 2e-5 relative and the weights as
``_hold_params`` holds them against JAX, at 2e-5 in place of 2e-4.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import distributed as jdist
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu_torch.guest import distributed as tdist
from kata_xpu_device_plugin_tpu_torch.parallel import TrainCheckpointer
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .test_torch_fsdp_tp import LR, _hold_params, _jax_state, _tokens
from .torch_parity import CONFIGS, numpy_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_procmesh_worker.py")

# name -> (shape, step keywords, fit, config); fsdp 2 x model 2 takes
# accum 2 and a clip that bites (0.5 of a norm near 1.7), as
# test_torch_fsdp_tp's STEP_KW does, and the fit resume. model 2 runs the
# Gemma test config: one KV head, which model 2 does not divide, so q, k
# and v are gathered over the model line, and a tied, scaled embedding.
LAUNCHES = {
    "data2": ({"data": 2}, dict(accum=1, clip=0.0), False, "llama3_test"),
    "model2": ({"model": 2}, dict(accum=1, clip=0.0), False, "gemma_tiny"),
    "fsdp2-model2": ({"fsdp": 2, "model": 2}, dict(accum=2, clip=0.5), True,
                     "llama3_test"),
}
STEPS = 2
LOADER_BATCH = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _envs(n: int) -> list:
    """Each rank's identity: one host of ``n`` processes for two ranks;
    two hosts of two processes (worker id x 2 + local rank) for four."""
    if n == 2:
        return [{"LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"}
                for r in range(2)]
    return [{"TPU_WORKER_HOSTNAMES": "localhost,localhost",
             "TPU_WORKER_ID": str(r // 2), "LOCAL_RANK": str(r % 2),
             "LOCAL_WORLD_SIZE": "2"} for r in range(n)]


def _flat(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _whole(tree) -> dict:
    """A port state's param and moment trees gathered whole, flat."""
    out = {}
    for name, t in (("params", tree["params"]), ("mu", tree["opt"]["mu"]),
                    ("nu", tree["opt"]["nu"])):
        out.update(_flat(tsh.host_param_copy(t), name))
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in out.items()}


def _one_process(tcfg, tp, shape, toks, kw, steps):
    """The port's one-process mesh of ``shape`` stepped ``steps`` times
    from the weights: ``(state, losses)``."""
    tm = tmesh.build_mesh(shape, devices=["cpu"])
    opt = tsh.make_optimizer(lr=LR, grad_clip=kw["clip"])
    _, step = tsh.make_train_step(tcfg, opt, accum_steps=kw["accum"], mesh=tm)
    sp = tsh.shard_params(tp, tm)
    state = {"params": sp, "opt": opt.init(sp), "step": 0}
    losses = []
    for _ in range(steps):
        state, loss = step(state, tsh.shard_batch(toks, tm))
        losses.append(float(loss))
    return state, losses


def _jax_run(jcfg, jp, shape, toks, kw):
    n = int(np.prod(list(shape.values())))
    jm = jmesh.build_mesh(shape, jax.devices()[:n])
    jopt = jsh.make_optimizer(lr=LR, grad_clip=kw["clip"])
    _, jstep = jsh.make_train_step(jcfg, jm, jopt, accum_steps=kw["accum"])
    jstate = _jax_state(jp, jm, jopt)
    losses = []
    for _ in range(STEPS):
        jstate, loss = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
        losses.append(float(loss))
    return jstate, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's ranks started at once; while they run, JAX's step and
    the one-process mesh's on the same weights; then every rank's report."""
    models = {}
    for cname in {c for *_, c in LAUNCHES.values()}:
        jcfg = CONFIGS[cname]()
        jp, tp, tcfg = numpy_pair(jcfg, seed=5)
        models[cname] = (jcfg, jp, tp, tcfg, _tokens(jcfg), np.random.default_rng(
            0).integers(0, jcfg.vocab_size, 20 * 16).astype(np.int32))
    started = {}
    for name, (shape, kw, do_fit, cname) in LAUNCHES.items():
        jcfg, jp, tp, tcfg, toks, stream = models[cname]
        fields = {k: getattr(tcfg, k) for k in tcfg.__dataclass_fields__}
        fields["dtype"] = "float32"
        job = tmp_path_factory.mktemp(name)
        n = int(np.prod(list(shape.values())))
        # The one-process checkpoint the ranks restore: one step's state.
        state, _ = _one_process(tcfg, tp, shape, toks, kw, 1)
        TrainCheckpointer(str(job / "ckpt_in")).save(1, state)
        np.savez(job / "job.npz", tokens=toks, stream=stream,
                 **_flat(jax.tree.map(np.asarray, jp), "params"))
        with open(job / "job.json", "w") as f:
            json.dump({"cfg": fields, "shape": shape, "env": _envs(n),
                       "port": _free_port(), "lr": LR, "steps": STEPS,
                       "loader_batch": LOADER_BATCH, "fit": do_fit, **kw}, f)
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(job), str(i)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(n)]
        started[name] = (job, procs, state)
    out = {}
    for name, (shape, kw, _, cname) in LAUNCHES.items():
        jcfg, jp, tp, tcfg, toks, stream = models[cname]
        jstate, jlosses = _jax_run(jcfg, jp, shape, toks, kw)
        tstate, tlosses = _one_process(tcfg, tp, shape, toks, kw, STEPS)
        out[name] = dict(jax=(jstate, jlosses), port=(tstate, tlosses),
                         tcfg=tcfg, tp=tp, toks=toks, stream=stream)
    try:
        for p in (p for _, procs, _ in started.values() for p in procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in (p for _, procs, _ in started.values() for p in procs):
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (job, procs, ckpt_in_state) in started.items():
        reports, arrays = [], []
        for r in range(len(procs)):
            with open(job / f"rank{r}.json") as f:
                reports.append(json.load(f))
            arrays.append(dict(np.load(job / f"rank{r}.npz")))
        out[name].update(job=job, reports=reports, arrays=arrays,
                         ckpt_in=_whole(ckpt_in_state))
    return out


@pytest.mark.parametrize("name", LAUNCHES)
def test_ranks_join_by_local_rank(runs, name):
    """Each rank joined through ``initialize_from_env`` under
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (and worker ids on two hosts): its
    process id is its rank, the global devices are the world's processes,
    its coordinates are the row-major ones of ``build_mesh``, and a shape
    of another size raises."""
    shape = LAUNCHES[name][0]
    dims = tuple(shape.get(a, 1) for a in tmesh.MESH_AXES)
    for r, rep in enumerate(runs[name]["reports"]):
        s = rep["summary"]
        assert s["initialized"] and s["process_id"] == r == rep["rank"]
        assert s["global_devices"] == len(runs[name]["reports"])
        assert s["local_devices"] == 1
        assert tuple(rep["coords"][a] for a in tmesh.MESH_AXES) == \
            tuple(np.unravel_index(r, dims))
        assert "ranks" in rep["oversize_raises"]


@pytest.mark.parametrize("name", LAUNCHES)
def test_init_sharded_params_draws_each_ranks_piece(runs, name):
    """``init_sharded_params(cfg, mesh, seed=4)`` over the process mesh:
    each rank's own piece of every leaf is the one-process mesh's piece
    at the rank's coordinates, bit for bit, and the pieces gathered are
    ``init_params(cfg, seed=4)``. The tree is JAX's ``init_params(cfg,
    PRNGKey(4))``'s through the bridge: the same leaves and shapes, the
    leaves JAX draws constant (norm scales, biases) bit-equal, and the
    drawn ones at JAX's scale (normal / sqrt(fan_in)). JAX's draws
    themselves come from its own generator, which ``torch.Generator``
    does not reproduce."""
    from kata_xpu_device_plugin_tpu.models import transformer as jt
    from kata_xpu_device_plugin_tpu_torch.models import bridge

    run = runs[name]
    shape, cname = LAUNCHES[name][0], LAUNCHES[name][3]
    tcfg = run["tcfg"]
    tm = tmesh.build_mesh(shape, devices=["cpu"])
    born = _flat_layouts(tsh.init_sharded_params(tcfg, tm, seed=4))
    for rep, arrays in zip(run["reports"], run["arrays"]):
        assert rep["init_equal"], rep["rank"]
        held = {k[len("init/"):]: v for k, v in arrays.items()
                if k.startswith("init/")}
        assert {k.split("#")[0] for k in held} == set(born)
        for key, piece in held.items():
            path, idx = key.split("#")
            leaf = born[path]
            want = (leaf if idx == "whole" else leaf.pieces[int(idx)]).numpy()
            assert np.array_equal(piece, want), (rep["rank"], key)
    jcfg = CONFIGS[cname]()
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(4), jcfg))
    ref = _flat_layouts(bridge.params_from_numpy(jp, tcfg, "cpu"))
    whole = _flat_layouts(tsh.host_param_copy(
        tsh.init_sharded_params(tcfg, tm, seed=4)))
    assert set(ref) == set(whole)
    for path, j in ref.items():
        j, t = j.numpy(), whole[path].numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, path
        if np.all(j == j.flat[0]):
            assert np.array_equal(t, j), path
        else:
            assert abs(t.std() / j.std() - 1) < 0.1, path


@pytest.mark.parametrize("name", LAUNCHES)
def test_group_collectives_match_list_form(runs, name):
    """Every group collective (sum, max, gather, reduce-scatter,
    all-to-all, the neighbour hop, the ring sum, the overlapped sum) over
    each axis's line and over the whole mesh, and the gradients of the
    step's differentiable forms, bit-equal to the list form on every
    rank."""
    for rep in runs[name]["reports"]:
        for line, checks in rep["collectives"].items():
            assert checks and all(checks.values()), (line, checks)


@pytest.mark.parametrize("name", LAUNCHES)
def test_step_matches_jax(runs, name):
    """Two steps over the process mesh against JAX's mesh step: each loss
    within 2e-4 on every rank (the same value on all), then every leaf."""
    run = runs[name]
    jstate, jlosses = run["jax"]
    losses = [rep["losses"] for rep in run["reports"]]
    assert all(ls == losses[0] for ls in losses)
    np.testing.assert_allclose(losses[0], jlosses, rtol=2e-4)
    whole = run["arrays"][0]
    params = {}
    for key, v in whole.items():
        if key.startswith("whole/params/"):
            node = params
            *path, last = key.split("/")[2:]
            for p in path:
                node = node.setdefault(p, {})
            node[last] = torch.from_numpy(v)
    _hold_params({"params": params}, jstate)
    assert all(rep["step"] == STEPS for rep in run["reports"])


@pytest.mark.parametrize("name", LAUNCHES)
def test_step_matches_one_process_mesh(runs, name):
    """The same two steps on the port's one-process mesh of the same
    shape: losses within 2e-5 relative, every moment within 2e-5 relative
    (+1e-7), every weight within 2 x 2 x lr x 1.001 and all but one in
    10^3 within 2e-5 relative (+1e-7): the same arithmetic summed in
    another order (the module docstring says where), where a weight whose
    gradient is within rounding of zero may step by lr either way. No
    leaf comes out bit-equal."""
    run = runs[name]
    tstate, tlosses = run["port"]
    np.testing.assert_allclose(run["reports"][0]["losses"], tlosses, rtol=2e-5)
    want = _whole(tstate)
    got = {k[len("whole/"):]: v for k, v in run["arrays"][0].items()
           if k.startswith("whole/")}
    assert set(got) == set(want)
    far = total = 0
    for k in want:
        if not k.startswith("params/"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-7,
                                       err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * 2 * LR * 1.001, k
        far += int((diff > 2e-5 * np.abs(want[k]) + 1e-7).sum())
        total += diff.size
    assert far <= total * 1e-3, (far, total)


@pytest.mark.parametrize("name", LAUNCHES)
def test_pieces_held_twice_are_bit_equal(runs, name):
    """Every piece that several ranks hold (a replicated leaf on all; a
    piece over the axes that do not cut it) is the same bits on each,
    parameters and both moments, after the steps."""
    held = {}
    for arrays in runs[name]["arrays"]:
        for k, v in arrays.items():
            if k.startswith("piece/"):
                held.setdefault(k, []).append(v)
    assert held
    shared = 0
    for k, vs in held.items():
        shared += len(vs) > 1
        for v in vs[1:]:
            assert np.array_equal(v, vs[0]), k
    assert shared


@pytest.mark.parametrize("name", LAUNCHES)
def test_each_rank_holds_its_share(runs, name):
    """A rank's piece of each leaf is 1/(the cuts) of it, by the cuts the
    one-process mesh of the same shape gives the leaf; a leaf no axis of
    the mesh cuts is whole."""
    run = runs[name]
    shape = LAUNCHES[name][0]
    layouts = _flat_layouts(tsh.param_shardings(run["tp"], tmesh.build_mesh(
        shape, devices=["cpu"])))
    for rep in run["reports"]:
        for path, (numel, whole, cuts) in rep["share"].items():
            want = layouts[path].cuts
            assert tuple(cuts) == (want if np.prod(want) > 1 else ()), path
            assert numel * int(np.prod(want)) == whole, path


def _flat_layouts(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_layouts(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("name", LAUNCHES)
def test_loader_rows_by_batch_coordinate(runs, name):
    """``make_loader`` under the mesh: the model ranks of one (data, fsdp)
    coordinate read the same rows, and the coordinates' rows are the
    global batch's, each once (the stride of the one-process loader)."""
    from kata_xpu_device_plugin_tpu_torch.parallel import make_loader

    run = runs[name]
    whole = make_loader(run["stream"], LOADER_BATCH, 15, seed=1)
    want = [next(whole), next(whole)]
    by_coord = {}
    for rep, arrays in zip(run["reports"], run["arrays"]):
        c = rep["coords"]
        key = (c["data"], c["fsdp"])
        if key in by_coord:
            np.testing.assert_array_equal(arrays["rows"], by_coord[key])
        by_coord[key] = arrays["rows"]
    nf = LAUNCHES[name][0].get("fsdp", 1)
    count = len(by_coord)
    for (d, f), rows in by_coord.items():
        for b in range(2):
            np.testing.assert_array_equal(rows[b], want[b][d * nf + f::count])


@pytest.mark.parametrize("name", LAUNCHES)
def test_checkpoint_round_trip_with_one_process_mesh(runs, name):
    """The process mesh's checkpoint (each rank's pieces, rank 0's
    manifest) restored into the one-process mesh of the same shape gives
    the ranks' state bit for bit; the one-process checkpoint restored on
    the ranks gives its state bit for bit."""
    run = runs[name]
    shape = LAUNCHES[name][0]
    tm = tmesh.build_mesh(shape, devices=["cpu"])
    init, _ = tsh.make_train_step(run["tcfg"], tsh.make_optimizer(lr=LR),
                                  mesh=tm)
    ckpt = TrainCheckpointer(str(run["job"] / "ckpt_out"))
    assert ckpt.steps() == [STEPS]
    got = _whole(ckpt.restore(init(9)))
    ranks = {k[len("whole/"):]: v for k, v in run["arrays"][0].items()
             if k.startswith("whole/")}
    assert set(got) == set(ranks)
    for k, v in got.items():
        assert np.array_equal(v, ranks[k]), k
    back = {k[len("restored/"):]: v for k, v in run["arrays"][0].items()
            if k.startswith("restored/")}
    assert set(back) == set(run["ckpt_in"])
    for k, v in run["ckpt_in"].items():
        assert np.array_equal(back[k], v), k
    assert all(rep["restored_step"] == 1 for rep in run["reports"])


def test_fit_resumes_a_process_mesh_run(runs):
    """``fit`` over fsdp 2 x model 2 with a checkpoint every 2 steps,
    interrupted after 2 steps and resumed to 4, replays the uninterrupted
    run's losses and every rank's pieces bit for bit; the directory holds
    rank 0's manifests and cursors and the other ranks' piece files."""
    run = runs["fsdp2-model2"]
    for rep in run["reports"]:
        f = rep["fit"]
        assert f["got"] == f["want"][2:] and f["pieces_equal"]
        assert len(set(map(tuple, [r["fit"]["want"] for r in run["reports"]]))) == 1
    files = run["reports"][0]["fit"]["files"]
    assert {"step_2.pt", "step_4.pt", "loader_2.json", "loader_4.json",
            "step_4.rank1.pt", "step_4.rank2.pt", "step_4.rank3.pt"} <= set(files)
    assert not any(n.endswith(".tmp") for n in files)


@pytest.mark.parametrize("axis", ["seq", "pipe", "expert"])
def test_axes_not_over_processes_raise(axis):
    """A process mesh with a seq, pipe or expert axis raises, naming what
    is not ported yet; no process group is needed to say so."""
    with pytest.raises(ValueError, match="not ported yet"):
        tmesh.process_mesh({axis: 2, "fsdp": 2}, device="cpu")


@pytest.mark.parametrize("env,want", [
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, (4, 1, "localhost:8476")),
    ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "1",
      "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}, (8, 6, "a:8476")),
    ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "1"}, (2, 1, "a:8476")),
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, (1, 0, None)),
])
def test_resolve_reads_local_ranks(env, want):
    """``resolve`` under torchrun's names: global rank = worker id x
    processes a host + ``LOCAL_RANK``, world = hosts x processes a host;
    without them one process a host, JAX's config; a dry run keeps JAX's
    summary keys."""
    cfg = tdist.resolve(env)
    assert (cfg.num_processes, cfg.process_id, cfg.coordinator_address) == want
    assert set(tdist.initialize_from_env(env, dry_run=True)) == set(
        jdist.initialize_from_env({}, dry_run=True))
    if "LOCAL_RANK" not in env:
        j = jdist.resolve(env)
        assert (j.num_processes, j.process_id, j.coordinator_address) == want


@pytest.mark.parametrize("env", [
    {"LOCAL_RANK": "4", "LOCAL_WORLD_SIZE": "4"},
    {"LOCAL_RANK": "x", "LOCAL_WORLD_SIZE": "2"},
    {"LOCAL_RANK": "1"},
])
def test_resolve_refuses_a_bad_local_place(env):
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        tdist.resolve(env)


def _unjoined_process_mesh():
    """A process mesh's shape with no group behind it: enough for the
    entry points that refuse one before any collective."""
    procs = tmesh.MeshProcesses(0, (0, 0, 0), None, "gloo", {}, None, None)
    return tmesh.Mesh(tmesh.MESH_AXES, (1, 1, 2), torch.device("cpu"), procs)


@pytest.mark.parametrize("entry", ["server", "lora", "moe"])
def test_paths_not_over_processes_refuse_a_process_mesh(entry):
    """Serving over a process mesh, LoRA training over one and an MoE
    step over one are not ported yet: each raises, naming it, before any
    collective."""
    from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh
    from kata_xpu_device_plugin_tpu_torch.models import mixtral_test_config
    from kata_xpu_device_plugin_tpu_torch.ops.lora import make_lora_train_step

    mesh = _unjoined_process_mesh()
    cfg = mixtral_test_config(dtype=torch.float32)
    with pytest.raises(ValueError, match="process mesh is not ported yet"):
        if entry == "server":
            ServingMesh.for_mesh(cfg, mesh)
        elif entry == "lora":
            make_lora_train_step(cfg, mesh=mesh)
        else:
            tsh.make_train_step(cfg, mesh=mesh)
