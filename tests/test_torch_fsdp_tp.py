"""PyTorch port, training over data x fsdp x model (x seq) meshes: the
parameter rules and layouts, the sharded forward, ``make_train_step``,
``make_sharded_attention``, ring attention over batch and head shards,
the sharded checkpoint and ``fit`` against the JAX package on the same
numpy weights (fp32, the CPU; JAX on the 8 forced host devices of
``tests/conftest.py``, the port's mesh on its one device).

Tolerances: both sides compute the same fp32 arithmetic and differ only in
summation order (XLA's partitioned sums against the port's shard by shard
sums; a vocab-parallel log-sum-exp against a whole one): logits and the
loss within 2e-4 relative; seq x fsdp x model within 1e-3, JAX's own bound
for its ring step (``tests/test_parallel.py``). After two AdamW steps a
weight whose gradient is within rounding of zero can move by up to a
step's lr either way (``tests/test_torch_seq_parallel.py``), so every
weight is held within 2 x 2 x lr x 1.001 and all but one in 10^3 within
2e-4 relative (+1e-6).
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import collectives as jcoll
from kata_xpu_device_plugin_tpu.ops import lora as jlora
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu.parallel.flash_spmd import (
    make_sharded_attention as jsharded,
)
from kata_xpu_device_plugin_tpu.parallel.ring import make_ring_attention as jring
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import collectives as tcoll
from kata_xpu_device_plugin_tpu_torch.parallel import (
    TokenBatchLoader,
    TrainCheckpointer,
    fit,
    make_loader,
    make_sharded_attention,
)
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh
from kata_xpu_device_plugin_tpu_torch.parallel import spmd
from kata_xpu_device_plugin_tpu_torch.parallel.ring import (
    make_ring_attention as tring,
)

from .torch_parity import CONFIGS, numpy_pair

TOL = dict(rtol=2e-4, atol=2e-5)
LR = 1e-3
# name -> (the port's shape, JAX's shape or None for build_mesh(), devices)
MESHES = {
    "default8": (tmesh.default_mesh_shape(8), None, 8),
    "fsdp2-model2": ({"fsdp": 2, "model": 2}, {"fsdp": 2, "model": 2}, 4),
    "data2-fsdp2-model2": ({"data": 2, "fsdp": 2, "model": 2},
                           {"data": 2, "fsdp": 2, "model": 2}, 8),
}


def _tmesh(shape):
    return tmesh.build_mesh(shape, devices=["cpu"])


def _jmesh(name):
    _, shape, n = MESHES[name]
    return jmesh.build_mesh(shape, jax.devices()[:n])


def _spec(p):
    return tuple(p)


def _jspecs(tree):
    """JAX's spec tree with each PartitionSpec as a tuple."""
    return jax.tree.map(_spec, jsh.param_specs(tree),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def _specs_equal(port, jax_tree):
    if isinstance(port, dict):
        assert set(port) == set(jax_tree)
        for k in port:
            _specs_equal(port[k], jax_tree[k])
    elif hasattr(port, "_fields"):
        assert type(port).__name__ == type(jax_tree).__name__
        for a, b in zip(port, jax_tree):
            _specs_equal(a, b)
    else:
        assert port == jax_tree, (port, jax_tree)


@pytest.fixture(scope="module")
def llama():
    jcfg = CONFIGS["llama3_test"]()
    return numpy_pair(jcfg, seed=5) + (jcfg,)


def _tokens(cfg, B=4, S=32, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ----- rules, layouts, collectives -------------------------------------------


@pytest.mark.parametrize("layout", ["train", "fused", "int8", "lora", "moe"])
def test_param_specs_match_jax(layout):
    """``param_specs`` equals JAX's spec by spec: the training tree, the
    fused inference tree, int8 QTensors and LoRA adapters (a QLoRA base
    inside), and an MoE tree; ``PARAM_RULES`` is JAX's table."""
    assert {k: _spec(v) for k, v in jsh.PARAM_RULES.items()} == tsh.PARAM_RULES
    assert tuple(tuple(e) if isinstance(e, tuple) else e
                 for e in jsh.BATCH_SPEC) == tsh.BATCH_SPEC
    name = "mixtral" if layout == "moe" else "llama3_test"
    if name == "mixtral":
        from kata_xpu_device_plugin_tpu.models import mixtral as jmix

        jcfg = jmix.mixtral_test_config(dtype=jnp.float32)
    else:
        jcfg = CONFIGS[name]()
    jp, _, tcfg = numpy_pair(jcfg, seed=1)
    if layout == "fused":
        jp = jt.fuse_decoder_params(jp)
    if layout in ("int8", "lora"):
        jp = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
    if layout == "lora":
        jp = jlora.apply_lora(jp, jax.random.PRNGKey(0), targets=("wqkv", "wo"))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _specs_equal(tsh.param_specs(tp), _jspecs(jp))
    with pytest.raises(KeyError, match="no sharding rule for param 'nope'"):
        tsh.param_spec("nope")


def test_layouts_hold_each_parameter_once(llama):
    """``shard_params`` cuts every leaf into pieces of its rule (numels
    summing to the leaf's: no copies over data), ``host_param_copy`` gives
    the whole tensors back bit for bit, and ``init_sharded_params`` draws
    ``init_params``' values straight into the pieces."""
    _, tp, tcfg, _ = llama
    mesh = _tmesh({"data": 2, "fsdp": 2, "model": 2})
    sp = tsh.shard_params(tp, mesh)
    for name, leaf in sp["layers"].items():
        whole = tp["layers"][name]
        if isinstance(leaf, tsh.Sharded):
            assert sum(p.numel() for p in leaf.pieces) == whole.numel()
            assert len(leaf.pieces) == np.prod(leaf.cuts)
            assert 2 not in leaf.cuts[:1]  # the layer axis is never cut
        else:  # uncut: one tensor, a copy of its own
            assert torch.equal(leaf, whole) and leaf.data_ptr() != whole.data_ptr()
    assert sp["layers"]["wq"].cuts == (1, 2, 2)
    assert sp["embed"].cuts == (2, 2) and sp["unembed"].cuts == (2, 2)
    host = tsh.host_param_copy(sp)
    for a, b in zip(tsh.leaves(host), tsh.leaves(tp)):
        assert torch.equal(a, b)
    cfg = dataclasses.replace(tcfg, dtype=torch.float32)
    born = tsh.init_sharded_params(cfg, mesh, seed=4)
    ref = tt.init_params(cfg, seed=4, device="cpu")
    for a, b in zip(tsh.leaves(tsh.host_param_copy(born)), tsh.leaves(ref)):
        assert torch.equal(a, b)
    lay = tsh.param_shardings(tp, mesh)
    assert lay["layers"]["wo"].cuts == (1, 2, 2)
    assert tsh._opt_shardings(None, tp, mesh)["mu"]["layers"]["wo"] == lay["layers"]["wo"]


def test_collectives_match_jax():
    """``reduce_scatter`` against JAX's over 4 shards (each shard holds
    the whole tensor; shard j gets piece j of the sum)."""
    jm = jmesh.mesh_1d(4, "x", jax.devices()[:4])
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    want = np.asarray(jcoll.reduce_scatter(jm, jnp.asarray(x), "x"))
    got = tcoll.reduce_scatter([torch.from_numpy(x)] * 4)
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-6)


def test_mesh_constructors():
    """``pipe_mesh``, ``expert_mesh`` and ``composed_mesh`` name JAX's axes;
    ``composed_mesh`` raises JAX's error when the devices are too few; with
    no devices and no CUDA every constructor raises."""
    from kata_xpu_device_plugin_tpu.parallel import composed as jcomp

    assert tmesh.pipe_mesh(2, ["cpu"]).shape == {"pipe": 2}
    assert tmesh.expert_mesh(4, ["cpu"]).shape == {"expert": 4}
    assert tmesh.composed_mesh(2, 2, 2, ["cpu"] * 8).shape == {
        "pipe": 2, "fsdp": 2, "model": 2}
    with pytest.raises(ValueError) as jerr:
        jcomp.composed_mesh(2, 2, 2, jax.devices()[:4])
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        tmesh.composed_mesh(2, 2, 2, ["cpu"] * 4)
    if not torch.cuda.is_available():
        for fn in (lambda: tmesh.pipe_mesh(2), lambda: tmesh.expert_mesh(2),
                   lambda: tmesh.composed_mesh(1, 1, 1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


# ----- the sharded forward and step ------------------------------------------


@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_forward_matches_jax(llama, mesh_name):
    """The sharded forward's logits (vocab-parallel lookup, fsdp gathers,
    column/row-parallel products, the attention once over all heads when
    they do not divide) against JAX's forward on the same weights."""
    jp, tp, tcfg, jcfg = llama
    toks = _tokens(jcfg)
    want = np.asarray(jax.jit(lambda p, t: jt.forward(p, t, jcfg))(
        jp, jnp.asarray(toks)))
    mesh = _tmesh(MESHES[mesh_name][0])
    got = spmd.forward(tsh.shard_params(tp, mesh), torch.from_numpy(toks).long(),
                       tcfg, mesh)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _jax_state(jp, jm, jopt):
    # From numpy copies: the step donates its state, which must not take
    # the module's arrays with it.
    params = jsh.shard_params(jax.tree.map(np.asarray, jp), jm)
    return {"params": params,
            "opt": jax.jit(jopt.init, out_shardings=jsh._opt_shardings(
                jopt, params, jm))(params),
            "step": jax.device_put(jnp.zeros((), jnp.int32),
                                   NamedSharding(jm, PartitionSpec()))}


def _hold_params(tstate, jstate):
    host = tsh.host_param_copy(tstate["params"])
    far = total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate["params"])[0]:
        got = host
        for p in path:
            got = got[p.key]
        want = np.asarray(leaf)
        diff = np.abs(got.numpy() - want)
        assert diff.max() <= 2 * 2 * LR * 1.001, path
        far += int((diff > 2e-4 * np.abs(want) + 1e-6).sum())
        total += diff.size
    assert far <= total * 1e-3, (far, total)


def _run_pair(jcfg, jp, tp, tcfg, jm, tm, toks, steps=2, accum=1, clip=0.0):
    jopt = jsh.make_optimizer(lr=LR, grad_clip=clip)
    _, jstep = jsh.make_train_step(jcfg, jm, jopt, accum_steps=accum)
    jstate = _jax_state(jp, jm, jopt)
    topt = tsh.make_optimizer(lr=LR, grad_clip=clip)
    _, tstep = tsh.make_train_step(tcfg, topt, accum_steps=accum, mesh=tm)
    sp = tsh.shard_params(tp, tm)
    tstate = {"params": sp, "opt": topt.init(sp), "step": 0}
    for _ in range(steps):
        jstate, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
        tstate, lt = tstep(tstate, tsh.shard_batch(toks, tm))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-4)
    assert tstate["step"] == int(jstate["step"]) == steps
    return tstate, jstate


# fsdp 2 x model 2 takes accum_steps=2 and a clip that bites (0.5 of a norm
# near 1.7): one JAX compile a mesh.
STEP_KW = {"default8": {}, "fsdp2-model2": dict(accum=2, clip=0.5),
           "data2-fsdp2-model2": {}}


@pytest.mark.parametrize("mesh_name", MESHES)
def test_train_step_matches_jax(llama, mesh_name):
    """Two ``make_train_step`` steps over the mesh against JAX's from the
    same weights and tokens (on fsdp 2 x model 2 with ``accum_steps=2`` and
    a global-norm clip): each loss, then every leaf; the moments are
    pieces mirroring the parameters'. The clip's norm counts every piece
    once: the norm of a gradient's pieces is the whole gradient's."""
    jp, tp, tcfg, jcfg = llama
    tm = _tmesh(MESHES[mesh_name][0])
    tstate, jstate = _run_pair(jcfg, jp, tp, tcfg, _jmesh(mesh_name), tm,
                               _tokens(jcfg), **STEP_KW[mesh_name])
    _hold_params(tstate, jstate)
    mu = tstate["opt"]["mu"]["layers"]["wq"]
    assert isinstance(mu, tsh.Sharded)
    assert mu.cuts == tstate["params"]["layers"]["wq"].cuts
    g = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
         for i, p in enumerate(tsh.leaves(tp))]
    pieces = tsh.leaves(tsh.shard_params(tsh._rebuild(tp, g), tm))
    assert len(pieces) > len(g)
    np.testing.assert_allclose(float(tsh.global_norm(pieces)), float(
        optax.global_norm([jnp.asarray(x.numpy()) for x in g])), rtol=1e-6)


def test_seq_fsdp_model_step_matches_jax(llama):
    """A step over seq 2 x fsdp 2 x model 2: the ring per (batch shard,
    head shard) block, JAX's default ring with batch and head axes; the
    loss within JAX's 1e-3."""
    jp, tp, tcfg, jcfg = llama
    shape = {"fsdp": 2, "model": 2, "seq": 2}
    jm = jmesh.build_mesh(shape, jax.devices()[:8])
    jopt = jsh.make_optimizer(lr=LR)
    _, jstep = jsh.make_train_step(jcfg, jm, jopt)
    jstate = _jax_state(jp, jm, jopt)
    topt = tsh.make_optimizer(lr=LR)
    tm = _tmesh(shape)
    _, tstep = tsh.make_train_step(tcfg, topt, mesh=tm)
    sp = tsh.shard_params(tp, tm)
    tstate = {"params": sp, "opt": topt.init(sp), "step": 0}
    toks = _tokens(jcfg)
    _, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
    _, lt = tstep(tstate, toks)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)


# ----- attention over local blocks ----------------------------------------------


def _jax_vjp(fn, q, k, v, do):
    """``fn``'s output and its q/k/v cotangents under ``do``, jitted (one
    compile, not a dispatch per op)."""
    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    return run(*map(jnp.asarray, (q, k, v, do)))


def _qkv(seed, B=4, S=16, H=8, KV=4, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


@pytest.mark.parametrize("heads", [True, False])
def test_sharded_attention_matches_jax(heads):
    """``make_sharded_attention`` over data 2 x fsdp 2 x model 2 (heads over
    model, or whole) against JAX's on the same inputs: outputs and the
    gradients of q, k and v under a random cotangent, with a window and a
    softcap; the port's flash path (its plain version here) and its plain
    path agree."""
    shape = {"data": 2, "fsdp": 2, "model": 2}
    jm = jmesh.build_mesh(shape, jax.devices()[:8])
    axis = "model" if heads else None
    q, k, v, do = _qkv(1)
    kw = dict(window=6, logits_softcap=20.0)
    jfn = jsharded(jm, head_axis=axis, kv_head_axis=axis, use_flash=False)
    jo, jg = _jax_vjp(lambda *a: jfn(*a, **kw), q, k, v, do)
    for use_flash in (None, True):
        tfn = make_sharded_attention(_tmesh(shape), head_axis=axis,
                                     kv_head_axis=axis, use_flash=use_flash)
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        to = tfn(*xs, **kw)
        tg = torch.autograd.grad(to, xs, torch.from_numpy(do))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError) as jerr:
        jfn(*map(jnp.asarray, (q, k, v)), q_offset=jnp.int32(3))
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        tfn(*map(torch.from_numpy, (q, k, v)), q_offset=3)


def test_ring_over_batch_and_head_shards_matches_jax():
    """Ring attention over seq 2 with the batch over fsdp 2 and the heads
    over model 2 (the einsum path) against JAX's ring on the same axes."""
    shape = {"fsdp": 2, "model": 2, "seq": 2}
    jm = jmesh.build_mesh(shape, jax.devices()[:8])
    q, k, v, do = _qkv(2)
    jfn = jring(jm, batch_axes=("data", "fsdp"), head_axis="model",
                kv_head_axis="model", use_flash=False)
    jo, jg = _jax_vjp(jfn, q, k, v, do)
    tfn = tring(_tmesh(shape), batch_axes=("data", "fsdp"), head_axis="model",
                kv_head_axis="model")
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to = tfn(*xs)
    tg = torch.autograd.grad(to, xs, torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


# ----- the sharded checkpoint and fit -----------------------------------------------


def test_checkpoint_round_trip_across_meshes(tmp_path, llama):
    """A state saved under fsdp 2 x model 2 restores bit-equal under the same
    mesh and, into the layouts of fsdp 4 x model 2 and of whole tensors,
    with the same whole tensors; no temporary file is left behind."""
    _, tp, tcfg, jcfg = llama
    cfg = dataclasses.replace(tcfg, dtype=torch.float32)
    m22 = _tmesh({"fsdp": 2, "model": 2})
    init22, step22 = tsh.make_train_step(cfg, tsh.make_optimizer(lr=LR), mesh=m22)
    state = init22(1)
    state, _ = step22(state, _tokens(jcfg))
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(1, state)
    assert os.listdir(tmp_path) == ["step_1.pt"]
    again = ckpt.restore(init22(9), step=1)
    for a, b in zip(_tensors(again), _tensors(state)):
        assert torch.equal(a, b)
    assert again["step"] == 1 and again["opt"]["count"] == 1
    m42 = _tmesh({"fsdp": 4, "model": 2})
    init42, _ = tsh.make_train_step(cfg, tsh.make_optimizer(lr=LR), mesh=m42)
    wide = ckpt.restore(init42(9))
    assert wide["params"]["layers"]["wq"].cuts == (1, 4, 2)
    init1, _ = tsh.make_train_step(cfg, tsh.make_optimizer(lr=LR), device="cpu")
    flat = ckpt.restore(init1(9))
    for tree in (wide, flat):
        for a, b in zip(_tensors(tree, whole=True), _tensors(state, whole=True)):
            assert torch.equal(a, b)


def _tensors(state, whole=False):
    """The params' and moments' tensors (pieces, or whole with ``whole``)."""
    trees = (state["params"], state["opt"]["mu"], state["opt"]["nu"])
    if whole:
        trees = tuple(tsh.host_param_copy(t) for t in trees)
    return [t for tree in trees for t in tsh.leaves(tree)]


def test_fit_resumes_a_sharded_run(tmp_path, llama):
    """``fit`` over fsdp 2 x model 2 with a checkpoint every 2 steps,
    interrupted after 2 steps and resumed to 4, replays the uninterrupted
    4 steps' losses and state bit for bit; ``make_loader`` builds the
    loader as JAX's does on one process, and a process's stride takes its
    rows of the global batch."""
    _, _, tcfg, _ = llama
    cfg = dataclasses.replace(tcfg, dtype=torch.float32)
    mesh = _tmesh({"fsdp": 2, "model": 2})
    stream = np.random.default_rng(0).integers(0, cfg.vocab_size, 4 * 5 * 33)

    def run(steps, ckpt_dir):
        pair = tsh.make_train_step(cfg, tsh.make_optimizer(lr=LR), mesh=mesh)
        loader = make_loader(stream, batch=2, seq_len=32, mesh=mesh, seed=1)
        return fit(*pair, loader, steps=steps, seed=2, ckpt_dir=ckpt_dir,
                   ckpt_every=2)

    full, want = run(4, str(tmp_path / "a"))
    run(2, str(tmp_path / "b"))
    resumed, got = run(4, str(tmp_path / "b"))
    assert got == want[2:]
    for a, b in zip(tsh.leaves(resumed["params"]), tsh.leaves(full["params"])):
        assert torch.equal(a, b)
    with open(tmp_path / "b" / "loader_4.json") as f:
        assert json.load(f)["step_in_epoch"] >= 0
    assert isinstance(make_loader(stream, 2, 32), TokenBatchLoader)
    whole = next(make_loader(stream, 2, 32))
    stride = next(make_loader(stream, 2, 32, host_count=2, host_index=1))
    np.testing.assert_array_equal(stride, whole[1::2])
