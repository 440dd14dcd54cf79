"""PyTorch port, expert parallelism and LoRA over a mesh: ``moe_ffn_sharded``
(with drops), ``dispatch_shardable``, the MoE forward and train step with
the mesh's model axis as the expert axis, and ``make_lora_train_step(mesh=)``
against the JAX package on the same numpy weights (fp32, the CPU; JAX on
the forced host devices, the port's mesh on its one device).

Capacity is per shard (``ceil(T_loc·K/E·factor)``), so where copies drop
``moe_ffn_sharded`` differs from ``moe_ffn``: it is held against JAX's
``moe_ffn_sharded``, 1e-5 on outputs and the aux term (the same fp32 sums
in another order; a copy routed to another slot or dropped moves an output
by O(1)). Losses within 2e-4 relative, as the flat step's
(``tests/test_torch_fsdp_tp.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from kata_xpu_device_plugin_tpu.models import mixtral as jmix
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import lora as jlora
from kata_xpu_device_plugin_tpu.ops import moe as jmoe
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import lora as tlora
from kata_xpu_device_plugin_tpu_torch.ops import moe as tmoe
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_parity import CONFIGS, numpy_pair

OUT_TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (mesh shape or ("expert", n), token shape, top_k, capacity factor)
CASES = {
    "expert4-drops": (("expert", 4), (2, 16), 2, 1.0),
    "train-mesh-k1-drops": ({"data": 2, "fsdp": 2, "model": 2}, (4, 8), 1, 0.5),
    "fsdp2-model2-seq-fallback": ({"fsdp": 2, "model": 2}, (2, 6), 2, 1.0),
    "expert2-flat-tokens": (("expert", 2), (12,), 2, 1.25),
}


def _meshes(shape):
    if isinstance(shape, tuple):
        return (jmoe.expert_mesh(shape[1], jax.devices()[:shape[1]]),
                tmesh.expert_mesh(shape[1], ["cpu"]))
    n = int(np.prod(list(shape.values())))
    return (jmesh.build_mesh(shape, jax.devices()[:n]),
            tmesh.build_mesh(shape, devices=["cpu"]))


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_sharded_matches_jax(case):
    """Outputs and aux against JAX's ``moe_ffn_sharded`` on the same
    weights and tokens, at capacities that drop copies, over an expert
    mesh, a data x fsdp x model mesh (experts over model), a (B, S) whose
    sequence takes the expert axis, and flat tokens; the port takes the
    expert stacks whole or as the list of their shards."""
    shape, lead, k, factor = CASES[case]
    rng = np.random.default_rng(len(case))
    d, f, E = 32, 48, 4
    kw = dict(d_model=d, d_ff=f, num_experts=E, capacity_factor=factor, top_k=k)
    p = {"router": rng.standard_normal((d, E)) / 6,
         "w_gate": rng.standard_normal((E, d, f)) / 6,
         "w_in": rng.standard_normal((E, d, f)) / 6,
         "w_out": rng.standard_normal((E, f, d)) / 7}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    x = rng.standard_normal(lead + (d,)).astype(np.float32)
    jm, tm = _meshes(shape)
    jcfg = jmoe.MoEConfig(**kw)
    jy, ja = jax.jit(lambda q, y: jmoe.moe_ffn_sharded(q, y, jcfg, jm))(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    tcfg = tmoe.MoEConfig(**kw)
    whole = {n: torch.from_numpy(v) for n, v in p.items()}
    ep = tm.shape[tmoe.expert_axis_for(tm)]
    split = {**whole, **{n: list(whole[n].chunk(ep)) for n in
                         ("w_gate", "w_in", "w_out")}}
    for params in (whole, split):
        ty, ta = tmoe.moe_ffn_sharded(params, torch.from_numpy(x), tcfg, tm)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    # Drops are per shard: where they happen the global dispatch differs.
    if case == "expert4-drops":
        gy, _ = tmoe.moe_ffn(whole, torch.from_numpy(x), tcfg)
        assert not np.allclose(gy.numpy(), ty.numpy(), atol=1e-3)


def test_dispatch_shardable_and_specs_match_jax():
    """``dispatch_shardable`` agrees with JAX's on a grid of token shapes,
    expert counts and meshes; ``expert_axis_for``, ``moe_param_specs`` and
    ``moe_ffn_sharded``'s refusals are JAX's."""
    for shape in (("expert", 2), ("expert", 4), {"data": 2, "fsdp": 2, "model": 2},
                  {"fsdp": 2, "model": 2}, {"model": 4}, {"fsdp": 2, "model": 2,
                                                          "seq": 2}):
        jm, tm = _meshes(shape)
        assert tmoe.expert_axis_for(tm) == jmoe.expert_axis_for(jm)
        for E in (2, 3, 4, 8):
            for lead in ((1, 8), (2, 6), (4, 4), (3, 5), (8, 2), 12, 16, 7):
                assert tmoe.dispatch_shardable(lead, E, tm) == \
                    jmoe.dispatch_shardable(lead, E, jm), (shape, E, lead)
    assert tmoe.expert_axis_for(None) == jmoe.expert_axis_for(None)
    assert tmoe.moe_param_specs() == {n: tuple(v) for n, v in
                                      jmoe.moe_param_specs().items()}
    # The refusals carry JAX's messages: experts or tokens that do not
    # divide over the mesh.
    jm, tm = _meshes(("expert", 4))
    kw = dict(d_model=8, d_ff=8, num_experts=6, top_k=1)
    w = {"router": np.zeros((8, 6), np.float32),
         **{n: np.zeros((6, 8, 8), np.float32) for n in ("w_gate", "w_in", "w_out")}}
    for x_shape, cfg_kw in (((2, 8, 8), kw), ((3, 3, 8), {**kw, "num_experts": 4}),
                            ((6, 8), {**kw, "num_experts": 4})):
        e = cfg_kw["num_experts"]
        p = {"router": w["router"][:, :e], **{n: w[n][:e] for n in
                                              ("w_gate", "w_in", "w_out")}}
        x = np.zeros(x_shape, np.float32)
        with pytest.raises(ValueError) as jerr:
            jmoe.moe_ffn_sharded({n: jnp.asarray(v) for n, v in p.items()},
                                 jnp.asarray(x), jmoe.MoEConfig(**cfg_kw), jm)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            tmoe.moe_ffn_sharded({n: torch.from_numpy(v) for n, v in p.items()},
                                 torch.from_numpy(x), tmoe.MoEConfig(**cfg_kw), tm)


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jmix.mixtral_test_config(dtype=jnp.float32, moe_capacity_factor=1.0)
    return numpy_pair(jcfg, seed=4) + (jcfg,)


def test_moe_forward_and_step_over_a_mesh_match_jax(mixtral):
    """The Mixtral test config (capacity factor 1: copies drop) over fsdp 2 x
    model 2: the forward with ``moe_mesh`` against JAX's, and one
    ``make_train_step`` step (experts over model, ``moe_ffn_sharded``
    dispatch) against JAX's: the loss, aux term included."""
    jp, tp, tcfg, jcfg = mixtral
    shape = {"fsdp": 2, "model": 2}
    jm = jmesh.build_mesh(shape, jax.devices()[:4])
    tm = tmesh.build_mesh(shape, devices=["cpu"])
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 16)).astype(
        np.int32)
    jl = jax.jit(lambda p, t: jt.forward(p, t, jcfg, moe_mesh=jm))(
        jp, jnp.asarray(toks))
    tl = tt.forward(tp, torch.from_numpy(toks).long(), tcfg, moe_mesh=tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-5)
    jopt = jsh.make_optimizer(lr=1e-3)
    _, jstep = jsh.make_train_step(jcfg, jm, jopt)
    params = jsh.shard_params(jax.tree.map(np.asarray, jp), jm)
    jstate = {"params": params,
              "opt": jax.jit(jopt.init, out_shardings=jsh._opt_shardings(
                  jopt, params, jm))(params),
              "step": jax.device_put(jnp.zeros((), jnp.int32),
                                     NamedSharding(jm, PartitionSpec()))}
    _, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
    topt = tsh.make_optimizer(lr=1e-3)
    _, tstep = tsh.make_train_step(tcfg, topt, mesh=tm)
    sp = tsh.shard_params(tp, tm)
    assert sp["layers"]["moe_w_gate"].cuts == (1, 2, 2, 1)
    tstate, lt = tstep({"params": sp, "opt": topt.init(sp), "step": 0}, toks)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-4)


def test_lora_train_step_over_a_mesh_matches_jax():
    """``make_lora_train_step(mesh=)`` over fsdp 2 x model 2 against JAX's
    from the same adapted tree (JAX's adapters through the bridge): two
    steps' losses and the trained adapters; the bases are pieces by their
    rules, ``a`` cut on its in axis and ``b`` on its out axis, the moments
    on the adapter pieces, and the bases never move."""
    jcfg = CONFIGS["llama3_test"]()
    jp, _, tcfg = numpy_pair(jcfg, seed=6)
    jad = jlora.apply_lora(jp, jax.random.PRNGKey(1), rank=4)
    # b = 0 would hide the adapters from the first step's loss: move it.
    rng = np.random.default_rng(0)
    jad = {**jad, "layers": {k: (v._replace(b=v.b + 0.05 * rng.standard_normal(
        v.b.shape).astype(np.float32)) if isinstance(v, jlora.LoRAWeight) else v)
        for k, v in jad["layers"].items()}}
    tad = bridge.params_from_numpy(jax.tree.map(np.asarray, jad), tcfg, "cpu")
    shape = {"fsdp": 2, "model": 2}
    jm = jmesh.build_mesh(shape, jax.devices()[:4])
    tm = tmesh.build_mesh(shape, devices=["cpu"])
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (4, 16)).astype(
        np.int32)
    jinit, jstep = jlora.make_lora_train_step(jcfg, lr=1e-3, mesh=jm)
    tinit, tstep = tlora.make_lora_train_step(tcfg, lr=1e-3, mesh=tm)
    jstate = jinit(jax.tree.map(np.asarray, jad))
    tstate = tinit(tad)
    wq = tstate["params"]["layers"]["wq"]
    assert (wq.base.cuts, wq.a.cuts, wq.b.cuts) == ((1, 2, 2), (1, 2, 1), (1, 1, 2))
    base_before = [t.clone() for t in tsh.leaves(wq.base)]
    for _ in range(2):
        jstate, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
        tstate, lt = tstep(tstate, toks)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-4)
    host = tsh.host_param_copy(tstate["params"])
    for name in ("wq", "wo"):
        for field in ("a", "b"):
            np.testing.assert_allclose(
                getattr(host["layers"][name], field).numpy(),
                np.asarray(getattr(jstate["params"]["layers"][name], field)),
                rtol=1e-3, atol=1e-4)
    for a, b in zip(tsh.leaves(tstate["params"]["layers"]["wq"].base), base_before):
        assert torch.equal(a, b)
