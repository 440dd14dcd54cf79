"""PyTorch port, pipeline parallelism: the GPipe schedule
(``make_pipeline``, ``make_transformer_pipeline``) and the composed
pp x fsdp x tp loss and step against ``sequential_reference`` and the JAX
package on the same numpy weights (fp32, the CPU; JAX on the forced host
devices, the port's mesh on its one device).

Tolerances: the same fp32 arithmetic in another summation order, as in
``tests/test_torch_fsdp_tp.py``: activations and logits 1e-5 (a stage is
one or two layers), losses 1e-5 relative (JAX's own bound between its
pipelined and unpipelined losses), the composed step's losses within JAX's
2e-4 of its step against the flat one; a schedule that lost or reordered
a microbatch moves values by O(1).
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
from kata_xpu_device_plugin_tpu.parallel import composed as jcomp
from kata_xpu_device_plugin_tpu.parallel import pipeline as jpipe
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu_torch.obs import devledger
from kata_xpu_device_plugin_tpu_torch.parallel import composed as tcomp
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import pipeline as tpipe
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_parity import numpy_pair

M, MB, S = 4, 2, 16


@pytest.fixture(scope="module")
def tiny():
    jcfg = jt.tiny_test_config(n_layers=4, dtype=jnp.float32)
    return numpy_pair(jcfg, seed=7) + (jcfg,)


def _tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (M, MB, S)).astype(np.int32)


def _pp_pieces(tp, mesh, n_stages):
    """The port's stage-major pieces of whole params on ``mesh``."""
    pp = tcomp.to_pp_params(tp, n_stages)
    lay = tcomp.pp_param_shardings(pp, mesh)
    out = {k: lay[k].cut(v, copy=True) for k, v in pp.items() if k != "layers"}
    out["layers"] = {k: lay["layers"][k].cut(v, copy=True)
                     for k, v in pp["layers"].items()}
    return out


def test_make_pipeline_matches_sequential_and_jax():
    """A 3-stage pipeline of a non-linear stage over 5 microbatches
    against ``sequential_reference`` and JAX's pipeline; the schedule makes
    exactly M x P stage calls (the bubbles skipped)."""
    rng = np.random.default_rng(0)
    P_, d = 3, 8
    ws = [rng.standard_normal((d, d)).astype(np.float32) / 3 for _ in range(P_)]
    mbs = rng.standard_normal((5, 2, d)).astype(np.float32)
    calls = []

    def tstage(w, x):
        calls.append(1)
        return torch.tanh(x @ w) + x

    def jstage(w, x):
        return jnp.tanh(x @ w) + x

    tstack = tpipe.stack_stage_params([torch.from_numpy(w) for w in ws])
    got = tpipe.make_pipeline(tstage, P_, tmesh.pipe_mesh(P_, ["cpu"]))(
        tstack, torch.from_numpy(mbs))
    assert len(calls) == 5 * P_
    ref = tpipe.sequential_reference(tstage, [torch.from_numpy(w) for w in ws],
                                     torch.from_numpy(mbs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    jm = jpipe.pipe_mesh(P_, jax.devices()[:P_])
    want = jpipe.make_pipeline(jstage, P_, jm)(
        jpipe.stack_stage_params([jnp.asarray(w) for w in ws]), jnp.asarray(mbs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError) as jerr:
        jpipe.make_pipeline(jstage, 2, jm)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        tpipe.make_pipeline(tstage, 2, tmesh.pipe_mesh(P_, ["cpu"]))


def test_transformer_pipeline_matches_jax(tiny):
    """``make_transformer_pipeline`` over 2 stages of 2 layers: logits
    against JAX's pipeline and the port's own unpipelined forward."""
    jp, tp, tcfg, jcfg = tiny
    toks = _tokens(jcfg)
    want = jax.jit(jpipe.make_transformer_pipeline(
        jcfg, 2, jpipe.pipe_mesh(2, jax.devices()[:2])))(jp, jnp.asarray(toks))
    got = tpipe.make_transformer_pipeline(tcfg, 2, tmesh.pipe_mesh(2, ["cpu"]))(
        tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

    flat = tt.forward(tp, torch.from_numpy(toks.reshape(M * MB, S)).long(), tcfg)
    np.testing.assert_allclose(got.reshape(flat.shape).numpy(), flat.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1), (2, 1, 4)])
def test_pp_loss_matches_jax(tiny, shape):
    """``make_pp_loss`` on each mesh against JAX's ``next_token_loss`` on
    the flattened batch (JAX's own pairing), and on (2, 2, 2) against
    JAX's ``make_pp_loss`` itself."""
    jp, tp, tcfg, jcfg = tiny
    pipe, fsdp, model = shape
    toks = _tokens(jcfg)
    ref = float(jax.jit(lambda p, t: jt.next_token_loss(p, t, jcfg))(
        jp, jnp.asarray(toks.reshape(M * MB, S))))
    tm = tcomp.composed_mesh(pipe, fsdp, model, ["cpu"] * 8)
    got = float(tcomp.make_pp_loss(tcfg, tm, pipe, M)(
        _pp_pieces(tp, tm, pipe), tcomp.shard_microbatches(toks, tm)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    if shape == (2, 2, 2):
        jm = jcomp.composed_mesh(*shape)
        jtree = jcomp.to_pp_params(jp, pipe)
        jpp = jax.device_put(jtree, jcomp.pp_param_shardings(jtree, jm))
        want = float(jax.jit(jcomp.make_pp_loss(jcfg, jm, pipe, M))(
            jpp, jcomp.shard_microbatches(jnp.asarray(toks), jm)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pp_train_step_matches_jax(tiny):
    """Two ``make_pp_train_step`` steps on (2, 2, 2) against JAX's from the
    same weights: each loss; the moments mirror the stage-major pieces; the
    ledger's matmul parameters count the model once."""
    jp, tp, tcfg, jcfg = tiny
    toks = _tokens(jcfg)
    jm = jcomp.composed_mesh(2, 2, 2)
    jopt = jsh.make_optimizer(lr=1e-3)
    _, jstep = jcomp.make_pp_train_step(jcfg, jm, 2, M, jopt)
    jtree = jcomp.to_pp_params(jax.tree.map(np.asarray, jp), 2)
    jparams = jax.device_put(jtree, jcomp.pp_param_shardings(jtree, jm))
    jstate = {"params": jparams,
              "opt": jax.jit(jopt.init, out_shardings=jcomp._pp_opt_shardings(
                  jopt, jparams, jm))(jparams),
              "step": jax.device_put(jnp.zeros((), jnp.int32),
                                     NamedSharding(jm, PartitionSpec()))}
    tm = tcomp.composed_mesh(2, 2, 2, ["cpu"] * 8)
    topt = tsh.make_optimizer(lr=1e-3)
    _, tstep = tcomp.make_pp_train_step(tcfg, tm, 2, M, topt)
    pieces = _pp_pieces(tp, tm, 2)
    tstate = {"params": pieces, "opt": topt.init(pieces), "step": 0}
    for _ in range(2):
        jstate, lj = jstep(jstate, jcomp.shard_microbatches(jnp.asarray(toks), jm))
        tstate, lt = tstep(tstate, toks)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-4)
    assert tstate["step"] == 2
    wq = tstate["params"]["layers"]["wq"]
    assert wq.cuts == (2, 1, 2, 2) and tstate["opt"]["mu"]["layers"]["wq"].cuts == wq.cuts
    assert tcomp._pp_opt_shardings(topt, pieces, tm)["mu"]["layers"]["wq"].cuts == wq.cuts
    mm = sum(tsh.local(tstate["params"]["layers"][k]).numel()
             for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    mm += tstate["params"]["embed"].shape.numel()  # tied: the unembedding
    assert mm == devledger.matmul_params(tcfg)


def test_pp_train_step_init_matches_the_flat_step():
    """``init_state(seed)`` of the composed step draws ``init_params(cfg,
    seed)``'s values (as the flat step's does), so both start from the
    same model; a step's loss equals the flat step's on the same batch."""
    from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

    cfg = tt.tiny_test_config(n_layers=4, dtype=torch.float32)
    tm = tcomp.composed_mesh(2, 2, 2, ["cpu"] * 8)
    init, step = tcomp.make_pp_train_step(cfg, tm, 2, M)
    state = init(3)
    host = tsh.host_param_copy(state["params"])
    ref = tt.init_params(cfg, seed=3, device="cpu")
    for k, v in ref["layers"].items():
        assert torch.equal(host["layers"][k].reshape(v.shape), v)
    flat_init, flat_step = tsh.make_train_step(
        cfg, mesh=tmesh.build_mesh({"fsdp": 4, "model": 2}, devices=["cpu"]))
    toks = _tokens(cfg)
    _, lp = step(state, toks)
    _, lf = flat_step(flat_init(3), toks.reshape(M * MB, S))
    np.testing.assert_allclose(float(lp), float(lf), rtol=1e-5)


def test_refusals_carry_jax_messages(tiny):
    """Each refusal of the pipeline and the composed loss raises JAX's
    ``ValueError`` with JAX's message: MoE stages, indivisible layers,
    per-layer windows and rope cycles, indivisible microbatches."""
    _, _, tcfg, jcfg = tiny
    import dataclasses

    from kata_xpu_device_plugin_tpu_torch.models import mixtral as tmix

    jm = jcomp.composed_mesh(2, 2, 2)
    tm = tcomp.composed_mesh(2, 2, 2, ["cpu"] * 8)
    jwin = dataclasses.replace(jcfg, attn_windows=(8, 0))
    twin = dataclasses.replace(tcfg, attn_windows=(8, 0))
    cases = [
        (lambda: jpipe.transformer_stage_fn(jmix.mixtral_test_config()),
         lambda: tpipe.transformer_stage_fn(tmix.mixtral_test_config())),
        (lambda: jpipe.make_transformer_pipeline(jcfg, 3, jpipe.pipe_mesh(
            3, jax.devices()[:3])),
         lambda: tpipe.make_transformer_pipeline(tcfg, 3, tmesh.pipe_mesh(
             3, ["cpu"]))),
        (lambda: jpipe.make_transformer_pipeline(jwin, 2, jpipe.pipe_mesh(
            2, jax.devices()[:2])),
         lambda: tpipe.make_transformer_pipeline(twin, 2, tmesh.pipe_mesh(
             2, ["cpu"]))),
        (lambda: jcomp.make_pp_loss(jcfg, jm, 3, M),
         lambda: tcomp.make_pp_loss(tcfg, tm, 3, M)),
        (lambda: jcomp.make_pp_loss(jcfg, jm, 2, 3),
         lambda: tcomp.make_pp_loss(tcfg, tm, 2, 3)),
        (lambda: jcomp.make_pp_loss(jwin, jm, 2, M),
         lambda: tcomp.make_pp_loss(twin, tm, 2, M)),
    ]
    for jfn, tfn in cases:
        with pytest.raises(ValueError) as jerr:
            jfn()
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            tfn()
