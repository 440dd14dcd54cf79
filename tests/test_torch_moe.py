"""PyTorch port, mixture of experts: ``ops.moe`` against the JAX package's
``ops/moe.py`` (routing, dispatch with and without capacity drops, the aux
term, int8 experts, the per-token reference), the Mixtral test config's
logits, aux and loss, one MoE train step, and MoE serving against the JAX
server (tokens, counters, events) slotted and paged, overlapped and
lock-step, on the same numpy weights (fp32, the CPU). Then the refusals
that stay: MoE under tensor parallelism (ROADMAP item 12b) and JAX's own
``top_k > num_experts``.

Tolerances: outputs of one MoE layer within 1e-5 (fp32, only the two
libraries' summation orders differ), model logits within 1e-4 of their
scale, losses within 1e-5 relative; tokens and counters equal."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import mixtral as jmixtral
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import moe as jmoe
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import mixtral as tmixtral
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.obs import devledger
from kata_xpu_device_plugin_tpu_torch.ops import moe as tmoe
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_parity import numpy_pair

MOE_TOL = dict(rtol=1e-5, atol=1e-5)


def _layer_params(seed: int, d=16, f=32, e=4):
    rng = np.random.default_rng(seed)

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return {"router": dense((d, e), d), "w_gate": dense((e, d, f), d),
            "w_in": dense((e, d, f), d), "w_out": dense((e, f, d), f)}


def _both(np_params, quantized=False):
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}
    if quantized:
        for k in ("w_gate", "w_in", "w_out"):
            jp[k] = jquant.quantize(jp[k])
            tp[k] = tquant.quantize(tp[k])
            np.testing.assert_array_equal(tp[k].q.numpy(), np.asarray(jp[k].q))
    return jp, tp


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("top_k,factor", [(1, 4.0), (2, 4.0), (2, 0.5), (3, 0.75)],
                         ids=["k1", "k2-ample", "k2-drops", "k3-drops"])
def test_moe_ffn_matches_jax(top_k, factor, quantized):
    """``moe_ffn`` against JAX's: outputs within 1e-5 and the aux term
    within 1e-6 relative, at ample capacity and at factors that drop
    copies (the count of kept copies checked to be short of T*K); int8
    expert stacks quantize bit-equal and stay within the same bound."""
    cfg_kw = dict(d_model=16, d_ff=32, num_experts=4, capacity_factor=factor,
                  top_k=top_k)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    jp, tp = _both(_layer_params(top_k * 10 + int(factor * 4)), quantized)
    x = np.random.default_rng(3).standard_normal((2, 9, 16)).astype(np.float32)
    yj, auxj = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    yt, auxt = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MOE_TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    gates, top_e, _ = tmoe._route(tp, torch.from_numpy(x).reshape(-1, 16), tcfg)
    *_, counts, _ = tmoe._dispatch(torch.from_numpy(x).reshape(-1, 16), top_e,
                                   gates, 4, tmoe.capacity(tcfg, 18))
    kept = int(torch.clamp(counts, max=tmoe.capacity(tcfg, 18)).sum())
    assert (kept < 18 * top_k) == (factor < 1.0)
    if factor >= 4.0:  # ample: the per-token reference, both packages
        ref = tmoe.reference_moe(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(yt.numpy(), ref.numpy(), **MOE_TOL)
        if not quantized:
            np.testing.assert_allclose(
                ref.numpy(), np.asarray(jmoe.reference_moe(jp, jnp.asarray(x), jcfg)),
                **MOE_TOL)


def test_routing_ties_take_the_lower_expert():
    """A router of zeros ties every expert: JAX's top_k takes experts 0..K-1,
    and so must the port (a stable descending sort)."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff=8, num_experts=6, top_k=3)
    p = {"router": torch.zeros(8, 6)}
    gates, top_e, _ = tmoe._route(p, torch.randn(5, 8), cfg)
    _, jtop_e, _ = jmoe._route({"router": jnp.zeros((8, 6))},
                               jnp.ones((5, 8)), jmoe.MoEConfig(8, 8, 6, top_k=3))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    assert torch.equal(top_e, torch.tensor([[0, 1, 2]] * 5))
    torch.testing.assert_close(gates, torch.full((5, 3), 1 / 3))


def test_dispatch_needs_no_host_sync_and_combines_in_expert_order():
    """No ``bincount`` (a host read of the size): the counts come from a
    scatter. A token's K copies are summed in ascending expert order, one
    after another, whatever order the dispatch holds them in."""
    torch.manual_seed(0)
    cfg = tmoe.MoEConfig(d_model=8, d_ff=16, num_experts=5, top_k=4,
                         capacity_factor=8.0)
    p = tmoe.init_moe_params(cfg, torch.Generator().manual_seed(1))
    x = torch.randn(7, 8)
    y, _ = tmoe.moe_ffn(p, x, cfg)
    gates, top_e, _ = tmoe._route(p, x, cfg)
    want = []
    for t in range(7):
        acc = torch.zeros(8)
        for j in torch.argsort(top_e[t]):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) * (x[t] @ p["w_in"][e])
            acc = acc + (h @ p["w_out"][e]) * gates[t, j]
        want.append(acc)
    torch.testing.assert_close(y, torch.stack(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.MoEConfig(d_model=8, d_ff=8, num_experts=2, top_k=3)


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jmixtral.mixtral_test_config(dtype=jnp.float32)
    return (jcfg,) + numpy_pair(jcfg, seed=4)


@pytest.fixture(scope="module")
def mixtral_1l():
    """One layer for the servers: routing and capacity act per layer, and
    the JAX servers' compiles (most of this file's time) shrink with it."""
    jcfg = jmixtral.mixtral_test_config(dtype=jnp.float32, n_layers=1)
    return (jcfg,) + numpy_pair(jcfg, seed=4)


def test_mixtral_configs_are_jax_s(mixtral):
    jcfg, _, _, tcfg = mixtral
    assert tcfg == tmixtral.mixtral_test_config(dtype=torch.float32)
    big_j = dataclasses.asdict(jmixtral.mixtral_8x7b())
    big_t = dataclasses.asdict(tmixtral.mixtral_8x7b())
    big_j.pop("dtype"), big_t.pop("dtype")
    assert big_t == big_j
    assert tmixtral.mixtral_8x7b().num_params() == jmixtral.mixtral_8x7b().num_params()
    assert tcfg.num_params() == jcfg.num_params()
    p = tt.init_params(tcfg, device="cpu")
    assert sum(t.numel() for t in tsh.leaves(p)) == tcfg.num_params()
    assert {"router", "moe_w_gate", "moe_w_in", "moe_w_out"} <= set(p["layers"])
    assert "w_gate" not in p["layers"]
    assert p["layers"]["moe_w_gate"].shape == (2, 4, 64, 128)


def test_mixtral_logits_aux_and_loss_match_jax(mixtral):
    """Logits within 1e-4 of their scale, the aux mean within 1e-6 relative
    and ``next_token_loss`` (cross-entropy + 0.01 x aux) within 1e-5."""
    jcfg, jp, tp, tcfg = mixtral
    toks = np.random.default_rng(5).integers(0, 256, (2, 11)).astype(np.int32)
    lj, auxj = jt.forward(jp, jnp.asarray(toks), jcfg, return_aux=True)
    lt, auxt = tt.forward(tp, torch.from_numpy(toks).long(), tcfg, return_aux=True)
    scale = float(np.abs(np.asarray(lj)).max())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    assert float(auxt) > 0
    np.testing.assert_allclose(
        float(tt.next_token_loss(tp, torch.from_numpy(toks).long(), tcfg)),
        float(jt.next_token_loss(jp, jnp.asarray(toks), jcfg)), rtol=1e-5)
    # fuse passes an MoE tree through, as JAX's does
    assert tt.fuse_decoder_params(tp) is tp
    # a dense config's aux is an fp32 zero
    dense = dataclasses.replace(tcfg, moe_num_experts=0)
    _, aux0 = tt.forward(tt.init_params(dense, device="cpu"),
                         torch.zeros((1, 3), dtype=torch.int64), dense,
                         return_aux=True)
    assert aux0.dtype == torch.float32 and float(aux0) == 0.0


def test_int8_mixtral_forward_matches_jax(mixtral):
    """Quantized expert stacks: payloads bit-equal to JAX's, scales ``[L,
    E, 1, out]``, the router fp; the int8 model's logits against the
    port's dequantized-weight model within 1e-4 of scale (the int8 expert
    einsums against JAX's are held in ``test_moe_ffn_matches_jax``)."""
    jcfg, jp, tp, tcfg = mixtral
    jq, tq = jquant.quantize_decoder_params(jp), tquant.quantize_decoder_params(tp)
    for k in ("moe_w_gate", "moe_w_in", "moe_w_out"):
        assert isinstance(tq["layers"][k], tquant.QTensor)
        L, E = tq["layers"][k].q.shape[:2]
        assert tq["layers"][k].scale.shape == (L, E, 1, tq["layers"][k].q.shape[-1])
        np.testing.assert_array_equal(tq["layers"][k].q.numpy(),
                                      np.asarray(jq["layers"][k].q))
    assert not isinstance(tq["layers"]["router"], tquant.QTensor)
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, (1, 9))).long()
    deq = dict(tq, layers={k: tquant.dequantize(v) if isinstance(v, tquant.QTensor)
                           else v for k, v in tq["layers"].items()})
    want = tt.forward(deq, toks, tcfg).numpy()
    lt = tt.forward(tq, toks, tcfg).numpy()
    np.testing.assert_allclose(lt, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_one_moe_train_step_matches_jax(mixtral):
    """One AdamW step of ``make_train_step`` on the Mixtral test config
    against JAX's on a one-device mesh: the loss (with the aux term) within
    1e-5 relative, every parameter within 1e-5 (the train tests' bound)."""
    jcfg, jp, tp, tcfg = mixtral
    kw = dict(lr=1e-3)
    mesh = jmesh.build_mesh({"data": 1, "fsdp": 1, "model": 1},
                            devices=jax.devices()[:1])
    _, jstep = jsh.make_train_step(jcfg, mesh, jsh.make_optimizer(**kw))
    # The JAX step donates its state: give it copies of the shared params.
    jparams = jsh.shard_params(jax.tree.map(jnp.copy, jp), mesh)
    jopt = jsh.make_optimizer(**kw)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    opt = tsh.make_optimizer(**kw)
    tp = {k: (dict(v) if isinstance(v, dict) else v.clone()) for k, v in tp.items()}
    tp["layers"] = {k: v.clone() for k, v in tp["layers"].items()}
    _, tstep = tsh.make_train_step(tcfg, opt, device="cpu")
    tstate = {"params": tp, "opt": opt.init(tp), "step": 0}
    toks = np.random.default_rng(7).integers(0, 256, (2, 13)).astype(np.int32)
    jstate, lj = jstep(jstate, jnp.asarray(toks))
    tstate, lt = tstep(tstate, toks)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    flat_j = {".".join(p.key for p in path): np.asarray(v) for path, v in
              jax.tree_util.tree_flatten_with_path(jstate["params"])[0]}
    for k, a in flat_j.items():
        head, _, tail = k.partition(".")
        got = tstate["params"][head][tail] if tail else tstate["params"][head]
        np.testing.assert_allclose(got.numpy(), a, rtol=0, atol=1e-5, err_msg=k)


# ----- serving --------------------------------------------------------------

LENGTHS = (5, 7, 11, 16, 3, 9)
BUDGETS = (6, 9, 4, 12, 7, 10)
KW = dict(max_len=48, prefill_buckets=(8, 16), chunk=4, heartbeat_rounds=2)
LAYOUTS = {
    "slotted": dict(max_batch=3),
    "paged": dict(max_batch=4, kv_pool_tokens=64, kv_block_size=4),
}
COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
            "preemptions")
TIMED = {"ts", "trace", "span", "parent", "server", "store", "mfu",
         "device_busy_frac", "tokens_per_s", "projected_itl_ms", "error"}
SKIP_EVENTS = {"tripwire_breach", "steady_state_compiles", "steady_state_reshards"}
BACKENDS = {"xla_reference": "reference", "pallas_paged": "cuda_paged"}


def _fields(ev):
    return {k: BACKENDS.get(v, v) if k == "backend" else v for k, v in ev.items()
            if k not in TIMED and not k.endswith(("_s", "_ms"))
            and not k.startswith("hbm_")}


def _serve(pkg, server, path):
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS]
    sink = pkg.EventSink(path)
    prev = pkg.set_default_sink(sink)
    try:
        rids = [server.submit(p, b) for p, b in zip(prompts, BUDGETS)]
        out = server.run()
    finally:
        pkg.set_default_sink(prev)
        sink.close()
    return [np.asarray(out[r]) for r in rids], pkg.read_events(path)


@pytest.mark.parametrize("overlap,layout,kv_quant", [
    (True, "paged", True), (False, "paged", True), (True, "slotted", True),
    (False, "slotted", False)],
    ids=["overlap-paged", "lockstep-paged", "overlap-slotted",
         "lockstep-slotted-fp-kv"])
def test_moe_server_matches_jax(mixtral_1l, tmp_path, overlap, layout, kv_quant):
    """The Mixtral test config served by both packages: every token, the
    counters and the event stream (names in order, deterministic fields
    equal). Each forward routes its own token set, dead lanes and bucket
    padding included, so equal tokens need the same calls on both sides;
    the paged pool is small enough to preempt. (Each JAX server compiles:
    four cases cover both loops, both layouts and both KV dtypes.)"""
    jcfg, jp, tp, tcfg = mixtral_1l
    kw = dict(overlap=overlap, kv_quant=kv_quant, **LAYOUTS[layout], **KW)
    jsrv = JaxServer(jp, jcfg, **kw)
    want, jev = _serve(jobs, jsrv, str(tmp_path / "j.jsonl"))
    tsrv = GenerationServer(tp, tcfg, device="cpu", **kw)
    got, tev = _serve(tobs, tsrv, str(tmp_path / "t.jsonl"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == list(BUDGETS)
    jstats, tstats = jsrv.stats(), tsrv.stats()
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    if layout == "paged":
        assert tstats["preemptions"] >= 1
    jev = [e for e in jev if e["name"] not in SKIP_EVENTS]
    tev = [e for e in tev if e["name"] not in SKIP_EVENTS]
    assert [e["name"] for e in tev] == [e["name"] for e in jev]
    for j, t in zip(jev, tev):
        assert _fields(t) == _fields(j), (j["name"], j, t)


@pytest.mark.parametrize("mode", [
    dict(persistent=True, **LAYOUTS["paged"]),
    dict(sched_policy="slo_chunked", itl_slo_ms=0, prefill_chunk=8, fused=True,
         **LAYOUTS["paged"]),
    dict(speculative_k=2, spec_opt_in=True, **LAYOUTS["slotted"])],
    ids=["persistent-paged", "slo-chunked-fused-paged", "speculative-slotted"])
def test_moe_server_modes_match_jax(mixtral_1l, mode):
    """Persistent rounds, fused chunked admission and n-gram speculation
    over the Mixtral test config (int8 KV; speculation is slotted, as in
    JAX): tokens and counters equal to the JAX server's. Chunk slices,
    verify spans and lanes past their exits route in their own forward
    calls, as in JAX."""
    jcfg, jp, tp, tcfg = mixtral_1l
    kw = dict(kv_quant=True, heartbeat_rounds=0,
              **{k: v for k, v in KW.items() if k != "heartbeat_rounds"}, **mode)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS]
    outs, stats = [], []
    for srv in (JaxServer(jp, jcfg, **kw),
                GenerationServer(tp, tcfg, device="cpu", **kw)):
        rids = [srv.submit(p, b) for p, b in zip(prompts, BUDGETS)]
        res = srv.run()
        outs.append([np.asarray(res[r]) for r in rids])
        stats.append(srv.stats())
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)
    assert {k: stats[1][k] for k in COUNTERS} == {k: stats[0][k] for k in COUNTERS}


def test_moe_under_tensor_parallelism_raises(mixtral):
    _, _, tp, tcfg = mixtral
    with pytest.raises(NotImplementedError, match="item 12b"):
        GenerationServer(tp, tcfg, device="cpu", max_batch=2, max_len=32, tp=2)


def test_devledger_counts_the_experts(mixtral):
    """An MoE dispatch's FLOPs: the router 2·T·d·E and the expert MLPs over
    every capacity slot 2·E·C·3·d·f a layer, per forward call (each
    decode step one call of ``lanes`` tokens, the slice another); bytes
    read every expert a step."""
    _, _, _, cfg = mixtral
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    lanes, steps = 3, 2
    got = devledger.decode_cost(cfg, lanes=lanes, steps=steps, keys=0.0,
                                kv_quant=False)
    C = tmoe.capacity(cfg.moe_cfg(), lanes)
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    dense = L * attn + d * cfg.vocab_size
    moe = L * (2 * lanes * d * E + 2 * E * C * 3 * d * f)
    assert got["flops"] == 2.0 * dense * lanes * steps + steps * moe
    wbytes = (dense + L * (d * E + E * 3 * d * f)) * 4
    assert got["bytes_accessed"] == steps * wbytes
    dense_cfg = dataclasses.replace(cfg, moe_num_experts=0)
    assert devledger.decode_cost(dense_cfg, lanes=lanes, steps=steps, keys=0.0,
                                 kv_quant=False)["flops"] == 2.0 * (
        dense + L * 3 * d * f) * lanes * steps
