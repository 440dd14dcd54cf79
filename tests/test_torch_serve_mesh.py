"""PyTorch port, serving over a caller's training mesh: the port's
``GenerationServer(mesh=build_mesh(...))`` against the JAX server's
``GenerationServer(mesh=...)`` (on the 8 forced host devices of
``tests/conftest.py``), on the same weights (fp32, the CPU): greedy
tokens, the ``stats()`` counters and the event streams equal over fsdp 2 x
model 2, data 2 x model 2 and model 4 meshes, slotted and paged servers,
int8 and fp KV, overlapped and lock-step rounds, plain, fused, int8 and
LoRA trees, a one-KV-head config whose KV replicates
(``kv_replicated`` with JAX's ``extra_bytes``), and a Mixtral test config
whose expert stacks the training rules cut over model and fsdp, at a
capacity factor that drops copies. Then the port alone: fp32
prefill logits against JAX's forward within 1e-4 of their scale (the
row-parallel sums add in another order); a tree born sharded
(``init_sharded_params``) serves as the plain tree it equals and is taken
as it is; a draft placed on the same mesh; ``tp=`` with ``mesh=`` raises
JAX's error; a permanent fault fails the load loudly (no shrink)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import mixtral as jmixtral
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import lora as jlora
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import kv_cache_spec
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import moe as tmoe
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_faults import injector, outcome, read_events
from .torch_parity import CONFIGS, numpy_pair

PROMPT_LENGTHS = (5, 12, 9, 3, 7)
BUDGETS = (8, 6, 10, 12, 5)
KW = dict(max_len=48, prefill_buckets=(8, 16), chunk=4, heartbeat_rounds=2)
LAYOUTS = {
    "slotted": dict(max_batch=3),
    "paged": dict(max_batch=4, kv_pool_tokens=64, kv_block_size=4),
}
COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
            "preemptions", "tp_degree", "kv_pool_shards", "kv_layout")
TIMED = {"ts", "trace", "span", "parent", "server", "store", "mfu",
         "device_busy_frac", "tokens_per_s", "projected_itl_ms", "error"}
SKIP_EVENTS = {"tripwire_breach", "steady_state_compiles", "steady_state_reshards"}
BACKENDS = {"xla_reference": "reference", "pallas_paged": "cuda_paged"}
# JAX's overlapped model-axis sum (a reduce-scatter then an all-gather)
# hides communication that shards on one device do not have: the port
# reports it off (guest/tp_serving.py).
UNPORTED_FIELDS = {"tp_overlap"}


def _fields(ev):
    return {k: BACKENDS.get(v, v) if k == "backend" else v for k, v in ev.items()
            if k not in TIMED | UNPORTED_FIELDS
            and not k.endswith(("_s", "_ms")) and not k.startswith("hbm_")}


@pytest.fixture(scope="module")
def tiny():
    """8 query heads over 2 KV heads: model 2 cuts the KV heads, model 4
    replicates them."""
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + numpy_pair(jcfg, seed=21)


@pytest.fixture(scope="module")
def gemma_1kv():
    """Gemma-2B's flags at test widths: one KV head, which no model axis
    divides."""
    jcfg = CONFIGS["gemma_tiny"]()
    return (jcfg,) + numpy_pair(jcfg, seed=22)


@pytest.fixture(scope="module")
def mixtral_drops():
    """Mixtral's flags at test widths, 4 experts (2 a model shard), at a
    capacity factor of 0.5: the one global dispatch drops copies, where a
    per-shard capacity would drop others."""
    jcfg = jmixtral.mixtral_test_config(dtype=jnp.float32, n_layers=1,
                                        moe_capacity_factor=0.5)
    return (jcfg,) + numpy_pair(jcfg, seed=23)


def _tree(kind, jp, tcfg):
    """JAX's tree of ``kind`` and the port's copy of it."""
    if kind == "fused":
        jp = jt.fuse_decoder_params(jp)
    elif kind == "int8":
        jp = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
    elif kind == "lora":
        jp = jlora.apply_lora(jp, jax.random.PRNGKey(5), rank=4)
        rng = np.random.default_rng(6)
        layers = dict(jp["layers"])
        for k, v in layers.items():
            if isinstance(v, jlora.LoRAWeight):
                b = (0.1 * rng.standard_normal(v.b.shape)).astype(np.float32)
                layers[k] = v._replace(b=jnp.asarray(b))
        jp = {**jp, "layers": layers}
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _meshes(shape):
    n = int(np.prod(list(shape.values())))
    return (jmesh.build_mesh(shape, devices=jax.devices()[:n]),
            tmesh.build_mesh(shape, devices=["cpu"]))


def _prompts(vocab):
    rng = np.random.default_rng(8)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENGTHS]


def _serve(pkg, make, path, prompts):
    """``make()``'s server (built under the sink, so its construction
    events count) over ``prompts``: ``(server, tokens, events)``."""
    sink = pkg.EventSink(path)
    prev = pkg.set_default_sink(sink)
    try:
        server = make()
        rids = [server.submit(p, b) for p, b in zip(prompts, BUDGETS)]
        out = server.run()
    finally:
        pkg.set_default_sink(prev)
        sink.close()
    return server, [np.asarray(out[r]) for r in rids], pkg.read_events(path)


CASES = {
    "fsdp2xmodel2-slotted-fused-overlap": (
        "tiny", {"fsdp": 2, "model": 2}, "fused", "slotted", True, True),
    "data2xmodel2-paged-lockstep": (
        "tiny", {"data": 2, "model": 2}, "plain", "paged", True, False),
    "model4-paged-fpkv-overlap": (
        "tiny", {"model": 4}, "plain", "paged", False, True),
    "fsdp2xmodel2-paged-int8w": (
        "tiny", {"fsdp": 2, "model": 2}, "int8", "paged", True, True),
    "fsdp2xmodel2-slotted-lora-lockstep": (
        "tiny", {"fsdp": 2, "model": 2}, "lora", "slotted", True, False),
    "gemma1kv-fsdp2xmodel2-paged": (
        "gemma_1kv", {"fsdp": 2, "model": 2}, "plain", "paged", True, True),
    "mixtral-drops-fsdp2xmodel2-paged": (
        "mixtral_drops", {"fsdp": 2, "model": 2}, "plain", "paged", True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_server_matches_jax(request, monkeypatch, tmp_path, case):
    """One mesh, tree and server form a case: every token, the counters and
    the event stream (names in order, deterministic fields equal) against
    JAX's mesh server; the port's mesh server also gives its own unsharded
    server's tokens (a training layout changes no greedy token at fp32).
    An MoE config's mesh server runs the shards' experts on the one global
    dispatch (``moe_ffn_tp``), and copies drop there."""
    fixture, shape, kind, layout, kv_quant, overlap = CASES[case]
    jcfg, jp, _tp, tcfg = request.getfixturevalue(fixture)
    dispatches = []
    real_dispatch, real_tp = tmoe._dispatch, tmoe.moe_ffn_tp

    def counted(tokens, top_e, gates, E, cap):
        out = real_dispatch(tokens, top_e, gates, E, cap)
        dispatches.append(int((out[3] - cap).clamp(min=0).sum()))
        return out

    def tp_moe(params, x, cfg):
        dispatches.append("tp")
        return real_tp(params, x, cfg)

    monkeypatch.setattr(tmoe, "_dispatch", counted)
    monkeypatch.setattr(tmoe, "moe_ffn_tp", tp_moe)
    jtree, ttree = _tree(kind, jp, tcfg)
    jm, tm = _meshes(shape)
    kw = dict(overlap=overlap, kv_quant=kv_quant, **LAYOUTS[layout], **KW)
    prompts = _prompts(tcfg.vocab_size)
    jsrv, want, jev = _serve(
        jobs, lambda: JaxServer(jtree, jcfg, mesh=jm, **kw),
        str(tmp_path / "j.jsonl"), prompts)
    tsrv, got, tev = _serve(
        tobs, lambda: GenerationServer(ttree, tcfg, device="cpu", mesh=tm, **kw),
        str(tmp_path / "t.jsonl"), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == list(BUDGETS)
    jstats, tstats = jsrv.stats(), tsrv.stats()
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert tstats["tp_degree"] == shape["model"]
    if layout == "paged":
        assert tstats["preemptions"] >= 1
    jev = [e for e in jev if e["name"] not in SKIP_EVENTS]
    tev = [e for e in tev if e["name"] not in SKIP_EVENTS]
    assert [e["name"] for e in tev] == [e["name"] for e in jev]
    for j, t in zip(jev, tev):
        assert _fields(t) == _fields(j), (j["name"], j, t)
    replicated = kv_cache_spec(tcfg, shape["model"]) == ()
    assert ("kv_replicated" in [e["name"] for e in tev]) == replicated
    if tcfg.moe:
        assert "tp" in dispatches
        assert sum(d for d in dispatches if d != "tp") > 0
    plain = GenerationServer(ttree, tcfg, device="cpu", tp=1, **kw)
    rids = [plain.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    res = plain.run()
    for g, r in zip(got, rids):
        np.testing.assert_array_equal(g, np.asarray(res[r]))


@pytest.mark.parametrize("shape", [{"fsdp": 2, "model": 2}, {"model": 4}],
                         ids=["fsdp2xmodel2", "model4"])
def test_prefill_logits_match_jax(tiny, shape):
    """fp32 logits of the mesh params' forward (the serving forward: fsdp
    gathers a layer at a time, column/row-parallel products, the
    vocab-parallel lookup and logits) within 1e-4 of their scale of JAX's
    forward on the same weights; the lookup itself is exact."""
    jcfg, jp, tp, tcfg = tiny
    _jm, tm = _meshes(shape)
    params = tt.tp_serving_params(tp, tcfg, _serving_mesh(tcfg, tm))
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 11))
    got = tt.forward(params, torch.from_numpy(toks).long(), tcfg)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    t = torch.from_numpy(toks).long()
    assert torch.equal(tt.embed(params, t, tcfg), tt.embed(tp, t, tcfg))


def _serving_mesh(cfg, mesh):
    from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh

    return ServingMesh.for_mesh(cfg, mesh)


def test_sharded_tree_serves_as_its_plain_tree(tiny):
    """``init_sharded_params`` on the mesh serves the tokens of the plain
    tree ``init_params`` draws from the same seed, and the server takes its
    pieces as they are (the same tensors, no whole model built); the
    server's forward gathers over fsdp without touching them."""
    _jcfg, _jp, _tp, tcfg = tiny
    _jm, tm = _meshes({"fsdp": 2, "model": 2})
    sharded = tsh.init_sharded_params(tcfg, tm, seed=3)
    plain = tt.init_params(tcfg, seed=3, device="cpu", dtype=torch.float32)
    kw = dict(LAYOUTS["paged"], **KW)
    srv = GenerationServer(sharded, tcfg, device="cpu", mesh=tm, **kw)
    assert srv.params["layers"]["wq"] is sharded["layers"]["wq"]
    assert srv.params["embed"] is sharded["embed"]
    ref = GenerationServer(plain, tcfg, device="cpu", **kw)
    prompts = _prompts(tcfg.vocab_size)
    for s in (srv, ref):
        for p, b in zip(prompts, BUDGETS):
            s.submit(p, b)
    got, want = srv.run(), ref.run()
    assert set(got) == set(want)
    for r in want:
        np.testing.assert_array_equal(np.asarray(got[r]), np.asarray(want[r]))
    assert srv.stats()["tp_degree"] == 2


def test_draft_on_the_mesh_gives_the_plain_speculative_tokens(tiny):
    """A draft model under ``mesh=`` is placed by the same rules (JAX's
    ``_shard_over``), and the speculative server gives the tokens of the
    same server without a mesh (the tp= path refuses speculation; the mesh
    path does not)."""
    from kata_xpu_device_plugin_tpu_torch.models import self_draft

    _jcfg, _jp, tp, tcfg = tiny
    _jm, tm = _meshes({"fsdp": 2, "model": 2})
    kw = dict(speculative_k=2, spec_opt_in=True, draft=self_draft(tp, tcfg, 1),
              **LAYOUTS["slotted"], **KW)
    srv = GenerationServer(tp, tcfg, device="cpu", mesh=tm, **kw)
    assert isinstance(srv.draft[0]["layers"]["wq"], tsh.Sharded)
    ref = GenerationServer(tp, tcfg, device="cpu", **kw)
    prompts = _prompts(tcfg.vocab_size)
    for s in (srv, ref):
        for p, b in zip(prompts, BUDGETS):
            s.submit(p, b)
    got, want = srv.run(), ref.run()
    for r in want:
        np.testing.assert_array_equal(np.asarray(got[r]), np.asarray(want[r]))
    assert srv.stats()["draft_acceptance"] == ref.stats()["draft_acceptance"]


def test_tp_with_mesh_raises_jax_error(tiny):
    jcfg, jp, tp, tcfg = tiny
    jm, tm = _meshes({"model": 2})
    with pytest.raises(ValueError) as jerr:
        JaxServer(jp, jcfg, mesh=jm, tp=2, max_len=32)
    with pytest.raises(ValueError) as terr:
        GenerationServer(tp, tcfg, device="cpu", mesh=tm, tp=2, max_len=32)
    assert str(terr.value) == str(jerr.value)


def test_permanent_fault_under_mesh_fails_loudly(tiny, tmp_path):
    """A chip loss on a mesh server does not shrink (only the tp= path
    degrades): ``chip_loss_fatal`` with ``why="mesh_injected"``, every
    unfinished request failed, the degree kept; the same outcome, events
    and stats as JAX's mesh server under the same schedule."""
    jcfg, jp, tp, tcfg = tiny
    jm, tm = _meshes({"fsdp": 2, "model": 2})
    schedule = [("decode_dispatch", 2, "chip_loss", 1)]
    prompts = _prompts(tcfg.vocab_size)[:4]
    kw = dict(max_batch=2, max_len=32, chunk=4, recovery_backoff_s=0.0,
              tp_min=1, heartbeat_rounds=0)
    runs = {}
    for side, pkg in (("jax", jobs), ("torch", tobs)):
        path = str(tmp_path / f"{side}.jsonl")
        sink = pkg.EventSink(path)
        prev = pkg.set_default_sink(sink)
        try:
            inj = injector(side, schedule)
            srv = (JaxServer(jp, jcfg, mesh=jm, fault_injector=inj, **kw)
                   if side == "jax" else
                   GenerationServer(tp, tcfg, device="cpu", mesh=tm,
                                    fault_injector=inj, **kw))
            rids = [srv.submit(p, 8) for p in prompts]
            res = srv.run()
        finally:
            pkg.set_default_sink(prev)
            sink.close()
        runs[side] = outcome(srv, rids, res, read_events(pkg, path))
    for key in runs["jax"]:
        assert runs["torch"][key] == runs["jax"][key], key
    got = runs["torch"]
    fatal = [f for n, f in got["events"] if n == "chip_loss_fatal"]
    assert fatal and fatal[0]["why"] == "mesh_injected"
    assert got["failures"] and got["stats"]["tp_degree"] == 2
