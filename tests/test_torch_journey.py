"""PyTorch port, the guest journey (``scripts/torch_train_demo.py``) held
against the JAX journey (``scripts/train_demo.py``, ``make demo``) at the
JAX demo's own size: ``llama3_train_test`` in fp32, corpus ``arange(8192)
% vocab``, batches of 8 windows of 32 tokens (loader seed 1), a data 2 x
fsdp 2 x model 2 mesh (JAX on the 8 forced host devices, the port's
shards on the CPU), checkpoints every 2 steps, preempted at 4, resumed to
8; LoRA rank 4 at ``lr=1e-3``, 5 steps on ``[8, 32]`` tokens; merge, fuse,
int8; 5 prompts served through 2 speculative slots (k=3) over int8 KV.

Stage by stage, so that drift does not compound: each port stage takes
JAX's output of the stage before it, carried across as numpy (the initial
weights; the step-4 state and loader cursor as a checkpoint; the resumed
weights with JAX's adapters; the tuned tree; the quantized tree).
Tolerances: every loss within 1e-5 relative (the train tests' bar:
``test_torch_train.py``, fp32 with only the libraries' summation orders
apart); int8 payloads equal and scales within 1e-6 relative; served tokens
and the counters both servers report equal.

Chained within the port: the resumed run bit-equal to an uninterrupted
one, the base frozen through the LoRA steps, and the port's own chain
from JAX's initial weights within 1e-4 relative of JAX's losses after 13
steps of compounding, every request served. The script's ``main`` on the
CPU prints JAX's stage lines, and without CUDA and ``--device cpu`` it
raises."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import lora as jlora
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu.parallel import build_mesh as jax_mesh
from kata_xpu_device_plugin_tpu.parallel import fit as jax_fit
from kata_xpu_device_plugin_tpu.parallel import make_loader as jax_loader
from kata_xpu_device_plugin_tpu.parallel import make_train_step as jax_train_step
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.ops.lora import LoRAWeight, apply_lora
from kata_xpu_device_plugin_tpu_torch.ops.quant import QTensor
from kata_xpu_device_plugin_tpu_torch.parallel import (
    TrainCheckpointer,
    build_mesh,
    make_train_step,
    shard_params,
)
from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves, whole_params

from .torch_parity import CONFIGS

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
CHAIN_RTOL = 1e-4
TRAIN = dict(batch=8, seq_len=31, seed=0)
SERVER = dict(max_batch=2, max_len=64, speculative_k=3, spec_opt_in=True,
              kv_quant=True)
# What both servers report: tokens, rounds and speculation's counters.
# ``arena_bytes`` is held apart: JAX sums the arena over the devices that
# hold a copy, and the demo's weights come off the training mesh spread
# over several; the port's one device holds one.
STATS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
         "tokens_per_round", "draft_acceptance", "decode_backend_reason",
         "kv_slot_utilization", "failed_requests")


def _load_demo():
    spec = importlib.util.spec_from_file_location(
        "torch_train_demo", REPO / "scripts" / "torch_train_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


demo = _load_demo()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside an adamw chain."""
    for s in opt_state:
        if hasattr(s, "mu"):
            return s
    raise AssertionError(f"no Adam state in {opt_state!r}")


def _flat(tree, prefix=""):
    """{dotted path: numpy} over either package's tree (wrappers by field)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}{f}."))
    else:
        out[prefix[:-1]] = np.asarray(tree.detach() if torch.is_tensor(tree)
                                      else tree)
    return out


@pytest.fixture(scope="module")
def cfgs():
    jcfg = CONFIGS["llama3_test"]()
    return jcfg, bridge.config_from_fields(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def corpus(cfgs):
    return demo.corpus_for(cfgs[1], "llama3_train_test")


@pytest.fixture(scope="module")
def jax_journey(cfgs, corpus, tmp_path_factory):
    """``scripts/train_demo.py``'s sequence as calls into the JAX package,
    every stage's output kept as numpy."""
    jcfg, _ = cfgs
    mesh = jax_mesh(demo.MESH)
    init_state, step = jax_train_step(jcfg, mesh)
    key = jax.random.PRNGKey(0)
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    out = {"init": _np(init_state(key)["params"])}

    def run(steps):
        loader = jax_loader(corpus, batch=8, seq_len=31, mesh=mesh, seed=1)
        return jax_fit(init_state, step, loader, steps=steps, key=key,
                       ckpt_dir=ckpt, ckpt_every=2)

    state, out["losses_a"] = run(4)
    adam = _adam(state["opt"])
    out["state4"] = {"params": _np(state["params"]), "mu": _np(adam.mu),
                     "nu": _np(adam.nu), "count": int(adam.count)}
    with open(os.path.join(ckpt, "loader_4.json")) as f:
        out["cursor4"] = json.load(f)
    state, out["losses_b"] = run(8)
    out["params8"] = _np(state["params"])

    adapted = jlora.apply_lora(state["params"], jax.random.PRNGKey(1), rank=4)
    out["adapted"] = _np(adapted)
    out["ft_tokens"] = np.array(jax.random.randint(
        jax.random.PRNGKey(2), (8, 32), 0, jcfg.vocab_size))
    lora_init, lora_step = jlora.make_lora_train_step(jcfg, lr=1e-3)
    lstate = lora_init(adapted)
    out["lora_losses"] = []
    for _ in range(5):
        lstate, loss = lora_step(lstate, jnp.asarray(out["ft_tokens"]))
        out["lora_losses"].append(float(loss))
    out["tuned"] = _np(lstate["params"])
    served = jquant.quantize_decoder_params(
        jt.fuse_decoder_params(jlora.merge_lora(lstate["params"])))
    out["served"] = _np(served)
    out["prompts"] = demo.prompts_for(corpus, "llama3_train_test")
    srv = JaxServer(served, jcfg, **SERVER)
    rids = [srv.submit(p, 16) for p in out["prompts"]]
    res = srv.run()
    out["outputs"] = [np.asarray(res[r]) for r in rids]
    out["stats"] = srv.stats()
    out["arena_nbytes"] = sum(x.nbytes for x in jax.tree.leaves(srv.arena))
    return out


def _port(tree, tcfg):
    return bridge.params_from_numpy(tree, tcfg, "cpu")


def _mesh():
    return build_mesh(demo.MESH, devices=["cpu"])


def _losses(got, want, rtol=LOSS_RTOL):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _whole(params):
    """A training state's params as whole tensors, by dotted path."""
    return _paths(whole_params(params))


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ----- stage by stage --------------------------------------------------------


def test_pretrain_matches_jax(cfgs, corpus, jax_journey, tmp_path):
    """Four steps over the mesh from JAX's initial weights, checkpointing:
    JAX's four losses, and the checkpoints at steps 2 and 4 on disk."""
    _, tcfg = cfgs
    d = str(tmp_path / "ckpt")
    state, losses = demo.pretrain(tcfg, _mesh(), corpus, d, 4, 2,
                                  params=_port(jax_journey["init"], tcfg), **TRAIN)
    _losses(losses, jax_journey["losses_a"])
    assert TrainCheckpointer(d).steps() == [2, 4] and state["step"] == 4


def test_resume_from_jax_step4_matches_jax(cfgs, corpus, jax_journey, tmp_path):
    """JAX's step-4 state (params, Adam moments, count) and loader cursor
    written as the port's checkpoint: ``resume`` runs steps 5-8 with JAX's
    losses."""
    _, tcfg = cfgs
    mesh, s4 = _mesh(), jax_journey["state4"]
    d = str(tmp_path / "ckpt")
    state = {"params": shard_params(_port(s4["params"], tcfg), mesh),
             "opt": {"count": s4["count"],
                     "mu": shard_params(_port(s4["mu"], tcfg), mesh),
                     "nu": shard_params(_port(s4["nu"], tcfg), mesh)},
             "step": 4}
    TrainCheckpointer(d).save(4, state)
    with open(os.path.join(d, "loader_4.json"), "w") as f:
        json.dump(jax_journey["cursor4"], f)
    state, losses = demo.resume(tcfg, mesh, corpus, d, 8, 2, **TRAIN)
    _losses(losses, jax_journey["losses_b"])
    assert state["step"] == 8 and TrainCheckpointer(d).steps() == [4, 6, 8]


def test_resume_refuses_an_empty_directory(cfgs, corpus, tmp_path):
    with pytest.raises(ValueError, match="no checkpoint"):
        demo.resume(cfgs[1], _mesh(), corpus, str(tmp_path), 8, 2, **TRAIN)


def test_lora_finetune_matches_jax(cfgs, jax_journey):
    """JAX's adapted tree (JAX's resumed weights, its ``PRNGKey(1)``
    adapters) and its ``PRNGKey(2)`` tokens: JAX's five losses; the base
    leaves bit-equal before and after."""
    _, tcfg = cfgs
    adapted = _port(jax_journey["adapted"], tcfg)
    before = {k: v.base.clone() for k, v in adapted["layers"].items()
              if isinstance(v, LoRAWeight)}
    assert sorted(before) == ["wk", "wo", "wq", "wv"]
    state, losses = demo.lora_finetune(
        adapted, tcfg, None, steps=5,
        tokens=torch.from_numpy(jax_journey["ft_tokens"]).long(), lr=1e-3)
    _losses(losses, jax_journey["lora_losses"])
    for k, w in before.items():
        assert torch.equal(state["params"]["layers"][k].base, w), k


def test_prepare_for_serving_matches_jax(cfgs, jax_journey):
    """Merge, fuse, int8 of JAX's tuned tree: the int8 payloads equal,
    the scales and the float leaves within 1e-6 relative."""
    _, tcfg = cfgs
    got = demo.prepare_for_serving(_port(jax_journey["tuned"], tcfg))
    for k in ("wqkv", "wo", "w_gateup", "w_down"):
        assert isinstance(got["layers"][k], QTensor), k
    want, got = _flat(jax_journey["served"]), _flat(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == np.int8:
            assert got[k].dtype == np.int8
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=0, err_msg=k)


def test_serve_matches_jax(cfgs, jax_journey):
    """JAX's quantized tree through the speculative int8-KV server: JAX's
    tokens and counters; the arena's bytes are JAX's arena's own (one
    copy), which JAX's ``arena_bytes`` counts once a device holding it."""
    _, tcfg = cfgs
    outs, srv = demo.serve(_port(jax_journey["served"], tcfg), tcfg,
                           jax_journey["prompts"], 16, device="cpu", **SERVER)
    assert len(outs) == 5
    for g, w in zip(outs, jax_journey["outputs"]):
        np.testing.assert_array_equal(np.asarray(g), w)
    st, jst = srv.stats(), jax_journey["stats"]
    for k in STATS:
        assert st[k] == jst[k], (k, jst[k], st[k])
    assert st["decode_backend_reason"] == "speculative"
    assert st["arena_bytes"] == jax_journey["arena_nbytes"]
    assert jst["arena_bytes"] % st["arena_bytes"] == 0


# ----- chained within the port -----------------------------------------------


@pytest.fixture(scope="module")
def port_journey(cfgs, corpus, jax_journey, tmp_path_factory):
    """The port's own chain from JAX's initial weights: preempted at 4,
    resumed to 8, beside an uninterrupted 8-step run; LoRA over the
    resumed weights with JAX's adapters and tokens; merge, fuse, int8;
    served."""
    _, tcfg = cfgs
    mesh, init = _mesh(), _port(jax_journey["init"], tcfg)
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    _, losses_a = demo.pretrain(tcfg, mesh, corpus, d, 4, 2, params=init, **TRAIN)
    state, losses_b = demo.resume(tcfg, mesh, corpus, d, 8, 2, params=init,
                                  **TRAIN)
    whole, whole_losses = demo.pretrain(tcfg, mesh, corpus, None, 8, 0,
                                        params=init, **TRAIN)
    adapted = apply_lora(state["params"], torch.Generator(), rank=4)
    jad = _port(jax_journey["adapted"], tcfg)["layers"]
    for k, w in adapted["layers"].items():
        if isinstance(w, LoRAWeight):
            adapted["layers"][k] = w._replace(a=jad[k].a)
    base = {k: v.base.clone() for k, v in adapted["layers"].items()
            if isinstance(v, LoRAWeight)}
    lstate, lora_losses = demo.lora_finetune(
        adapted, tcfg, None, steps=5,
        tokens=torch.from_numpy(jax_journey["ft_tokens"]).long(), lr=1e-3)
    outs, srv = demo.serve(demo.prepare_for_serving(lstate["params"]), tcfg,
                           jax_journey["prompts"], 16, device="cpu", **SERVER)
    return dict(state=state, losses=losses_a + losses_b, whole=whole,
                whole_losses=whole_losses, base=base, lstate=lstate,
                lora_losses=lora_losses, outs=outs, stats=srv.stats())


def test_resume_replays_the_uninterrupted_run(port_journey):
    """``fit``'s contract through the journey's mesh: the preempted and
    resumed losses and final params and moments bit-equal to one
    uninterrupted run's."""
    pj = port_journey
    assert pj["losses"] == pj["whole_losses"]
    for a, b in zip(leaves(pj["state"]["params"]) + leaves(pj["state"]["opt"]["mu"])
                    + leaves(pj["state"]["opt"]["nu"]),
                    leaves(pj["whole"]["params"]) + leaves(pj["whole"]["opt"]["mu"])
                    + leaves(pj["whole"]["opt"]["nu"])):
        assert torch.equal(a, b)


def test_lora_over_a_mesh_state_freezes_the_base(port_journey):
    """``apply_lora`` takes the mesh state's pieces gathered whole; after
    the five steps the base is that gathered state bit for bit."""
    pj = port_journey
    whole = _whole(pj["state"]["params"])
    for k, w in pj["base"].items():
        assert torch.equal(w, whole[f"layers.{k}"]), k
        assert torch.equal(pj["lstate"]["params"]["layers"][k].base, w), k


def test_port_chain_tracks_the_jax_chain(port_journey, jax_journey):
    """The port's own 13 steps from JAX's initial weights within 1e-4
    relative of JAX's losses; every request served its 16 tokens."""
    pj = port_journey
    _losses(pj["losses"], jax_journey["losses_a"] + jax_journey["losses_b"],
            CHAIN_RTOL)
    _losses(pj["lora_losses"], jax_journey["lora_losses"], CHAIN_RTOL)
    assert [len(o) for o in pj["outs"]] == [16] * 5
    assert pj["stats"]["failed_requests"] == 0


def test_apply_lora_gathers_a_mesh_state(cfgs):
    """A ``make_train_step(mesh=)`` state holds ``Sharded`` pieces; the
    adapters wrap their whole tensors (equal to the gathered pieces) and
    the one-device LoRA step takes the tree."""
    _, tcfg = cfgs
    init, _ = make_train_step(tcfg, mesh=_mesh())
    params = init(0)["params"]
    adapted = apply_lora(params, torch.Generator().manual_seed(1), rank=4)
    for k, v in _paths(adapted).items():
        w = v.base if isinstance(v, LoRAWeight) else v
        assert torch.is_tensor(w) and torch.equal(w, _whole(params)[k]), k
    toks = torch.zeros(2, 9, dtype=torch.long)
    _, losses = demo.lora_finetune(adapted, tcfg, None, steps=1, tokens=toks)
    assert np.isfinite(losses[0])


def test_port_generator_journey_is_deterministic(cfgs, jax_journey):
    """The port's own adapters and fine-tune tokens from ``torch.Generator``
    seeds: two runs give the same losses, and the loss falls."""
    _, tcfg = cfgs
    runs = []
    for _ in range(2):
        params = _port(jax_journey["params8"], tcfg)
        toks = demo.lora_tokens(tcfg, (8, 32), torch.Generator().manual_seed(2))
        runs.append(demo.lora_finetune(
            params, tcfg, torch.Generator().manual_seed(1), rank=4, steps=5,
            tokens=toks, lr=1e-3)[1])
    assert runs[0] == runs[1] and runs[0][-1] < runs[0][0]


def test_main_prints_the_journey_on_the_cpu(capsys):
    assert demo.main(["--device", "cpu", "--config", "llama3_train_test"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: {'data': 2, 'fsdp': 2, 'model': 2}"
    for i, head in enumerate(("pretrain (interrupted at 4): losses ",
                              "resumed to 8:               losses ",
                              "lora fine-tune: final loss ",
                              "served 5 requests through 2 slots; first output: ")):
        assert lines[i + 1].startswith(head), lines
    assert len(json.loads(lines[2].split("losses ")[1])) == 4
    assert len(json.loads(lines[4].split("first output: ")[1])) == 16
    assert lines[-1] == "demo complete"


def test_main_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        demo.main(["--config", "llama3_train_test"])
