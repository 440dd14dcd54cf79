"""Shared helpers of the PyTorch port's crash-tolerance parity tests
(``test_torch_resilience.py``, ``test_torch_degraded.py``): one server of
each package under the same fault schedule, weights and prompts, and the
outcome the two are compared on."""
from __future__ import annotations

import os

import numpy as np

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest import resilience as jres
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest import resilience as tres
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer

SIDES = {"jax": (JaxServer, jres, jobs), "torch": (GenerationServer, tres, tobs)}
STATS = ("recoveries", "quarantined", "device_stalls", "checkpoints",
         "checkpoint_rounds", "tp_degree", "tp_degraded", "tp_shrinks",
         "preemptions", "failed_requests")
# The events whose order and fields the two servers share, with the fields.
EVENTS = {
    "recovery": ("restored", "requeued", "quarantined", "failed", "streak"),
    "checkpoint": ("round", "lanes", "tokens", "final"),
    "tp_degraded": ("reason", "old_tp", "tp", "survivors", "tp_min"),
    "chip_loss_fatal": ("reason", "tp", "why", "survivors"),
    "request_failed": ("rid", "reason", "emitted"),
    "fault_injected": ("seam", "round", "fault_kind", "device"),
}
# The JAX recovery tests' chaos schedule: a transient dispatch raise, a
# fence hang, an admission raise and (paged only) an allocation OOM.
CHAOS = [("decode_dispatch", 2), ("fence", 1, "hang"), ("prefill", 1),
         ("pool_alloc", 1, "raise-oom")]
PAGED = dict(kv_pool_tokens=4 * 32, kv_block_size=8)


def make_prompts(vocab, lengths, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def read_events(pkg, path: str) -> list:
    """The events a sink wrote (a sink that saw none writes no file)."""
    return pkg.read_events(path) if os.path.exists(path) else []


def injector(side, schedule, seed=0):
    mod = SIDES[side][1]
    return mod.FaultInjector([mod.FaultSpec(*s) for s in schedule], seed=seed)


def make_server(models, side, schedule=(), seed=0, **kw):
    jcfg, jp, tp, tcfg = models
    kw = {"max_batch": 2, "max_len": 32, "chunk": 4, "recovery_backoff_s": 0.0,
          "tp_min": 1, "heartbeat_rounds": 0, **kw}
    inj = injector(side, schedule, seed)
    if side == "jax":
        return JaxServer(jp, jcfg, fault_injector=inj, **kw)
    return GenerationServer(tp, tcfg, device="cpu", fault_injector=inj, **kw)


def outcome(srv, rids, res, events) -> dict:
    st = srv.stats()
    return {
        "results": {r: np.asarray(res[r]).tolist() for r in rids if r in res},
        "failures": srv.failures(),
        "fired": list(srv._inj.fired),
        "stats": {k: st[k] for k in STATS},
        "events": [(e["name"], {k: e.get(k) for k in EVENTS[e["name"]]})
                   for e in events if e["name"] in EVENTS],
    }


def serve_both(models, tmp_path, lengths=(4, 8, 6, 3), budgets=8,
               schedule=(), drive=None, patch=None, **kw) -> dict:
    """Each server under ``schedule``: every prompt submitted, then
    ``drive(srv)`` (default ``run()``); ``patch(srv)`` first, when given.
    Returns ``{side: outcome}``."""
    prompts = make_prompts(models[0].vocab_size, lengths)
    if isinstance(budgets, int):
        budgets = [budgets] * len(prompts)
    out = {}
    for side, (_cls, _mod, pkg) in SIDES.items():
        path = str(tmp_path / f"{side}.jsonl")
        sink = pkg.EventSink(path)
        prev = pkg.set_default_sink(sink)
        try:
            srv = make_server(models, side, schedule, **kw)
            if patch is not None:
                patch(srv)
            rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
            res = (drive or (lambda s: s.run()))(srv)
        finally:
            pkg.set_default_sink(prev)
            sink.close()
        out[side] = outcome(srv, rids, res, read_events(pkg, path))
    return out


def assert_same(runs: dict) -> dict:
    """The port's outcome equals the JAX server's, key by key."""
    j, t = runs["jax"], runs["torch"]
    for key in j:
        assert t[key] == j[key], (key, j[key], t[key])
    return t


def clean_port(models, lengths=(4, 8, 6, 3), budgets=8, **kw) -> dict:
    srv = make_server(models, "torch", **kw)
    prompts = make_prompts(models[0].vocab_size, lengths)
    if isinstance(budgets, int):
        budgets = [budgets] * len(prompts)
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    res = srv.run()
    return {r: np.asarray(res[r]).tolist() for r in rids}
