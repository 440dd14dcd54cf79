"""PyTorch port, the chaos gate (the port's twin of ``make chaos``): the
port's server against the JAX server under the Makefile's env-driven
serving schedules (``KATA_TPU_FAULTS``, seed 13, each with the knobs its
JAX suite runs under), with ``KATA_TPU_STRICT`` off and on. Each schedule
runs in the server form it targets, built with the scheduler tests'
requests on the tiny config: the same requests delivered with the same
tokens, the same failures and the same recovery and scheduling counters
on both sides, and at least one fault fired. fp32, the CPU.

``test_torch_resilience.py``'s ``test_chaos_schedule_matches_jax`` holds
the JAX recovery tests' own hand-injected schedule; the cases here are
the ones only the env reaches."""
from dataclasses import replace

import numpy as np
import pytest

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer

from .torch_parity import CONFIGS, build_pair

# tests/test_torch_scheduler.py's requests and base server.
LENS = (14, 9, 12, 7, 15, 11)
BUDGETS = (6, 12, 9, 5, 11, 7)
KW = dict(max_batch=2, max_len=32, chunk=4, prefill_buckets=(16,),
          recovery_backoff_s=0.0)
SLO = dict(sched_policy="slo_chunked", prefill_chunk=4, itl_slo_ms=0.0)
PAGED = dict(max_batch=3, kv_pool_tokens=64, kv_block_size=4)
FORMS = {
    "paged": PAGED,
    "fused_slo_chunked": dict(SLO, fused=True),
    "paged_fused_slo_chunked": dict(PAGED, **SLO, fused=True),
}
# Makefile's chaos target: each serving schedule with the env its suite
# runs under, the form where its faults fire on these requests, and the
# recoveries and failed requests both servers show there. Under "chaos"
# the fault at the third prefill fails requests 2 and 3, the admission it
# hits, on the JAX server too.
SCHEDULES = {
    "chaos": ({"KATA_TPU_FAULTS":
               "decode_dispatch:5,fence:7:hang,prefill:3,sched_tick:2"},
              "paged_fused_slo_chunked", 4, [2, 3]),
    "fused": ({"KATA_TPU_FAULTS": "decode_dispatch:4,sched_tick:3",
               "KATA_TPU_DECODE_STEPS": "2"}, "paged_fused_slo_chunked", 2, []),
    "persistent": ({"KATA_TPU_FAULTS": "decode_dispatch:4,sched_tick:3",
                    "KATA_TPU_PERSISTENT": "1"}, "fused_slo_chunked", 2, []),
    "kv": ({"KATA_TPU_FAULTS": "pool_alloc:4,fence:6",
            "KATA_TPU_KV_LAYOUT": "blocks"}, "paged", 2, []),
}
COUNTERS = ("failed_requests", "recoveries", "rounds", "prefills",
            "tokens_emitted", "fused_admissions", "preemptions", "sched_chunks")
# The chip-loss schedule of the Makefile's degraded suite: the fourth
# decode dispatch loses shard 1 of a tp=4 server.
CHIP_LOSS = "decode_dispatch:3:chip_loss:1"


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=0)


def _set_env(monkeypatch, env: dict, strict: str) -> None:
    for k, v in {**env, "KATA_TPU_FAULTS_SEED": "13",
                 "KATA_TPU_STRICT": strict}.items():
        monkeypatch.setenv(k, v)


def _serve(server, counters=COUNTERS) -> dict:
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, server.cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    rids = [server.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    out = server.run()
    st = server.stats()
    return {"delivered": {r: np.asarray(out[r]).tolist() for r in rids if r in out},
            "failed": sorted(server.failures()),
            **{k: st[k] for k in counters}}


@pytest.mark.parametrize("strict", ["0", "1"], ids=["lax", "strict"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_env_chaos_schedule_matches_jax(models, monkeypatch, schedule, strict):
    env, form, recoveries, failed = SCHEDULES[schedule]
    _set_env(monkeypatch, env, strict)
    jcfg, jp, tp, tcfg = models
    kw = {**KW, **FORMS[form]}
    want = _serve(JaxServer(jp, jcfg, **kw))
    got = _serve(GenerationServer(tp, tcfg, device="cpu", **kw))
    assert got == want
    assert (got["recoveries"], got["failed"]) == (recoveries, failed)
    assert sorted([*got["delivered"], *got["failed"]]) == list(range(len(LENS)))


@pytest.mark.parametrize("strict", ["0", "1"], ids=["lax", "strict"])
def test_env_chip_loss_shrinks_tp4_as_jax(models, monkeypatch, strict):
    """The tp=4 server (tiny at one layer, the degraded tests' model: the
    JAX tp=4 compile is this test's cost) loses shard 1 from the env
    schedule and finishes at tp=2 with JAX's tokens and counters."""
    _set_env(monkeypatch, {"KATA_TPU_FAULTS": CHIP_LOSS}, strict)
    jcfg = replace(models[0], n_layers=1)
    jp, tp, tcfg = build_pair(jcfg, seed=0)
    kw = dict(KW, tp=4)
    counters = COUNTERS + ("tp_degree", "tp_shrinks")
    want = _serve(JaxServer(jp, jcfg, **kw), counters)
    got = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), counters)
    assert got == want
    assert (got["tp_degree"], got["tp_shrinks"], got["recoveries"]) == (2, 1, 1)
    assert got["failed"] == [] and len(got["delivered"]) == len(LENS)
