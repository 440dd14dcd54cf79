"""PyTorch port, degraded mode: after a PERMANENT fault the port's
tensor-parallel server shrinks its degree as the JAX server does on the 8
forced host devices of ``tests/conftest.py`` (fp32, the CPU, equal weights
and prompts): tp=4 -> 2 under the heads and the blocks layouts, 2 -> 1,
``ici_error`` one rung down, and no shrink at tp=1, under the ``tp_min``
floor or with degraded mode off, where the load fails loudly. Both servers
give the same results, failures, fired faults, counters, degree and order
of ``tp_degraded``, ``chip_loss_fatal``, ``recovery`` and
``request_failed`` events; within the port, a shrunk run's tokens equal
the fault-free ``tp=1`` run's, and the decode backend is unchanged."""
from __future__ import annotations

from dataclasses import replace

import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import tp_serving as jtp
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest import tp_serving as ttp

from .torch_faults import (
    PAGED,
    assert_same,
    clean_port,
    make_server,
    read_events,
    serve_both,
)
from .torch_parity import CONFIGS, build_pair

BLOCKS = dict(PAGED, kv_layout="blocks")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """tiny at one layer: 8 query heads over 2 KV heads (tp=4 replicates
    the KV heads under the heads layout, tp=2 splits them); the JAX
    servers' compiles, most of these tests' time, shrink with depth."""
    jcfg = replace(CONFIGS["tiny"](), n_layers=1)
    return (jcfg,) + build_pair(jcfg, seed=0)


@pytest.fixture(scope="module")
def clean(models):
    return {name: clean_port(models, **kw) for name, kw in (
        ("slotted", {}), ("paged", PAGED))}


def _events(got, name):
    return [f for n, f in got["events"] if n == name]


# Shard 3 is the one lost at tp=4: the survivors' first two are the shards
# an ici_error's shrink and a tp=2 server keep, so the JAX servers of this
# file compile fewer meshes.
@pytest.mark.parametrize("layout,overlap", [("heads", True), ("blocks", False)])
def test_chip_loss_tp4_shrinks_to_tp2(models, clean, tmp_path, layout, overlap):
    kw = dict(tp=4, overlap=overlap, **(BLOCKS if layout == "blocks" else {}))
    got = assert_same(serve_both(
        models, tmp_path, schedule=[("decode_dispatch", 2, "chip_loss", 3)],
        seed=3, **kw))
    assert got["results"] == clean["paged" if layout == "blocks" else "slotted"]
    assert got["failures"] == {}
    assert (got["stats"]["tp_degree"], got["stats"]["tp_degraded"],
            got["stats"]["tp_shrinks"]) == (2, 1, 1)
    (deg,) = _events(got, "tp_degraded")
    assert deg == {"reason": "chip_loss:3", "old_tp": 4, "tp": 2,
                   "survivors": 3, "tp_min": 1}


def test_chip_loss_tp2_to_one_with_checkpoint(models, clean, tmp_path):
    """2 -> 1 with the lanes restored from a checkpoint under the new
    split; the port's decode backend and pool shards follow."""
    got = assert_same(serve_both(
        models, tmp_path, budgets=12,
        schedule=[("decode_dispatch", 2, "chip_loss", 0)], tp=2,
        checkpoint_rounds=1, overlap=False, **BLOCKS))
    assert got["results"] == clean_port(models, budgets=12, **PAGED)
    assert got["stats"]["tp_degree"] == 1 and got["stats"]["checkpoints"] >= 1
    (rec,) = _events(got, "recovery")
    assert (rec["restored"], rec["requeued"]) == (2, 0)


def test_ici_error_shrinks_one_rung(models, clean, tmp_path):
    got = assert_same(serve_both(
        models, tmp_path, schedule=[("decode_dispatch", 2, "ici_error")], tp=4))
    assert got["results"] == clean["slotted"]
    assert got["stats"]["tp_degree"] == 2


@pytest.mark.parametrize("case", ["tp1", "tp_min_floor", "degraded_off"])
def test_no_rung_fails_the_load_loudly(models, tmp_path, monkeypatch, case):
    """No feasible rung: ``chip_loss_fatal`` with the JAX reason, every
    unfinished rid in ``failures()`` (``chip_lost``), none vanish."""
    kw = dict(tp=4)
    schedule = [("decode_dispatch", 2, "chip_loss", 3)]
    if case == "tp1":
        kw, schedule = {}, [("decode_dispatch", 1, "chip_loss")]
    elif case == "tp_min_floor":
        kw["tp_min"] = 4
    else:
        monkeypatch.setenv("KATA_TPU_DEGRADED", "0")
    got = assert_same(serve_both(models, tmp_path, schedule=schedule, **kw))
    assert got["failures"] and set(got["results"]).isdisjoint(got["failures"])
    assert set(got["results"]) | set(got["failures"]) == {0, 1, 2, 3}
    assert all("ChipLossFault" in v for v in got["failures"].values())
    (fatal,) = _events(got, "chip_loss_fatal")
    assert fatal["why"] == {"tp1": "single_chip", "tp_min_floor": "tp_min_floor:4",
                            "degraded_off": "degraded_disabled"}[case]
    assert {f["reason"] for f in _events(got, "request_failed")} == {"chip_lost"}


def test_second_chip_loss_during_restore_shrinks_again(models, clean, tmp_path):
    """A permanent fault inside the restore (the pool_alloc seam) shrinks
    once more before the replay: tp=4 -> 2 -> 1."""
    got = assert_same(serve_both(
        models, tmp_path, budgets=12, tp=4, overlap=False, checkpoint_rounds=1,
        schedule=[("decode_dispatch", 2, "chip_loss", 3),
                  ("pool_alloc", 4, "chip_loss", 0)], seed=3, **BLOCKS))
    assert got["stats"]["tp_degree"] == 1 and got["stats"]["tp_shrinks"] == 2
    assert got["failures"] == {}
    assert got["results"] == clean_port(models, budgets=12, **PAGED)


def test_shrink_keeps_the_backend_and_decodes_degraded(models, tmp_path):
    """The port alone: the decode backend and its reason are those of the
    server before the shrink, the graphs are built anew for the new
    degree (the CPU counts no capture), and decoding after the shrink is
    the ledger's ``decode_degraded`` phase."""
    path = str(tmp_path / "ev.jsonl")
    sink = tobs.EventSink(path)
    prev = tobs.set_default_sink(sink)
    try:
        srv = make_server(models, "torch", [("decode_dispatch", 2, "chip_loss", 1)],
                          tp=4, decode_attn="cuda_paged", **BLOCKS)
        before = {k: srv.stats()[k] for k in ("decode_backend",
                                              "decode_backend_reason")}
        old_graph = srv._decode
        for p in (3, 5, 7):
            srv.submit(list(range(1, p + 1)), 8)
        srv.run()
    finally:
        tobs.set_default_sink(prev)
        sink.close()
    st = srv.stats()
    assert {k: st[k] for k in before} == before
    assert srv._decode is not old_graph and old_graph._graph is None
    assert st["kv_pool_shards"] == 2 and len(st["kv_pool_shard_occupancy"]) == 2
    traces = [e for e in read_events(tobs, path) if e["name"] == "request_trace"]
    assert any(e["decode_degraded_s"] > 0 for e in traces)


def test_shrink_ladder_and_env_match_jax(monkeypatch):
    for tp, survivors, floor in ((4, 3, 1), (2, 1, 1), (1, 0, 1), (4, 3, 2),
                                 (4, 3, 4), (2, 1, 2), (4, 4, 1), (8, 1, 1)):
        assert ttp.shrink_ladder(tp, survivors, floor) == jtp.shrink_ladder(
            tp, survivors, floor)
    for raw in ("", "2", "garbage", "0"):
        monkeypatch.setenv("KATA_TPU_TP_MIN", raw)
        monkeypatch.setenv("KATA_TPU_DEGRADED", raw)
        assert ttp.tp_min_from_env() == jtp.tp_min_from_env()
        assert ttp.degraded_enabled() == jtp.degraded_enabled()
