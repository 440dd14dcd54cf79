"""PyTorch port, the server's round loop: overlapped rounds and
``decode_steps=K`` against the JAX server built with the same ``overlap``
and ``decode_steps`` (fp32, the CPU, the same weights): every token and the
``rounds``/``prefills``/``prefill_batches``/``tokens_emitted``/
``preemptions`` counters, slotted and over a pool small enough to preempt,
int8 and bf16 KV, with and without ``eos_id``; the two defaults against
each other; within the port, the loops and K against each other; the
pieces of the loop (row merge, dead-chunk gate, env knob, drain)."""
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch.guest import serving as tserving
from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import DecodeGraph
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.obs.trace import DeviceFence

from .torch_parity import CONFIGS, build_pair

BUCKETS = (8, 16)
LENGTHS = (5, 7, 11, 16, 3, 9, 14, 6)
BUDGETS = (6, 9, 4, 12, 7, 20, 15, 8)
KW = dict(max_len=48, prefill_buckets=BUCKETS, chunk=4)
LAYOUTS = {
    "slotted": dict(max_batch=3),
    # 14 usable blocks of 4: growth runs the pool dry, lanes are preempted.
    "paged": dict(max_batch=4, kv_pool_tokens=64, kv_block_size=4),
}
COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
            "preemptions")


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["gemma_tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=21, fused=True)


def _prompts(vocab):
    rng = np.random.default_rng(22)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(server):
    rids = [server.submit(p, b) for p, b in zip(_prompts(server.cfg.vocab_size),
                                                BUDGETS)]
    out = server.run()
    return [out[r] for r in rids]


def _both(models, **kw):
    """The JAX server and the port's on the same requests: (tokens, stats)
    of each."""
    jcfg, jp, tp, tcfg = models
    jsrv = JaxServer(jp, jcfg, **kw)
    tsrv = GenerationServer(tp, tcfg, device="cpu", **kw)
    return (_serve(jsrv), jsrv.stats()), (_serve(tsrv), tsrv.stats())


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("decode_steps", [1, 3], ids=["K1", "K3"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
def test_round_loop_matches_jax(models, overlap, decode_steps, layout, kv_quant):
    (want, jstats), (got, tstats) = _both(
        models, overlap=overlap, decode_steps=decode_steps, kv_quant=kv_quant,
        **LAYOUTS[layout], **KW)
    _same(got, want)
    assert [len(g) for g in got] == list(BUDGETS)
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert tstats["decode_steps"] == jstats["decode_steps"] == decode_steps
    if layout == "paged":
        assert tstats["preemptions"] >= 1
        assert tstats["kv_blocks_in_use"] == 0
    assert tstats["decode_token_s"]["count"] == tstats["rounds"]
    assert tstats["decode_graph_captures"] == tstats["decode_graph_replays"] == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("overlap,decode_steps", [(True, 3), (False, 3), (True, 1)])
def test_eos_matches_jax(models, layout, overlap, decode_steps):
    """An eos the longest request emits mid-stream: the freeze mask (K > 1)
    and the host trim agree with the JAX server's."""
    _, _, tp, tcfg = models
    kw = dict(kv_quant=True, **LAYOUTS[layout], **KW)
    plain = _serve(GenerationServer(tp, tcfg, device="cpu", **kw))
    eos = int(plain[5][6])
    (want, jstats), (got, tstats) = _both(
        models, overlap=overlap, decode_steps=decode_steps, eos_id=eos, **kw)
    _same(got, want)
    assert got[5][-1] == eos and len(got[5]) <= 7
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}


def test_defaults_match_jax_defaults(models):
    """No loop argument on either side: both servers overlap at K = 1 and
    count the same rounds."""
    (want, jstats), (got, tstats) = _both(models, max_batch=2, **KW)
    _same(got, want)
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", max_batch=2, **KW)
    assert srv.overlap and srv.stats()["decode_steps"] == 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loops_and_steps_agree_within_the_port(models, layout):
    """Overlapped ≡ lock-step and K = 3 ≡ K = 1, token for token."""
    _, _, tp, tcfg = models
    outs = {
        (ov, k): _serve(GenerationServer(
            tp, tcfg, device="cpu", overlap=ov, decode_steps=k, kv_quant=True,
            **LAYOUTS[layout], **KW))
        for ov in (True, False) for k in (1, 3)}
    for key, got in outs.items():
        _same(got, outs[(False, 1)])


def test_merge_rows():
    dev = torch.tensor([10, 11, 12, 13], dtype=torch.int32)
    host = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    fresh = torch.tensor([False, True, False, True])
    merged = tserving._merge_rows(dev, host, fresh)
    assert merged.tolist() == [10, 1, 12, 3]
    assert merged.dtype == torch.int32


def test_any_survives_skips_the_dead_chunk(models):
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", max_batch=3, kv_quant=True,
                           **KW)
    a = tserving._Request(0, np.arange(3, dtype=np.int32), 9, out=[1] * 5)
    b = tserving._Request(1, np.arange(3, dtype=np.int32), 9, out=[1] * 4)
    srv._slot_req = [a, b, None]
    fl = tserving._Inflight(fence=None, last=None, pos=None,
                            slots=[(0, a), (1, b)], t_dispatch=0.0)
    # a: 5 + 4 >= 9 finishes with the chunk in flight; b: 4 + 4 < 9 lives.
    assert srv._any_survives(fl)
    b.out.append(1)
    assert not srv._any_survives(fl)
    c = tserving._Request(2, np.arange(3, dtype=np.int32), 9, out=[1] * 8)
    srv._slot_req[1] = c  # refilled since dispatch: its budget is untouched
    assert srv._any_survives(fl)


def test_budgets_on_chunk_edges_dispatch_no_dead_chunk(models):
    """Budgets of 1 + 4k tokens (the prefill's first, then whole chunks of
    4): the overlapped loop dispatches no chunk past the last, so it runs
    the lock-step loop's rounds, as the JAX server does."""
    jcfg, jp, tp, tcfg = models
    prompts = _prompts(tcfg.vocab_size)[:4]
    budgets = (5, 9, 5, 13)

    def serve(cls, params, cfg, **kw):
        srv = cls(params, cfg, max_batch=4, kv_quant=True, **KW, **kw)
        rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
        out = srv.run()
        return [out[r] for r in rids], srv.stats()["rounds"]

    got, rounds = serve(GenerationServer, tp, tcfg, device="cpu")
    lock, lock_rounds = serve(GenerationServer, tp, tcfg, device="cpu",
                              overlap=False)
    want, jax_rounds = serve(JaxServer, jp, jcfg)
    _same(got, want)
    _same(lock, want)
    assert rounds == lock_rounds == jax_rounds == 3


def test_decode_steps_knob_contract(models, monkeypatch):
    _, _, tp, tcfg = models

    def steps(**kw):
        return GenerationServer(tp, tcfg, device="cpu", max_batch=2,
                                **KW, **kw).stats()["decode_steps"]

    assert steps() == 1
    for bad in (0, -1):
        with pytest.raises(ValueError, match="decode_steps must be >= 1"):
            GenerationServer(tp, tcfg, device="cpu", decode_steps=bad, **KW)
    monkeypatch.setenv("KATA_TPU_DECODE_STEPS", "3")
    assert steps() == 3
    assert steps(decode_steps=2) == 2  # the argument wins
    for raw in ("lots", "-2", "0", "1.5"):
        monkeypatch.setenv("KATA_TPU_DECODE_STEPS", raw)
        assert steps() == 1  # degrades, never raises
        assert tserving.resolve_decode_steps(None) == 1


def _drain_run(srv, prompts, budgets, steps_before: int):
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    for _ in range(steps_before):
        srv.step()
    srv.request_drain("test")
    srv.request_drain("again")  # idempotent: the first reason stays
    out = srv.drain("ignored")
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(prompts[0], 2)
    return rids, out, srv.failures()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
def test_drain_matches_jax(models, layout, overlap):
    """Two rounds in, a drain: started requests (preempted spills included)
    run to their end with the tokens the JAX server gives them, the queue
    fails into ``failures()`` with the JAX server's messages, and
    ``submit`` refuses."""
    jcfg, jp, tp, tcfg = models
    kw = dict(kv_quant=True, overlap=overlap, **LAYOUTS[layout], **KW)
    prompts = _prompts(tcfg.vocab_size)
    theirs = _drain_run(JaxServer(jp, jcfg, **kw), prompts, BUDGETS, 2)
    srv = GenerationServer(tp, tcfg, device="cpu", **kw)
    rids, out, failed = _drain_run(srv, prompts, BUDGETS, 2)
    assert failed == theirs[2] and failed
    assert set(out) == set(theirs[1]) and out
    assert set(out) | set(failed) == set(rids)
    for rid in out:
        np.testing.assert_array_equal(out[rid], theirs[1][rid])
        assert len(out[rid]) == BUDGETS[rid]
    assert all(msg == "drained before start (test)" for msg in failed.values())
    stats = srv.stats()
    assert stats["draining"] and stats["failed_requests"] == len(failed)
    assert not srv.step()


def test_fence_and_decode_graph_on_the_cpu(models):
    """On the CPU the fence is a plain copy, and the decode executable runs
    the chunk eagerly: no capture, no replay."""
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    fence = DeviceFence(toks=x)
    x.add_(100)
    host = fence.wait()
    assert host["toks"].tolist() == [[0, 1, 2], [3, 4, 5]]
    host["toks"][0, 0] = -1
    assert fence.wait()["toks"][0, 0] == 0  # each wait hands out a copy
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", max_batch=2, kv_quant=True,
                           decode_steps=2, **KW)
    assert isinstance(srv._decode, DecodeGraph) and srv._decode.steps == 8
    _serve(srv)
    stats = srv.stats()
    assert stats["decode_graph_captures"] == stats["decode_graph_replays"] == 0
    assert stats["decode_graph_pool_bytes"] == 0
