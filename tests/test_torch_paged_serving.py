"""PyTorch port, paged serving: the port's ``GenerationServer`` over a block
pool against the JAX paged server and against the port's own slotted server
on the same weights (fp32, the CPU): ragged prompts, mixed budgets, int8
and bf16 KV, both decode backends, pools small enough to force preemption,
and the knob contract of ``kv_pool_tokens``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch.guest import serving as tserving
from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import SCRATCH_BLOCK
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer

from .torch_parity import CONFIGS, build_pair

BUCKETS = (8, 16)
LENGTHS = (5, 7, 11, 16, 3, 9, 14, 6)
BUDGETS = (6, 9, 4, 12, 7, 20, 15, 8)
KW = dict(max_len=48, prefill_buckets=BUCKETS, chunk=4)
PAGED_KEYS = {"kv_pool_occupancy", "kv_blocks_in_use", "kv_blocks_total",
              "kv_pool_tokens", "preemptions", "preempted_waiting"}


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["gemma_tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=41, fused=True)


def _serve(server):
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, server.cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    rids = [server.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    out = server.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def slotted(models):
    """The port's slotted server's outputs, per KV dtype: what every paged
    configuration must reproduce."""
    _, _, tp, tcfg = models
    return {q: _serve(GenerationServer(tp, tcfg, max_batch=2, kv_quant=q,
                                       device="cpu", **KW))
            for q in (True, False)}


def _same(got, want):
    for g, w, b in zip(got, want, BUDGETS):
        assert len(g) == b
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
def test_paged_server_matches_jax_paged_and_slotted(models, slotted, kv_quant):
    jcfg, jp, tp, tcfg = models
    pool = dict(max_batch=4, kv_pool_tokens=96, kv_block_size=4)
    want = _serve(JaxServer(jp, jcfg, kv_quant=kv_quant, **pool, **KW))
    _same(slotted[kv_quant], want)
    for backend in tserving.attention.DECODE_ATTN_BACKENDS:
        srv = GenerationServer(tp, tcfg, kv_quant=kv_quant, decode_attn=backend,
                               device="cpu", **pool, **KW)
        _same(_serve(srv), want)
        stats = srv.stats()
        assert stats["decode_backend"] == backend
        assert stats["prefills"] == len(LENGTHS)
        assert stats["kv_blocks_in_use"] == 0 and stats["preempted_waiting"] == 0
        assert stats["kv_blocks_total"] == 96 // 4 - 2
        assert stats["kv_pool_tokens"] == 96 - 2 * 4
        assert srv.arena is None and srv.paged


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
@pytest.mark.parametrize("pool_tokens,lanes", [(64, 6), (56, 8)])
def test_preemption_does_not_change_outputs(models, slotted, kv_quant,
                                            pool_tokens, lanes):
    """A pool that holds little more than one full-length request: lanes
    are preempted youngest first, spilled, and resumed; every request still
    returns, in submit order, what the slotted server returns."""
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, max_batch=lanes, kv_quant=kv_quant,
                           kv_pool_tokens=pool_tokens, kv_block_size=4,
                           decode_attn="cuda_paged", device="cpu", **KW)
    _same(_serve(srv), slotted[kv_quant])
    stats = srv.stats()
    assert stats["preemptions"] >= 1
    assert stats["kv_pool_occupancy_peak"] == 1.0
    assert stats["kv_blocks_in_use"] == 0 and stats["preempted_waiting"] == 0
    assert (srv._bt_host == SCRATCH_BLOCK).all()


def test_more_lanes_than_a_slotted_arena_of_the_same_bytes(models, slotted):
    """96 pool tokens are two slots' worth of a ``max_len = 48`` arena, yet
    four lanes decode at once."""
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, max_batch=4, kv_quant=True,
                           kv_pool_tokens=96, kv_block_size=4, device="cpu", **KW)
    _same(_serve(srv), slotted[True])
    stats = srv.stats()
    assert stats["lanes_busy_peak"] == 4 and stats["preemptions"] == 0
    two_slots = GenerationServer(tp, tcfg, max_batch=2, kv_quant=True,
                                 device="cpu", **KW).stats()["arena_bytes"]
    assert stats["arena_bytes"] == two_slots


def test_block_size_16_and_unbucketed_prompts(models, slotted):
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, max_batch=3, kv_quant=False,
                           kv_pool_tokens=160, kv_block_size=16, device="cpu",
                           max_len=48, chunk=4)
    _same(_serve(srv), slotted[False])


def test_pool_knob_contract(models, monkeypatch):
    _, _, tp, tcfg = models
    kw = dict(max_batch=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="pool_too_small:40"):
        GenerationServer(tp, tcfg, kv_pool_tokens=40, kv_block_size=4, **kw)
    with pytest.raises(ValueError, match="bad_block_size:0"):
        GenerationServer(tp, tcfg, kv_pool_tokens=96, kv_block_size=0, **kw)
    # 12 usable blocks of 4 hold exactly one max_len request.
    assert GenerationServer(tp, tcfg, kv_pool_tokens=56, kv_block_size=4,
                            **kw).paged
    assert not GenerationServer(tp, tcfg, kv_pool_tokens=0, **kw).paged
    monkeypatch.setenv("KATA_TPU_KV_POOL_TOKENS", "lots")
    srv = GenerationServer(tp, tcfg, **kw)  # malformed: degrades to slotted
    assert not srv.paged and srv.arena is not None
    monkeypatch.setenv("KATA_TPU_KV_POOL_TOKENS", "40")
    assert not GenerationServer(tp, tcfg, kv_block_size=4, **kw).paged
    monkeypatch.setenv("KATA_TPU_KV_POOL_TOKENS", "96")
    srv = GenerationServer(tp, tcfg, kv_block_size=4, **kw)
    assert srv.paged and srv.stats()["kv_blocks_total"] == 22
    assert not GenerationServer(tp, tcfg, kv_pool_tokens=0, kv_block_size=4,
                                **kw).paged  # the argument wins


def test_stats_carry_the_paged_keys_in_both_modes(models):
    jcfg, jp, tp, tcfg = models
    theirs = JaxServer(jp, jcfg, kv_quant=True, max_batch=2, **KW).stats()
    assert PAGED_KEYS <= set(theirs)
    slotted_stats = GenerationServer(tp, tcfg, max_batch=2, kv_quant=True,
                                     device="cpu", **KW).stats()
    assert PAGED_KEYS <= set(slotted_stats)
    assert all(not slotted_stats[k] for k in PAGED_KEYS)
    # Lock-step, so that one step() retires its round.
    srv = GenerationServer(tp, tcfg, max_batch=2, kv_quant=True, overlap=False,
                           kv_pool_tokens=96, kv_block_size=4, device="cpu", **KW)
    srv.submit(np.arange(1, 10, dtype=np.int32), 3)
    srv.step()
    stats = srv.stats()
    assert PAGED_KEYS <= set(stats)
    # 9 prompt tokens pad to bucket 16: four blocks of 4, then growth one
    # dispatch window ahead stays inside them (pos 9 + chunk 4 <= 16).
    assert stats["kv_blocks_in_use"] == 0  # budget 3: done within the round
    srv.submit(np.arange(1, 10, dtype=np.int32), 30)
    srv.step()
    stats = srv.stats()
    assert stats["kv_blocks_in_use"] == 4
    assert stats["kv_pool_occupancy"] == round(4 / 22, 4)
    L, KV, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert stats["arena_bytes"] == 2 * L * 96 * KV * (D + 4)


def test_a_failed_reservation_leaves_the_request_at_the_head(models):
    """Admission reserves the bucket-padded rows before the prefill runs: a
    request the pool cannot hold yet stays queued, nothing admits past it,
    and it is served once blocks drain."""
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, max_batch=4, kv_quant=False,
                           kv_pool_tokens=56, kv_block_size=4, device="cpu", **KW)
    rng = np.random.default_rng(7)
    rids = [srv.submit(rng.integers(0, tcfg.vocab_size, n), b)
            for n, b in ((16, 8), (16, 8), (16, 8), (3, 2))]
    srv.step()
    # Three blocks' worth of pool: 12 usable blocks hold the first three
    # 16-row prompts; the fourth (2 blocks) waits though a lane is free.
    assert [r is not None for r in srv._slot_req].count(True) <= 3
    assert len(srv._queue) == 1 and srv._queue[0].rid == rids[3]
    assert srv.stats()["prefills"] == 3
    out = srv.run()
    assert [len(out[r]) for r in rids] == [8, 8, 8, 2]
