"""PyTorch port, the paged prefix tier and the host KV tier: the port's
``HostKVTier`` and ``PagedPrefixTier`` against the JAX package's on the
same operation sequences (capacity, LRU, pins, sharing, eviction, counter
reversal); demotion and promotion writing the pool in place, every row
verbatim; and the port's server with ``kv_host_tokens`` against the JAX
server with the same arguments: demotion before preemption and the resume
prefetch under overlapped and lock-step rounds, with equal tokens and equal
prefix, demotion, prefetch and preemption counts, and tokens equal to the
tier-less server's; the knob contract; a drain that fails spilled
sessions. fp32, the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import kv_arena as jka
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.guest import kv_arena as tka
from kata_xpu_device_plugin_tpu_torch.guest.prefix_cache import cache_leaves
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, build_pair

COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
            "kv_demotions", "kv_prefetches", "kv_host_tokens", "kv_host_blocks",
            "preemptions", "cow_copies", "prefill_batches", "rounds",
            "kv_blocks_in_use")


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=0)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve(server, prompts, budget):
    rids = [server.submit(p, budget) for p in prompts]
    out = server.run()
    return [out[r] for r in rids]


# ----- HostKVTier ------------------------------------------------------------


@pytest.mark.parametrize("pkg", [tka, jka], ids=["port", "jax"])
def test_host_tier_capacity_lru_and_pinned(pkg):
    tier = pkg.HostKVTier(100, 8)
    assert tier.put("a", 40) and tier.put("b", 40)
    assert not tier.put("c", 40)
    assert tier.room(20) and not tier.room(21)
    assert tier.put(("spill", 1), 40, pinned=True)  # pinned may overflow
    assert tier.tokens_used == 120 and tier.entries == 3
    assert tier.blocks_used == 15
    tier.get("a")
    assert tier.lru_unpinned() == "b"
    assert tier.pop("b").tokens == 40
    assert tier.drop_unpinned() == 1
    assert tier.entries == 1 and tier.get(("spill", 1)).pinned
    assert tier.stats()["occupancy"] == 0.4
    with pytest.raises(ValueError):
        pkg.HostKVTier(0, 8)


# ----- PagedPrefixTier ---------------------------------------------------------


class _Tiers:
    """A port tier and a JAX tier over pools of the same size, driven by the
    same calls (caches from each package's prefill of the same weights):
    return values, block ids and every counter compared."""

    def __init__(self, models, pool_tokens, bs=4, buckets=(4, 8), host=None):
        self.jcfg, self.jp, self.tp, self.tcfg = models
        self.tpool = tka.KVPool(self.tcfg, pool_tokens, bs, device="cpu")
        self.jpool = jka.KVPool(self.jcfg, pool_tokens, bs)
        th = tka.HostKVTier(host, bs) if host else None
        jh = jka.HostKVTier(host, bs) if host else None
        self.t = tka.PagedPrefixTier(self.tpool, self.tcfg, buckets, host_tier=th)
        self.j = jka.PagedPrefixTier(self.jpool, self.jcfg, buckets, host_tier=jh)

    def insert(self, p):
        tc = tt.prefill(self.tp, torch.from_numpy(p)[None].long(), self.tcfg, 32,
                        return_logits=True)[0]
        jc = jt.prefill(self.jp, jnp.asarray(p)[None, :], self.jcfg, 32,
                        return_logits=True)[0]
        got = self.t.insert(p, tc, 0)
        assert got == self.j.insert(p, jc, 0)
        self.check()
        return got

    def lookup(self, p):
        ht, hj = self.t.lookup(p), self.j.lookup(p)
        assert (ht is None) == (hj is None)
        if ht is not None:
            assert (ht.length, ht.segment.blocks) == (hj.length, hj.segment.blocks)
            assert self.t.shared_blocks(ht) == self.j.shared_blocks(hj)
        self.check()
        return ht, hj

    def call(self, name, hits):
        getattr(self.t, name)(hits[0])
        getattr(self.j, name)(hits[1])
        self.check()

    def check(self):
        assert self.t.stats() == self.j.stats()
        assert self.tpool.stats() == self.jpool.stats()


def test_tier_pins_lru_eviction_and_counters_match_jax(models):
    s = _Tiers(models, pool_tokens=6 * 4)  # 4 usable blocks
    p1, p2 = np.arange(0, 10, dtype=np.int32), np.arange(40, 50, dtype=np.int32)
    assert s.insert(p1)  # 8 tokens, 2 blocks
    hit = s.lookup(p1)
    assert hit[0].length == 8
    held = (s.tpool.try_alloc(2), s.jpool.try_alloc(2))
    assert held[0] == held[1]
    assert not s.insert(p2)  # pinned: skipped, never evicted
    s.call("release", hit)
    assert s.insert(p2)  # p1 evicted LRU first
    assert s.t.evictions == 1 and s.lookup(p1)[0] is None
    s.tpool.unref(held[0])
    s.jpool.unref(held[1])
    s.check()
    hit = s.lookup(p2)
    s.call("cancel", hit)
    assert (s.t.hits, s.t.tokens_reused) == (1, 8) and hit[0].segment.refs == 0
    s.call("unlookup", s.lookup(p2))
    s.call("unlookup", s.lookup(p1))
    assert (s.t.hits, s.t.misses) == (1, 2)


def test_demote_promote_in_place_and_verbatim(models):
    """Pool pressure demotes the LRU segment to the host tier (radix entries
    kept, blocks freed) and a hit promotes it into other blocks: the rows
    come back bit for bit, the pool's tensors are the same objects, and the
    counters and block ids equal the JAX tiers'."""
    s = _Tiers(models, pool_tokens=6 * 4, host=64)
    p1, p2 = np.arange(0, 10, dtype=np.int32), np.arange(40, 50, dtype=np.int32)
    s.insert(p1)
    seg = s.t._segments[0]
    table = torch.tensor(seg.blocks, dtype=torch.int32)
    before = [t.clone() for t in cache_leaves(
        tka.pool_gather_rows(s.tpool.arena, table, 4))]
    ptrs = [t.data_ptr() for t in cache_leaves(s.tpool.arena)]
    held = (s.tpool.try_alloc(2), s.jpool.try_alloc(2))
    assert s.insert(p2)  # demotes p1 instead of dropping it
    assert seg.host and not seg.blocks and s.t.demotions == 1
    assert s.t.host_tier.tokens_used == 8
    s.tpool.unref(held[0])
    s.jpool.unref(held[1])
    hit = s.lookup(p1)  # promoted back
    assert not seg.host and s.t.prefetches == 1
    after = tka.pool_gather_rows(s.tpool.arena,
                                 torch.tensor(seg.blocks, dtype=torch.int32), 4)
    for a, b in zip(cache_leaves(after), before):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in cache_leaves(s.tpool.arena)] == ptrs
    s.call("release", hit)


# ----- serving ---------------------------------------------------------------


def _against_jax(models, prompts, budget, **kw):
    jcfg, jp, tp, tcfg = models
    jsrv = JaxServer(jp, jcfg, **kw)
    want = _serve(jsrv, prompts, budget)
    srv = GenerationServer(tp, tcfg, device="cpu", **kw)
    for g, w in zip(_serve(srv, prompts, budget), want):
        np.testing.assert_array_equal(g, w)
    st, jst = srv.stats(), jsrv.stats()
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    return srv, want


def test_demotion_before_preemption_matches_jax(models):
    """Two lineages through one lane over a pool of 8 blocks: with a host
    tier, pool pressure demotes the other lineage's segment and its next
    request promotes it (hits the tier-less server loses to eviction), no
    lane is preempted, and tokens and counts equal the JAX server's and
    the tier-less server's tokens."""
    jcfg, jp, tp, tcfg = models
    heads = _prompts(256, (16, 16), seed=5)

    def burst(host):
        kw = dict(max_batch=1, max_len=48, chunk=4, prefill_buckets=(16, 32),
                  prefix_cache_tokens=1, kv_block_size=8, kv_pool_tokens=8 * 8,
                  kv_host_tokens=host)
        prompts = [np.concatenate([heads[i % 2], np.full(4, 50 + i, np.int32)])
                   for i in range(5)]
        # One request a run: each lineage's admission sees the other's
        # segment in the tier.
        jsrv = JaxServer(jp, jcfg, **kw)
        srv = GenerationServer(tp, tcfg, device="cpu", **kw)
        outs = []
        for p in prompts:
            want = _serve(jsrv, [p], 8)[0]
            np.testing.assert_array_equal(_serve(srv, [p], 8)[0], want)
            outs.append(want)
        st, jst = srv.stats(), jsrv.stats()
        assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
        return outs, srv

    ref, cold = burst(0)
    out, srv = burst(1024)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    st = srv.stats()
    assert st["kv_demotions"] > 0 and st["kv_prefetches"] > 0
    assert st["preemptions"] == 0
    assert st["prefix_hits"] > cold.stats()["prefix_hits"]
    assert cold.prefix_store.stats()["evictions"] > 0
    assert cold.stats()["kv_demotions"] == 0
    assert st["kv_blocks_in_use"] == srv.prefix_store.blocks_used


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32-kv", "int8-kv"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
def test_resume_prefetch_matches_jax_and_tierless(models, overlap, kv_quant):
    """A pool that preempts: with a host tier every spill is accounted there
    and every resume lands an upload staged after a dispatch; tokens equal
    the tier-less server's and, with every count, the JAX server's."""
    jcfg, jp, tp, tcfg = models
    prompts = _prompts(256, (10, 12, 9, 11, 8, 10), seed=3)
    kw = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16,),
              kv_block_size=8, kv_pool_tokens=8 * 14, overlap=overlap,
              prefix_cache_tokens=0, kv_quant=kv_quant)
    ref = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), prompts, 24)
    srv, want = _against_jax(models, prompts, 24, kv_host_tokens=2048, **kw)
    for r, w in zip(ref, want):
        np.testing.assert_array_equal(r, w)
    st = srv.stats()
    assert st["preemptions"] > 0 and st["kv_prefetches"] == st["preemptions"]
    assert st["kv_resume_staged"] == st["preemptions"]
    assert st["kv_host_blocks"] == 0 and st["kv_blocks_in_use"] == 0


def test_tier_and_prefix_under_preemption_match_jax(models):
    """Shared prefixes, the tier, a host tier and a pool tight enough to
    preempt, at once: tokens and every count equal the JAX server's, and
    the drained pool holds only the tier's blocks."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 256, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n).astype(np.int32)])
               for n in (4, 7, 2, 6, 3, 5)]
    kw = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16, 32),
              kv_block_size=8, kv_pool_tokens=8 * 12, prefix_cache_tokens=1,
              kv_host_tokens=512)
    srv, _ = _against_jax(models, prompts, 24, **kw)
    st = srv.stats()
    assert st["prefix_hits"] > 0 and st["preemptions"] > 0
    assert st["kv_demotions"] > st["preemptions"]
    assert st["kv_blocks_in_use"] == srv.prefix_store.blocks_used


def test_decode_pressure_evicts_unpinned_tier_lru(models):
    """Lane growth outranks the cache: tier segments are evicted for decode
    blocks, and each admission nets exactly one tier hit or miss through
    head-of-line retries."""
    prompts = _prompts(256, (9, 9, 9, 9), seed=6)
    kw = dict(max_batch=2, max_len=32, chunk=4, kv_pool_tokens=32 + 4 * 8,
              kv_block_size=8, prefill_buckets=(8,), prefix_cache_tokens=1)
    srv, _ = _against_jax(models, prompts, 20, **kw)
    tier = srv.prefix_store
    assert tier.evictions > 0 and tier.hits + tier.misses == len(prompts)


def test_kv_host_knob_contract(models, monkeypatch):
    _, _, tp, tcfg = models
    kw = dict(max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="kv_host_tokens"):
        GenerationServer(tp, tcfg, kv_pool_tokens=256, kv_host_tokens=-1, **kw)
    with pytest.raises(ValueError, match="paged"):
        GenerationServer(tp, tcfg, kv_pool_tokens=0, kv_host_tokens=512, **kw)
    assert GenerationServer(tp, tcfg, kv_pool_tokens=256, kv_host_tokens=512,
                            **kw).stats()["kv_host_tokens"] == 512
    for bad in ("16k", "-3"):
        monkeypatch.setenv("KATA_TPU_KV_HOST_TOKENS", bad)
        assert GenerationServer(tp, tcfg, kv_pool_tokens=256,
                                **kw).stats()["kv_host_tokens"] == 0
    monkeypatch.setenv("KATA_TPU_KV_HOST_TOKENS", "512")
    assert GenerationServer(tp, tcfg, kv_pool_tokens=256,
                            **kw).stats()["kv_host_tokens"] == 512
    slotted = GenerationServer(tp, tcfg, kv_pool_tokens=0, **kw)
    assert slotted.stats()["kv_host_tokens"] == 0 and slotted._kv_host is None
    monkeypatch.delenv("KATA_TPU_KV_HOST_TOKENS")
    st = slotted.stats()
    for key in ("kv_host_blocks", "kv_demotions", "kv_prefetches",
                "kv_resume_staged"):
        assert st[key] == 0


def test_drain_with_spilled_sessions_releases_host_accounting(models):
    _, _, tp, tcfg = models
    prompts = _prompts(256, (9, 7, 8, 6, 9, 7), seed=9)
    srv = GenerationServer(tp, tcfg, max_batch=2, max_len=48, chunk=4,
                           prefill_buckets=(16,), kv_block_size=8,
                           kv_pool_tokens=8 * 14, kv_host_tokens=2048,
                           device="cpu")
    rids = [srv.submit(p, 16) for p in prompts]
    for _ in range(6):
        if not srv.step():
            break
    results = srv.drain(reason="test")
    failures = srv.failures()
    assert set(results) | set(failures) == set(rids)
    assert not set(results) & set(failures)
    assert srv.stats()["kv_host_blocks"] == 0
