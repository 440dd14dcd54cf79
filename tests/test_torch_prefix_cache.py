"""PyTorch port, the shared-prefix KV cache: the port's ``RadixIndex``,
``_FreeList`` and ``PrefixStore`` against the JAX package's on the same
operation sequences (matches, pins, LRU eviction, skips, boundary repair,
counters); a hit's materialized rows and suffix prefill against the cold
prefill and against the JAX store's; and the port's server with
``prefix_cache_tokens`` (slotted and paged, int8 and bf16 KV, overlapped
and lock-step; batched suffix admission, deepening, the degraded fallback,
pins, a shared store; a hit through chunked, fused and persistent
admission) against the JAX server with the same arguments: equal tokens and
equal prefix, batch, copy-on-write and preemption counts. fp32, the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import prefix_cache as jpc
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.guest import prefix_cache as tpc
from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import PagedPrefixTier
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, build_pair, pool_to_numpy

COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
            "prefill_batches", "cow_copies", "preemptions", "prefills",
            "rounds", "prefix_store_tokens", "prefix_store_occupancy",
            "prefix_hit_ratio")


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=0)


def _shared_prompts(vocab, n, prefix_len=10, tails=(2, 3, 4), seed=1):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, tails[i % len(tails)])
                            .astype(np.int32)]) for i in range(n)]


def _serve(server, prompts, budgets=8):
    if isinstance(budgets, int):
        budgets = [budgets] * len(prompts)
    rids = [server.submit(p, b) for p, b in zip(prompts, budgets)]
    out = server.run()
    return [out[r] for r in rids]


def _against_jax(models, prompts, budgets=8, **kw):
    """The port's server and the JAX server built with ``kw`` on the same
    requests: equal tokens and :data:`COUNTERS`. Returns the port's server
    and the tokens."""
    jcfg, jp, tp, tcfg = models
    jsrv = JaxServer(jp, jcfg, **kw)
    want = _serve(jsrv, prompts, budgets)
    srv = GenerationServer(tp, tcfg, device="cpu", **kw)
    got = _serve(srv, prompts, budgets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, jst = srv.stats(), jsrv.stats()
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    return srv, want


# ----- radix index and free list ----------------------------------------------


@pytest.mark.parametrize("pkg", [tpc, jpc], ids=["port", "jax"])
def test_radix_insert_match_split_and_prune(pkg):
    idx = pkg.RadixIndex()
    a = np.array([1, 2, 3, 4], np.int32)
    n_long = idx.insert(a, "long")
    assert idx.longest_match(a) == (4, "long")
    assert idx.longest_match(np.array([1, 2, 3, 4, 9], np.int32)) == (4, "long")
    assert idx.longest_match(np.array([1, 2, 3], np.int32)) == (0, None)
    assert idx.longest_match(np.array([1, 2, 9, 4], np.int32)) == (0, None)
    n_short = idx.insert(np.array([1, 2], np.int32), "short")
    assert idx.longest_match(np.array([1, 2, 3], np.int32)) == (2, "short")
    idx.insert(np.array([1, 2, 7, 7], np.int32), "branch")
    assert idx.longest_match(np.array([1, 2, 7, 7, 1], np.int32)) == (4, "branch")
    assert idx.longest_match(a) == (4, "long") and len(idx) == 3
    idx.remove(n_long)
    assert idx.longest_match(a) == (2, "short")
    idx.remove(n_short)
    assert idx.longest_match(a) == (0, None) and len(idx) == 1


def test_radix_random_ops_match_jax():
    """Random inserts, removes and matches over a 4-token alphabet (deep
    shared prefixes, many splits): every answer equal to the JAX index's."""
    rng = np.random.default_rng(7)
    t, j = tpc.RadixIndex(), jpc.RadixIndex()
    handles = []
    for step in range(300):
        seq = rng.integers(0, 4, rng.integers(1, 9)).astype(np.int32)
        op = rng.integers(0, 3)
        if op == 0:
            handles.append((t.insert(seq, step), j.insert(seq, step)))
        elif op == 1 and handles:
            ht, hj = handles.pop(rng.integers(0, len(handles)))
            t.remove(ht)
            j.remove(hj)
        assert t.longest_match(seq) == j.longest_match(seq)
        assert len(t) == len(j)


def test_freelist_coalesces_like_jax():
    rng = np.random.default_rng(3)
    t, j = tpc._FreeList(64), jpc._FreeList(64)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.45:
            off, n = live.pop(rng.integers(0, len(live)))
            t.free(off, n)
            j.free(off, n)
        else:
            n = int(rng.integers(1, 17))
            got = t.alloc(n)
            assert got == j.alloc(n)
            if got is not None:
                live.append((got, n))
    assert t._free == j._free


# ----- the store ---------------------------------------------------------------


class _Pair:
    """A port store and a JAX store driven by the same calls on the same
    prompts (caches from each package's own prefill of the same weights):
    every return value and counter compared."""

    def __init__(self, models, capacity, buckets, kv_quant=False):
        self.jcfg, self.jp, self.tp, self.tcfg = models
        self.kv_quant = kv_quant
        self.t = tpc.PrefixStore(self.tcfg, capacity, buckets, kv_quant=kv_quant,
                                 device="cpu")
        self.j = jpc.PrefixStore(self.jcfg, capacity, buckets, kv_quant=kv_quant)

    def caches(self, p, max_len=32):
        tc = tt.prefill(self.tp, torch.from_numpy(p)[None].long(), self.tcfg,
                        max_len, return_logits=True,
                        kv_quantized=self.kv_quant)[0]
        jc = jt.prefill(self.jp, jnp.asarray(p)[None, :], self.jcfg, max_len,
                        return_logits=True, kv_quantized=self.kv_quant)[0]
        return tc, jc

    def insert(self, p):
        tc, jc = self.caches(p)
        got = self.t.insert(p, tc, 0)
        assert got == self.j.insert(p, jc, 0)
        self.check()
        return got

    def lookup(self, p):
        ht, hj = self.t.lookup(p), self.j.lookup(p)
        assert (ht is None) == (hj is None)
        if ht is not None:
            assert ht.length == hj.length
            assert ht.segment.offset == hj.segment.offset
        self.check()
        return ht, hj

    def call(self, name, hits):
        getattr(self.t, name)(hits[0])
        getattr(self.j, name)(hits[1])
        self.check()

    def check(self):
        assert self.t.stats() == self.j.stats()


def test_store_boundaries_and_counters_match_jax(models):
    s = _Pair(models, 32, (4, 8, 16))
    p = np.arange(1, 14, dtype=np.int32)
    s.insert(p)  # bound 8: entries at 4 and 8
    assert s.t.tokens_used == 8
    h = s.lookup(p)
    assert h[0].length == 8
    s.call("release", h)
    h = s.lookup(np.concatenate([p[:5], np.array([99, 98, 97], np.int32)]))
    assert h[0].length == 4
    s.call("release", h)
    h = s.lookup(p[:8])  # capped at len - 1: matches at 4
    assert h[0].length == 4
    s.call("release", h)
    assert s.lookup(p[:3])[0] is None and s.t.misses == 1
    miss = s.lookup(np.arange(50, 60, dtype=np.int32))
    s.call("unlookup", miss)
    h = s.lookup(p)
    s.call("cancel", h)
    h = s.lookup(p)
    s.call("unlookup", h)
    assert (s.t.hits, s.t.misses, s.t.tokens_reused) == (3, 2, 16)
    assert h[0].segment.refs == 0


def test_store_pins_lru_and_skips_match_jax(models):
    s = _Pair(models, 16, (8,))
    p1, p2 = np.arange(0, 10, dtype=np.int32), np.arange(50, 60, dtype=np.int32)
    s.insert(p1)
    s.insert(p2)
    h1 = s.lookup(p1)  # pins p1 and makes it the most recent
    assert s.insert(np.arange(100, 110, dtype=np.int32))  # p2 evicted
    assert s.lookup(p2)[0] is None
    h1b = s.lookup(p1)
    h3 = s.lookup(np.arange(100, 110, dtype=np.int32))
    assert not s.insert(np.arange(200, 210, dtype=np.int32))  # all pinned
    assert s.t.insert_skips == 1 and s.t.evictions == 1
    for h in (h1, h1b, h3):
        s.call("release", h)
    assert s.insert(np.arange(200, 210, dtype=np.int32))
    assert s.t.evictions == 2


def test_store_repairs_lost_shallow_boundary_like_jax(models):
    s = _Pair(models, 12, (4, 8))
    lineage = np.arange(1, 13, dtype=np.int32)
    s.insert(lineage[:6])   # A: 4 tokens
    s.insert(lineage)       # B: 8 tokens, entry at 8 only
    s.insert(np.arange(50, 55, dtype=np.int32))  # evicts A, LRU
    assert s.lookup(lineage[:6])[0] is None
    assert not s.insert(lineage)  # repairs the 4-boundary against B
    h = s.lookup(lineage[:6])
    h8 = s.lookup(lineage)
    assert h[0].length == 4 and h[0].segment is h8[0].segment


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32-kv", "int8-kv"])
def test_materialize_and_suffix_prefill(models, kv_quant):
    """A hit's materialized caches hold the cold prefill's prefix rows bit
    for bit and zeros past them, also fanned out to 3 rows; the suffix
    prefill from them gives the JAX store path's logits and caches, and
    the cold prefill's logits (exactly over an fp32 cache, within int8's
    read-back noise over an int8 one)."""
    jcfg, jp, tp, tcfg = models
    s = _Pair(models, 16, (8,), kv_quant=kv_quant)
    prompt = np.random.default_rng(3).integers(0, 256, 12).astype(np.int32)
    m, max_len = 8, 24
    tc, jc = s.caches(prompt, max_len)
    s.t.insert(prompt, tc, 0)
    s.j.insert(prompt, jc, 0)
    ht, hj = s.lookup(prompt)
    cold = tt.prefill(tp, torch.from_numpy(prompt)[None].long(), tcfg, max_len,
                      return_logits=True, kv_quantized=kv_quant)
    fan = s.t.materialize(ht, max_len, n=3)
    for c, f in zip(pool_to_numpy(tc), pool_to_numpy(fan)):
        for r in range(3):
            np.testing.assert_array_equal(f[:, r, :m], c[:, 0, :m])
        assert not f[:, :, m:].any()
    caches = s.t.materialize(ht, max_len)
    got_c, got, pos = tt.prefill_suffix(tp, torch.from_numpy(prompt[m:])[None].long(),
                                        tcfg, caches, m, return_logits=True)
    want_c, want, _ = jt.prefill_suffix(
        jp, jnp.asarray(prompt[m:])[None, :], jcfg, s.j.materialize(hj, max_len),
        jnp.int32(m), return_logits=True)
    assert int(pos) == len(prompt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, w in zip(pool_to_numpy(got_c), pool_to_numpy(want_c)):
        np.testing.assert_allclose(g[:, :, :len(prompt)], w[:, :, :len(prompt)],
                                   rtol=2e-5, atol=2e-5)
    tol = dict(rtol=0.1, atol=0.5) if kv_quant else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), cold[1].numpy(), **tol)
    assert (got.argmax(-1) == cold[1].argmax(-1)).all()


def test_store_validation(models):
    _, _, _, tcfg = models
    with pytest.raises(ValueError, match="buckets"):
        tpc.PrefixStore(tcfg, 64, (), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tpc.PrefixStore(tcfg, 4, (8,), device="cpu")


# ----- serving ---------------------------------------------------------------


LAYOUTS = {
    "slotted": dict(max_batch=2, prefix_cache_tokens=64),
    # 8-token blocks: the 8-boundary match shares a whole block.
    "paged": dict(max_batch=3, kv_pool_tokens=3 * 40 + 32, kv_block_size=8,
                  prefix_cache_tokens=1),
}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32-kv", "int8-kv"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_serving_matches_jax(models, layout, kv_quant, overlap):
    kw = dict(max_len=40, chunk=4, prefill_buckets=(8, 16, 24),
              kv_quant=kv_quant, overlap=overlap, **LAYOUTS[layout])
    prompts = _shared_prompts(256, 6, tails=(3, 6, 2, 9, 4, 5), seed=4)
    srv, _ = _against_jax(models, prompts, **kw)
    st = srv.stats()
    assert st["prefix_hits"] >= 3 and st["prefix_store_bytes"] > 0
    if layout == "paged":
        assert isinstance(srv.prefix_store, PagedPrefixTier)
        assert st["cow_copies"] == 0  # matches at 8 are block-aligned
        # Nothing leaks: the pool holds exactly the tier's blocks.
        assert st["kv_blocks_in_use"] == srv.prefix_store.blocks_used
    assert all(h is None for h in srv._slot_prefix)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
def test_paged_cow_boundary_block_matches_jax(models, overlap):
    """Blocks of 16 put the 8-token match mid-block: the boundary block is
    copied on write and the tier's copy stays resident; tokens and
    ``cow_copies`` equal the JAX server's. On a second server the tier's
    block is read after the first (cold) request seeded it and again after
    the hits: every byte the same, no admission wrote it."""
    _, _, tp, tcfg = models
    kw = dict(max_batch=2, max_len=40, chunk=4, overlap=overlap,
              prefill_buckets=(8, 16, 24), kv_pool_tokens=2 * 40 + 64,
              kv_block_size=16, prefix_cache_tokens=1)
    prompts = _shared_prompts(256, 4, tails=(3, 6, 2, 9), seed=5)
    srv, _ = _against_jax(models, prompts, **kw)
    assert srv.stats()["cow_copies"] >= 1
    srv = GenerationServer(tp, tcfg, device="cpu", **kw)
    _serve(srv, prompts[:1])
    tier = srv.prefix_store
    (seg,) = tier._segments
    rows = slice(seg.blocks[0] * 16, seg.blocks[0] * 16 + 16)
    before = [a[:, 0, rows].copy() for a in pool_to_numpy(tier.pool.arena)]
    _serve(srv, prompts[1:])
    assert srv.stats()["cow_copies"] == 3 and seg in tier._segments
    for a, b in zip(pool_to_numpy(tier.pool.arena), before):
        np.testing.assert_array_equal(a[:, 0, rows], b)


def test_batched_suffix_admission_matches_jax(models):
    """A burst of same-prefix requests: the first pass misses and admits
    cold in one batch, the later passes hit and admit in one batched suffix
    forward each."""
    prompts = _shared_prompts(256, 8, tails=(3,))
    kw = dict(max_batch=4, max_len=48, chunk=4, prefill_buckets=(4, 8),
              prefix_cache_tokens=64)
    srv, _ = _against_jax(models, prompts, **kw)
    st = srv.stats()
    assert st["prefix_hits"] == 4 and st["prefill_batches"] >= 2


def test_deepen_and_degraded_fallback_match_jax(models):
    """A hit whose prompt passes a bucket beyond its match inserts the
    deeper boundary; a hit whose suffix fits no bucket inside ``max_len``
    while the whole prompt fits one goes cold, counted as a miss."""
    jcfg, jp, tp, tcfg = models
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 256, 20).astype(np.int32)
    prompts = [shared[:10], *(np.concatenate([shared, rng.integers(0, 256, 3)
                                              .astype(np.int32)]) for _ in range(2))]
    kw = dict(max_batch=1, max_len=48, chunk=4, prefill_buckets=(4, 8, 16),
              prefix_cache_tokens=64)
    srv, _ = _against_jax(models, prompts, **kw)
    st = srv.stats()
    assert st["prefix_hits"] == 2 and st["prefix_tokens_reused"] == 8 + 16
    shared = rng.integers(0, 256, 21).astype(np.int32)
    kw = dict(max_batch=1, max_len=28, chunk=4, prefill_buckets=(8, 21),
              prefix_cache_tokens=64)
    srv, _ = _against_jax(models, [shared[:10], shared], budgets=6, **kw)
    st = srv.stats()
    assert st["prefix_hits"] == 0 and st["prefix_misses"] == 2
    assert srv.prefix_store.stats()["misses"] == 2


def test_in_flight_pin_and_release(models):
    _, _, tp, tcfg = models
    prompts = _shared_prompts(256, 3, tails=(3,))
    srv = GenerationServer(tp, tcfg, max_batch=1, max_len=48, chunk=4,
                           prefill_buckets=(8,), prefix_cache_tokens=8,
                           device="cpu")
    srv.submit(prompts[0], 2)
    srv.run()
    store = srv.prefix_store
    assert store.tokens_used == 8
    srv.submit(prompts[1], 30)
    assert srv.step()
    seg = next(h.segment for h in srv._slot_prefix if h is not None)
    assert seg.refs == 1
    other = np.arange(100, 110, dtype=np.int32)
    caches = tt.prefill(tp, torch.from_numpy(other)[None].long(), tcfg, 48,
                        return_logits=True)[0]
    assert not store.insert(other, caches, 0)
    assert store.insert_skips == 1 and store.evictions == 0
    srv.run()
    assert all(h is None for h in srv._slot_prefix) and seg.refs == 0


def test_shared_store_across_servers(models):
    _, _, tp, tcfg = models
    prompts = _shared_prompts(256, 3, tails=(3,))
    kw = dict(max_batch=2, max_len=48, prefill_buckets=(4, 8, 16), device="cpu")
    ref = _serve(GenerationServer(tp, tcfg, **kw), prompts)
    store = tpc.PrefixStore(tcfg, 64, (4, 8, 16), device="cpu")
    first = GenerationServer(tp, tcfg, prefix_store=store, **kw)
    _serve(first, prompts[:1])
    second = GenerationServer(tp, tcfg, prefix_store=store, **kw)
    for g, w in zip(_serve(second, prompts[1:]), ref[1:]):
        np.testing.assert_array_equal(g, w)
    assert first.stats()["prefix_hits"] == 0
    assert second.stats()["prefix_hits"] == 2
    assert second.stats()["prefix_hit_ratio"] == 1.0


def test_prefix_knob_contract(models, monkeypatch):
    """As in the JAX server: the env value sizes the store when no argument
    is given, an explicit 0 wins, and without ``prefill_buckets`` an
    explicit size or store raises while the env value degrades, as does a
    malformed one; an injected store must match the server and keeps an
    env pool size from paging it."""
    _, _, tp, tcfg = models
    kw = dict(max_len=32, device="cpu")
    store = tpc.PrefixStore(tcfg, 64, (4, 8), device="cpu")
    with pytest.raises(ValueError, match="prefill_buckets"):
        GenerationServer(tp, tcfg, prefix_cache_tokens=64, **kw)
    with pytest.raises(ValueError, match="prefill_buckets"):
        GenerationServer(tp, tcfg, prefix_store=store, **kw)
    with pytest.raises(ValueError, match="prefix_store"):
        GenerationServer(tp, tcfg, prefill_buckets=(4, 16), prefix_store=store,
                         **kw)
    with pytest.raises(ValueError, match="prefix_store"):
        GenerationServer(tp, tcfg, prefill_buckets=(4, 8), kv_quant=True,
                         prefix_store=store, **kw)
    with pytest.raises(ValueError, match="injected_prefix_store"):
        GenerationServer(tp, tcfg, prefill_buckets=(4, 8), prefix_store=store,
                         kv_pool_tokens=256, **kw)
    monkeypatch.setenv("KATA_TPU_KV_POOL_TOKENS", "256")
    srv = GenerationServer(tp, tcfg, prefill_buckets=(4, 8), prefix_store=store,
                           **kw)
    assert srv.prefix_store is store and not srv.paged
    monkeypatch.delenv("KATA_TPU_KV_POOL_TOKENS")
    monkeypatch.setenv("KATA_TPU_PREFIX_CACHE_TOKENS", "32")
    srv = GenerationServer(tp, tcfg, prefill_buckets=(4, 8), **kw)
    assert srv.prefix_store.capacity_tokens == 32
    assert GenerationServer(tp, tcfg, prefill_buckets=(4, 8),
                            prefix_cache_tokens=0, **kw).prefix_store is None
    bare = GenerationServer(tp, tcfg, **kw)
    assert bare.prefix_store is None and bare.stats()["prefix_hit_ratio"] == 0.0
    for bad in ("16k", "-5"):
        monkeypatch.setenv("KATA_TPU_PREFIX_CACHE_TOKENS", bad)
        assert GenerationServer(tp, tcfg, prefill_buckets=(4, 8),
                                **kw).prefix_store is None
    monkeypatch.delenv("KATA_TPU_PREFIX_CACHE_TOKENS")
    st = bare.stats()
    assert {k: st[k] for k in ("prefix_hits", "prefix_misses",
                               "prefix_tokens_reused", "prefix_store_tokens",
                               "prefix_store_bytes", "cow_copies")} == dict.fromkeys(
        ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
         "prefix_store_tokens", "prefix_store_bytes", "cow_copies"), 0)


# The JAX scheduler tests' prefix-hit requests: 8 shared tokens and a tail
# of 4, staggered budgets.
SCHED_BUDGETS = (6, 12, 9, 5, 11, 7)


def _sched_prompts():
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, 256, 4).astype(np.int32)])
            for _ in range(6)]


@pytest.mark.parametrize("mode", ["chunked", "fused", "persistent"])
@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_hit_through_chunked_fused_and_persistent_matches_jax(models, mode,
                                                             layout):
    """A hit resumes a chunked admission at its match (``slo_chunked``,
    3-token slices, every admission past the first deferred), also with the
    slices riding decode dispatches (``fused``, K = 2), and under
    persistent rounds: tokens and counters equal the JAX server's with the
    same knobs, and the tokens equal the plain ``fifo_batch`` server's."""
    kw = dict(max_batch=2, max_len=64, chunk=4, prefill_buckets=(4, 8, 12),
              prefix_cache_tokens=64)
    if layout == "paged":
        kw.update(kv_pool_tokens=256, kv_block_size=4, prefix_cache_tokens=1)
    extra = {
        "chunked": dict(sched_policy="slo_chunked", prefill_chunk=3,
                        itl_slo_ms=0.0),
        "fused": dict(sched_policy="slo_chunked", prefill_chunk=3,
                      itl_slo_ms=0.0, fused=True, decode_steps=2),
        "persistent": dict(persistent=True),
    }[mode]
    prompts = _sched_prompts()
    jcfg, jp, tp, tcfg = models
    base = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), prompts,
                  list(SCHED_BUDGETS))
    srv, want = _against_jax(models, prompts, list(SCHED_BUDGETS), **kw, **extra)
    for b, w in zip(base, want):
        np.testing.assert_array_equal(b, w)
    st = srv.stats()
    assert st["prefix_hits"] > 0
    if mode != "persistent":
        assert st["sched_chunks"] > 0
    if mode == "fused":
        assert st["fused_admissions"] > 0
    if mode == "persistent":
        assert st["persistent_rounds"] > 0
