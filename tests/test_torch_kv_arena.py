"""PyTorch port, the paged KV arena: ``KVPool`` accounting against the JAX
``KVPool`` on the same call sequence, each pool op against its JAX twin row
for row (exact: they are copies), and ``forward`` over a pool, single
tokens and spans, against the JAX ``forward`` on the same weights (fp32,
the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import kv_arena as jarena
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import attention as jatt
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.guest import kv_arena as tarena
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt

from .torch_parity import CONFIGS, build_pair, pool_from_jax, pool_to_numpy

BS = 4


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["gemma_tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=31, fused=True)


def test_reserved_blocks_match_jax():
    assert (tarena.ZERO_BLOCK, tarena.SCRATCH_BLOCK, tarena.RESERVED_BLOCKS) == (
        jarena.ZERO_BLOCK, jarena.SCRATCH_BLOCK, jarena.RESERVED_BLOCKS)
    assert (tt.PAGED_ZERO_BLOCK, tt.PAGED_SCRATCH_BLOCK) == (
        jt.PAGED_ZERO_BLOCK, jt.PAGED_SCRATCH_BLOCK)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_pool_accounting_matches_jax(models, kv_quant):
    jcfg, _, _, tcfg = models
    jp = jarena.KVPool(jcfg, 50, BS, kv_quant=kv_quant)
    tp = tarena.KVPool(tcfg, 50, BS, kv_quant=kv_quant, device="cpu")
    assert tp.num_blocks == jp.num_blocks == 12
    for a, b in zip(pool_to_numpy(tp.arena), pool_to_numpy(jp.arena)):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()

    def same():
        assert tp.stats() == jp.stats()
        assert (tp.blocks_total, tp.blocks_free, tp.blocks_in_use,
                tp.capacity_tokens) == (jp.blocks_total, jp.blocks_free,
                                        jp.blocks_in_use, jp.capacity_tokens)

    same()
    a_t, a_j = tp.try_alloc(3), jp.try_alloc(3)
    assert a_t == a_j == [2, 3, 4]
    b_t, b_j = tp.try_alloc(6), jp.try_alloc(6)
    assert b_t == b_j
    same()
    assert tp.try_alloc(2) is None and jp.try_alloc(2) is None  # all or nothing
    assert tp.try_alloc(0) == jp.try_alloc(0) == []
    tp.ref(a_t[:2]), jp.ref(a_j[:2])
    tp.unref(a_t), jp.unref(a_j)  # two of the three still have a holder
    same()
    assert tp.blocks_free == 2
    tp.unref(a_t[:2]), jp.unref(a_j[:2])
    tp.unref(b_t[::2]), jp.unref(b_j[::2])
    same()
    assert tp.try_alloc(5) == jp.try_alloc(5)  # recycled in the same order
    same()
    with pytest.raises(AssertionError):
        tp.unref([tarena.SCRATCH_BLOCK])
    with pytest.raises(ValueError):
        tp.try_alloc(-1)


def test_pool_refuses_what_is_not_ported_or_too_small(models):
    """Block-sharded pools are ported (tensor-parallel serving): as JAX's,
    a pool rounds down to whole blocks a shard and refuses one that holds
    no usable block after the rounding."""
    jcfg, _, _, tcfg = models
    pool = tarena.KVPool(tcfg, 64, BS, shards=3, device="cpu")
    twin = jarena.KVPool(jcfg, 64, BS, shards=3)
    assert (pool.num_blocks, pool.shard_blocks) == (twin.num_blocks,
                                                    twin.shard_blocks) == (15, 5)
    for n in (4, 3, 5):
        assert pool.try_alloc(n) == twin.try_alloc(n)
        assert pool.shard_occupancy() == twin.shard_occupancy()
    with pytest.raises(ValueError, match="two reserved"):
        tarena.KVPool(tcfg, 3 * BS, BS, shards=2, device="cpu")
    with pytest.raises(ValueError, match="two reserved"):
        jarena.KVPool(jcfg, 3 * BS, BS, shards=2)
    with pytest.raises(ValueError, match="two reserved"):
        tarena.KVPool(tcfg, 2 * BS, BS, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        tarena.KVPool(tcfg, 64, 0, device="cpu")


@pytest.mark.parametrize("shards", [None, 2], ids=["same", "reshard"])
def test_pool_reset_in_place_is_a_fresh_jax_pool(models, shards):
    """``reset`` (crash recovery's in-place rebuild, where JAX builds a new
    pool) leaves the pool's tensors where they are, zeroed, and its
    accounting that of a fresh JAX pool, re-partitioned into ``shards``
    sub-pools when given (a blocks-layout shrink from 4 shards to 2)."""
    jcfg, _, _, tcfg = models
    pool = tarena.KVPool(tcfg, 64, BS, kv_quant=True, shards=4, device="cpu")
    ptrs = [t.data_ptr() for t in tarena.cache_leaves(pool.arena)]
    got = pool.try_alloc(5)
    pool.ref(got[:2])
    for t in tarena.cache_leaves(pool.arena):
        t.fill_(3)
    pool.reset(shards=shards)
    twin = jarena.KVPool(jcfg, 64, BS, kv_quant=True, shards=shards or 4)
    assert [t.data_ptr() for t in tarena.cache_leaves(pool.arena)] == ptrs
    assert not any(a.any() for a in pool_to_numpy(pool.arena))
    assert pool.stats() == twin.stats()
    for n in (3, 4, 2):
        assert pool.try_alloc(n) == twin.try_alloc(n)
    with pytest.raises(ValueError, match="shards"):
        pool.reset(shards=3)


def _random_caches(jcfg, n, length, quantized, seed):
    """A contiguous cache pair ``[L, n, length, KV, D]`` of random rows, as
    a JAX pytree."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, n, length, jcfg.n_kv_heads, jcfg.head_dim)
    pair = tuple(jnp.asarray(rng.standard_normal(shape, np.float32))
                 for _ in range(2))
    if quantized:
        pair = tuple(jquant.quantize_kv(c) for c in pair)
    return pair


def _assert_pools_equal(tpool, jpool, scratch_rows):
    """Row for row, except the SCRATCH block, whose colliding writes land in
    no defined order and which nothing reads; the ZERO block stays zero."""
    for a, b in zip(pool_to_numpy(tpool), pool_to_numpy(jpool)):
        keep = np.ones(a.shape[2], bool)
        keep[scratch_rows] = False
        np.testing.assert_array_equal(a[:, :, keep], b[:, :, keep])
        assert not a[:, :, :BS].any()


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_pool_ops_match_jax_row_for_row(models, kv_quant):
    jcfg, _, _, tcfg = models
    jp = jarena.KVPool(jcfg, 16 * BS, BS, kv_quant=kv_quant)
    jpool, tpool = jp.arena, pool_from_jax(jp.arena)
    scratch = slice(BS, 2 * BS)
    S = jarena.SCRATCH_BLOCK

    # One row of a 3-request prefill (10 rows: the last block pads with
    # zeros), with one chunk masked by SCRATCH.
    caches = _random_caches(jcfg, 3, 10, kv_quant, 1)
    table = np.array([7, S, 3], np.int32)
    jpool = jarena.pool_write_seq(jpool, caches, jnp.int32(1),
                                  jnp.asarray(table), block_size=BS)
    out = tarena.pool_write_seq(tpool, pool_from_jax(caches), 1,
                                torch.from_numpy(table), BS)
    assert out is tpool  # in place
    _assert_pools_equal(tpool, jpool, scratch)
    k_rows = pool_to_numpy(tpool)[0][:, 0]
    np.testing.assert_array_equal(k_rows[:, 3 * BS: 3 * BS + 2],
                                  pool_to_numpy(caches)[0][:, 1, 8:10])
    assert not k_rows[:, 3 * BS + 2: 4 * BS].any()  # the zero padding

    # A batched admission: tables padded and masked with SCRATCH.
    caches = _random_caches(jcfg, 2, 12, kv_quant, 2)
    tables = np.array([[4, 5, 6, S], [9, 10, 11, 12]], np.int32)
    caches16 = _random_caches(jcfg, 2, 16, kv_quant, 3)
    for c in (caches, caches16):
        jpool = jarena.pool_write_batch(jpool, c, jnp.asarray(tables),
                                        block_size=BS)
        tarena.pool_write_batch(tpool, pool_from_jax(c),
                                torch.from_numpy(tables), BS)
        _assert_pools_equal(tpool, jpool, scratch)

    # Spill and restore: gather blocks, land them elsewhere.
    table = np.array([9, 3, 11], np.int32)
    rows_j = jarena.pool_gather_rows(jpool, jnp.asarray(table), block_size=BS)
    rows_t = tarena.pool_gather_rows(tpool, torch.from_numpy(table), BS)
    for a, b in zip(pool_to_numpy(rows_t), pool_to_numpy(rows_j)):
        np.testing.assert_array_equal(a, b)
    dest = np.array([13, 2, 14], np.int32)
    jpool = jarena.pool_scatter_rows(jpool, rows_j, jnp.asarray(dest),
                                     block_size=BS)
    tarena.pool_scatter_rows(tpool, rows_t, torch.from_numpy(dest), BS)
    _assert_pools_equal(tpool, jpool, scratch)
    np.testing.assert_array_equal(
        pool_to_numpy(tpool)[0][:, 0, 13 * BS: 14 * BS],
        pool_to_numpy(tpool)[0][:, 0, 9 * BS: 10 * BS])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel-fn"])
def test_forward_over_a_pool_matches_jax(models, kv_quant, kernel):
    """A 3-token span, then single tokens, through permuted tables with
    SCRATCH filler; lane 2 is dead (all SCRATCH, a stale position). Logits
    of the live lanes and the pool's rows agree with the JAX forward, on the
    gather path and through the decode function (Pallas in interpret mode
    there, the plain version here)."""
    jcfg, jparams, tparams, tcfg = models
    B, NB, paged_len = 3, 4, 14
    S_ = jarena.SCRATCH_BLOCK
    jp = jarena.KVPool(jcfg, (2 + 2 * NB) * BS, BS, kv_quant=kv_quant)
    jpool, tpool = jp.arena, pool_from_jax(jp.arena)
    tables = np.array([[5, 2, 8, S_], [3, 9, S_, S_], [S_] * NB], np.int32)
    kw = dict(block_size=BS, paged_len=paged_len)
    fn_j = fn_t = None
    if kernel:
        fn_j = jatt.make_decode_attn_fn(jcfg, paged=True, interpret=True,
                                        quantized=kv_quant, **kw)
        fn_t = tatt.make_decode_attn_fn(tcfg, paged=True, device="cpu", **kw)
    rng = np.random.default_rng(5)
    off = np.array([4, 1, 900], np.int32)
    for S in (3, 1, 1, 3):
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        positions = off[:, None] + np.arange(S, dtype=np.int32)[None, :]
        lj, jpool = jt.forward(
            jparams, jnp.asarray(toks), jcfg, positions=jnp.asarray(positions),
            kv_caches=jpool, cache_offset=jnp.asarray(off),
            block_tables=jnp.asarray(tables), decode_kernel_fn=fn_j, **kw)
        lt, out = tt.forward(
            tparams, torch.from_numpy(toks), tcfg,
            attn_fn=tatt.reference_attention,
            positions=torch.from_numpy(positions), kv_caches=tpool,
            cache_offset=torch.from_numpy(off),
            block_tables=torch.from_numpy(tables), decode_kernel_fn=fn_t, **kw)
        assert out is tpool
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   atol=2e-4, rtol=2e-4)
        assert np.isfinite(lt.numpy()).all()
        off = off + S
    for a, b in zip(pool_to_numpy(tpool), pool_to_numpy(jpool)):
        keep = np.ones(a.shape[2], bool)
        keep[BS: 2 * BS] = False
        if a.dtype == np.int8:
            assert np.abs(a[:, :, keep].astype(np.int32)
                          - b[:, :, keep].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(a[:, :, keep], b[:, :, keep],
                                       atol=2e-4, rtol=2e-4)
        assert not a[:, :, :BS].any()  # ZERO is never written


def test_forward_needs_the_pool_geometry(models):
    _, _, tparams, tcfg = models
    pool = tarena.KVPool(tcfg, 64, BS, device="cpu")
    with pytest.raises(ValueError, match="block_size and paged_len"):
        tt.forward(tparams, torch.zeros((1, 1), dtype=torch.int64), tcfg,
                   kv_caches=pool.arena, cache_offset=torch.zeros(1, dtype=torch.int32),
                   block_tables=torch.full((1, 4), 1, dtype=torch.int32))


def test_lockstep_decode_scan_matches_jax(models):
    """A scalar position takes the lock-step branch (one write offset, one
    mask for every row), as the JAX scan does."""
    jcfg, jparams, tparams, tcfg = models
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 5)).astype(
        np.int32)
    for quantized in (False, True):
        cj, lj, pj = jt.prefill(jparams, jnp.asarray(toks), jcfg, 16,
                                kv_quantized=quantized)
        ct, lt, pt = tt.prefill(tparams, torch.from_numpy(toks), tcfg, 16,
                                kv_quantized=quantized)
        oj = jt._decode_scan(jparams, cj, lj, pj, jcfg, 7, None, False, 0,
                             jnp.float32(0.0), jax.random.PRNGKey(0))
        ot, _, _, pos = tt._decode_scan(tparams, ct, lt, pt, tcfg, 7,
                                        return_state=True)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        assert pos.ndim == 0 and int(pos) == 12
    with pytest.raises(ValueError, match="per lane"):
        tt._decode_scan(tparams, ct, lt, 5, tcfg, 1,
                        budget=torch.ones(2, dtype=torch.int32))
