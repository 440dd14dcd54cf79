"""PyTorch port, tensor-parallel serving: the port's ``GenerationServer(tp=N,
kv_layout=...)`` against the port's ``tp=1`` server and the JAX TP server
(on the 8 forced host devices of ``tests/conftest.py``), on the same
weights (fp32, the CPU): greedy tokens and the counters equal, across bf16
and int8 KV, overlapped and lock-step rounds, prefix hits and a pool tight
enough to preempt, under both layouts; the shard-local paged decode form
(K2) through the server and against the JAX kernel in interpret mode; the
the heads forms of the decode attention shard by shard; the serving
partition rules; the degree's env ladder."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import tp_serving as jtp
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.ops import decode_attn as jdecode
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu.parallel import sharding as jshard
from kata_xpu_device_plugin_tpu_torch.guest import tp_serving as ttp
from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import KVPool
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.ops import attention, decode_attn
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tshard

from .torch_parity import CONFIGS, FAMILIES, build_pair

# Counters a TP server must share with the JAX TP server and the port's
# tp=1 server (tp_degree and the shard keys only with the JAX one).
SHARED = ("preemptions", "prefix_hits", "prefix_misses", "prefills")
TP_KEYS = ("tp_degree", "kv_pool_shards", "kv_pool_shard_occupancy",
           "kv_layout")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny servers run many small ops, which
    gain nothing from more threads and, beside other test processes,
    lose most of their time to threads waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """tiny: 8 query heads over 2 KV heads, so tp=2 splits the KV heads
    and tp=4 replicates them (each shard's 2 query heads share one)."""
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=0, fused=True)


def _prompts(vocab, lengths, seed=1, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n).astype(np.int32)])
            for n in lengths]


def _serve(srv, prompts, budgets, warm=None):
    """Tokens in submit order and the stats; ``warm`` (a prompt) is served
    to its end first, so its prefix is cached when the others arrive."""
    out = []
    if warm is not None:
        r = srv.submit(warm, 4)
        out.append(np.asarray(srv.run()[r]))
    if isinstance(budgets, int):
        budgets = [budgets] * len(prompts)
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    res = srv.run()
    return out + [np.asarray(res[r]) for r in rids], srv.stats()


def _assert_same(got, want, keys=SHARED):
    (gt, gs), (wt, ws) = got, want
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a, b)
    for k in keys:
        assert gs[k] == ws[k], (k, gs[k], ws[k])


# A pool tight enough to preempt, of 16 blocks, whole blocks a shard at
# tp 2 and 4: a blocks pool rounds down to a multiple of the degree, and a
# smaller pool admits with fewer hits, which over int8 rows gives other
# tokens by design (a hit reads its prefix back from the cache).
MATRIX_KW = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16, 32),
                 prefix_cache_tokens=1, kv_block_size=8, kv_pool_tokens=8 * 16)


@pytest.mark.parametrize("overlap", [False, True], ids=["lockstep", "overlap"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_tp_matrix_matches_tp1_and_jax(model, kv_quant, overlap):
    """JAX's blocks identity matrix: tp=2 under heads (KV heads split) and
    blocks, tp=4 under blocks, beside tp=1, over prefix hits and a pool
    that preempts; tokens and counters equal to the port's tp=1 server and
    to the JAX TP server of one layout a case (layouts alternate). The
    port's tp=1 server against JAX's is the prefix and overlap suites'
    matter."""
    jcfg, jp, tp, tcfg = model
    warm, *prompts = _prompts(tcfg.vocab_size, [10, 12, 9, 11, 8, 10, 7],
                              shared=16)
    kw = dict(MATRIX_KW, kv_quant=kv_quant, overlap=overlap)
    ref = _serve(GenerationServer(tp, tcfg, device="cpu", tp=1, **kw),
                 prompts, 24, warm)
    assert ref[1]["preemptions"] > 0 and ref[1]["prefix_hits"] > 0
    layouts = [("heads", 2), ("blocks", 2), ("blocks", 4)]
    jax_case = layouts[kv_quant + overlap]
    for layout, deg in layouts:
        got = _serve(GenerationServer(tp, tcfg, device="cpu", tp=deg,
                                      kv_layout=layout, **kw), prompts, 24, warm)
        _assert_same(got, ref)
        assert got[1]["tp_degree"] == deg and got[1]["kv_layout"] == layout
        assert got[1]["kv_pool_shards"] == (deg if layout == "blocks" else 1)
        if (layout, deg) == jax_case:
            want = _serve(JaxServer(jp, jcfg, tp=deg, kv_layout=layout, **kw),
                          prompts, 24, warm)
            _assert_same(got, want, SHARED + TP_KEYS)


def test_blocks_pool_fills_shards_as_jax_round_by_round(model):
    """Both servers stepped round by round under the blocks layout at tp=4
    over a preempting pool: the per-shard occupancy, preemptions and lanes
    agree after every round (the allocator draws from the emptiest shard
    in JAX's order)."""
    jcfg, jp, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size, [10, 12, 9, 11, 8, 10], seed=5)
    kw = dict(MATRIX_KW, prefix_cache_tokens=0, kv_quant=True, overlap=False,
              tp=4, kv_layout="blocks")
    ours = GenerationServer(tp, tcfg, device="cpu", **kw)
    theirs = JaxServer(jp, jcfg, **kw)
    for p in prompts:
        ours.submit(p, 24)
        theirs.submit(p, 24)
    keys = ("kv_pool_shard_occupancy", "preemptions", "slots_busy", "queued",
            "rounds", "kv_blocks_in_use")
    seen = set()
    while True:
        alive = ours.step()
        assert theirs.step() == alive
        a, b = ours.stats(), theirs.stats()
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        seen.add(tuple(a["kv_pool_shard_occupancy"]))
        if not alive:
            break
    assert len(seen) > 3 and a["preemptions"] > 0
    got, want = ours.run(), theirs.run()
    assert sorted(got) == sorted(want)
    for r in got:
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_blocks_through_the_shard_local_kernel(model, kv_quant):
    """JAX's K2 path: the blocks layout with the paged decode kernel (its
    plain version here; JAX's kernel in interpret mode), at tp=2 and 4:
    greedy tokens equal the tp=1 server's, and (int8) the JAX server's."""
    jcfg, jp, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size, [6, 9, 7, 5])
    kw = dict(max_batch=2, max_len=48, chunk=4, prefill_buckets=(16,),
              kv_block_size=8, kv_pool_tokens=512, prefix_cache_tokens=0,
              kv_quant=kv_quant)
    ref = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), prompts, 8)
    for deg in (2, 4):
        got = _serve(GenerationServer(tp, tcfg, device="cpu", tp=deg,
                                      kv_layout="blocks",
                                      decode_attn="cuda_paged", **kw),
                     prompts, 8)
        assert got[1]["decode_backend"] == "cuda_paged"
        _assert_same(got, ref)
    if not kv_quant:
        return
    want = _serve(JaxServer(jp, jcfg, tp=2, kv_layout="blocks",
                            decode_attn="pallas_paged", **kw), prompts, 8)
    _assert_same(ref, want)


def test_heads_through_the_kernel_slotted_and_paged(model):
    """The heads forms of the decode kernel: split KV heads (tp=2) and
    kv-replicated (tp=4), over the slotted arena's re-view (with its own
    prefix store, hit) and over the pool, equal to tp=1."""
    _, _, tp, tcfg = model
    warm, *prompts = _prompts(tcfg.vocab_size, [6, 9, 7, 5, 8], seed=7,
                              shared=16)
    for paged in (dict(prefix_cache_tokens=64),
                  dict(kv_pool_tokens=512, kv_block_size=8)):
        kw = dict(max_batch=2, max_len=48, chunk=4, prefill_buckets=(16, 32),
                  kv_quant=True, **paged)
        ref = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), prompts, 8,
                     warm)
        assert ref[1]["prefix_hits"] == (4 if "prefix_cache_tokens" in paged
                                         else 0)
        for deg in (2, 4):
            got = _serve(GenerationServer(tp, tcfg, device="cpu", tp=deg,
                                          decode_attn="cuda_paged", **kw),
                         prompts, 8, warm)
            _assert_same(got, ref)


@pytest.mark.parametrize("mode", [
    dict(sched_policy="slo_chunked", prefill_chunk=4, itl_slo_ms=0.0),
    dict(persistent=True, overlap=False),
], ids=["slo_chunked", "persistent"])
def test_tp_through_chunked_admission_and_persistent_rounds(model, mode):
    """Chunked (and fused) admission and persistent rounds run across the
    shards too: tp=2 blocks through the kernel and tp=4 heads give tp=1's
    tokens and chunk and round counts."""
    _, _, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size, [13, 9, 17, 6], seed=11)
    kw = dict(max_batch=2, max_len=48, prefill_buckets=(16, 32),
              kv_pool_tokens=512, kv_block_size=8, **mode)
    keys = SHARED + ("rounds", "sched_chunks", "persistent_rounds")
    budgets = [6, 20, 12, 9]  # lanes free while others decode: chunks
    ref = _serve(GenerationServer(tp, tcfg, device="cpu", **kw), prompts,
                 budgets)
    assert ref[1]["sched_chunks"] or ref[1]["persistent_rounds"]
    for extra in (dict(tp=2, kv_layout="blocks", decode_attn="cuda_paged"),
                  dict(tp=4)):
        got = _serve(GenerationServer(tp, tcfg, device="cpu", **kw, **extra),
                     prompts, budgets)
        _assert_same(got, ref, keys)


def test_int8_spill_restore_under_blocks(model):
    """Preemption spills of an int8 pool at tp=2 under blocks (tables mix
    shards, spill widths need not divide tp) restore verbatim: tokens equal
    the never-preempted tp=1 run, and the JAX TP server's counters."""
    jcfg, jp, tp, tcfg = model
    prompts = _prompts(tcfg.vocab_size, [10, 12, 9, 11, 8, 10])
    kw = dict(max_batch=3, max_len=64, chunk=4, prefill_buckets=(16,),
              kv_quant=True, kv_block_size=8, prefix_cache_tokens=0)
    ref = _serve(GenerationServer(tp, tcfg, device="cpu", kv_pool_tokens=512,
                                  **kw), prompts, 24)
    tight = dict(tp=2, kv_layout="blocks", kv_pool_tokens=8 * 14, **kw)
    got = _serve(GenerationServer(tp, tcfg, device="cpu", **tight), prompts, 24)
    assert got[1]["preemptions"] > 0
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    _assert_same(got, _serve(JaxServer(jp, jcfg, **tight), prompts, 24),
                 SHARED + TP_KEYS)


def test_host_tier_demotion_under_blocks(model):
    """Prefix segments demote to host RAM before any preemption and come
    back as hits, at tp=2 under blocks: tokens and the tier's counters
    equal the JAX TP server's, tokens equal the tier-less tp=1 run."""
    jcfg, jp, tp, tcfg = model
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)
             for _ in range(2)]
    kw = dict(max_batch=1, max_len=48, chunk=4, prefill_buckets=(16, 32),
              prefix_cache_tokens=1, kv_block_size=8, kv_pool_tokens=8 * 8)

    def burst(make, **extra):
        srv = make(**extra)
        outs = []
        for i, head in enumerate([heads[0], heads[1], heads[0], heads[1]]):
            r = srv.submit(np.concatenate([head, [50 + i] * 4]).astype(np.int32),
                           8)
            outs.append(np.asarray(srv.run()[r]))
        return outs, srv.stats()

    ref = burst(lambda **e: GenerationServer(tp, tcfg, device="cpu", **kw, **e))
    host = dict(tp=2, kv_layout="blocks", kv_host_tokens=1024)
    got = burst(lambda **e: GenerationServer(tp, tcfg, device="cpu", **kw, **e),
                **host)
    want = burst(lambda **e: JaxServer(jp, jcfg, **kw, **e), **host)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1]["kv_demotions"] > 0 and got[1]["preemptions"] == 0
    _assert_same(got, want, SHARED + TP_KEYS + ("kv_demotions",
                                                 "kv_prefetches"))


@pytest.mark.parametrize("heads", [(8, 2, 2), (8, 2, 4), (8, 1, 2), (12, 3, 2)],
                         ids=["split", "replicated", "kv1", "straddle"])
def test_heads_form_attends_per_shard(model, heads, monkeypatch):
    """The heads forms of the decode attention hand each shard's kernel
    call its own ``H/tp`` query heads and the KV heads they read, as the
    prefill does (the KV heads' share when they divide ``tp``, the one
    KV head a shard's heads share when they do not); only a shard whose
    heads straddle KV heads runs every head. The shards' outputs equal
    the unsharded call's (fp32 summation-order rounding)."""
    _, _, _, tcfg = model
    H, KV, tp = heads
    cfg = dataclasses.replace(tcfg, n_heads=H, n_kv_heads=KV)
    B, D, bs, NB = 3, cfg.head_dim, 8, 4
    rng = np.random.default_rng(H * KV * tp)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, (B * NB + 2) * bs, KV, D),
                                                 np.float32)) for _ in "kv")
    tables = torch.from_numpy(
        2 + rng.permutation(B * NB).reshape(B, NB).astype(np.int32))
    pos = torch.tensor([5, 17, NB * bs - 1], dtype=torch.int32)
    kw = dict(paged=True, block_size=bs, paged_len=NB * bs)
    whole = attention.make_decode_attn_fn(cfg, **kw)(q, k, v, tables, pos)
    calls = []
    plain = decode_attn.paged_decode_attention

    def spy(q, ck, cv, *a, **k):
        calls.append((q.shape[2], ck.shape[2]))
        return plain(q, ck, cv, *a, **k)

    monkeypatch.setattr(decode_attn, "paged_decode_attention", spy)
    mesh = ttp.ServingMesh.for_config(cfg, tp, "cpu")
    outs = attention.make_decode_attn_fn(cfg, mesh=mesh, **kw)(
        q, k, v, tables, pos)
    straddle = mesh.kv_heads(0) is None
    want = (H, KV) if straddle else (H // tp, max(KV // tp, 1))
    assert calls == [want] * tp
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), whole.numpy(),
                               rtol=2.0 ** -20, atol=2.0 ** -20)


# ----- the shard-local kernel's plain version against JAX's kernel -----------


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_shard_local_plain_matches_jax_kernel(int8):
    """``paged_decode_split_reference`` in its shard-local form against
    JAX ``pallas_paged_decode_attention(shard_lo=, shard_blocks=,
    return_stats=True, interpret=True)`` for each shard of tp 2 and 4:
    ``m``, ``l`` and ``acc`` within fp32 summation-order rounding (2^-20
    relative; the logits are dot products summed in another order), the
    empty rows of a shard exact; the merged shards within the same of the
    unsharded plain version, bit-equal for the lanes on one shard."""
    rng = np.random.default_rng(int(int8))
    B, H, KV, D, bs, NB = 4, 4, 2, 16, 8, 6
    for tp in (2, 4):
        nbl = 2 * NB + 2
        NT = tp * nbl * bs
        q = rng.standard_normal((B, 1, H, D), np.float32)
        k = rng.standard_normal((1, NT, KV, D), np.float32)
        v = rng.standard_normal((1, NT, KV, D), np.float32)
        tables = np.stack([
            np.arange(2, 2 + NB), (tp - 1) * nbl + np.arange(NB),
            np.array([(j % tp) * nbl + 2 + j for j in range(NB)]),
            rng.integers(2, tp * nbl, NB)]).astype(np.int32)
        pos = np.array([NB * bs - 1, 21, 40, 10_000], np.int32)
        if int8:
            jk, jv = jquant.quantize_kv(jnp.asarray(k)), jquant.quantize_kv(
                jnp.asarray(v))
            tk = tquant.QTensor(torch.from_numpy(np.array(jk.q)),
                                torch.from_numpy(np.array(jk.scale)))
            tv = tquant.QTensor(torch.from_numpy(np.array(jv.q)),
                                torch.from_numpy(np.array(jv.scale)))
        else:
            jk, jv = jnp.asarray(k), jnp.asarray(v)
            tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        tq, tt, tpos = (torch.from_numpy(a) for a in (q, tables, pos))
        kw = dict(block_size=bs, paged_len=NB * bs)
        parts = []
        for s in range(tp):
            rows = slice(s * nbl * bs, (s + 1) * nbl * bs)

            def cut(c):
                return (type(c)(*(t[:, rows] for t in c))
                        if isinstance(c, tuple) else c[:, rows])

            acc, m, l = jdecode.pallas_paged_decode_attention(
                jnp.asarray(q), cut(jk), cut(jv), jnp.asarray(tables),
                jnp.asarray(pos), block_size=bs, paged_len=NB * bs,
                interpret=True, shard_lo=jnp.asarray([s * nbl], jnp.int32),
                shard_blocks=nbl, return_stats=True)
            got = decode_attn.paged_decode_shard_stats(
                tq, cut(tk), cut(tv), tt, tpos, **kw, shard_lo=s * nbl,
                shard_blocks=nbl)
            parts.append(got)
            live = slice(0, 3)  # the dead lane's rows are garbage on both
            np.testing.assert_allclose(got[1][live].numpy(),
                                       np.asarray(m)[live, ..., 0],
                                       rtol=2.0 ** -20, atol=0)
            np.testing.assert_allclose(got[2][live].numpy(),
                                       np.asarray(l)[live, ..., 0],
                                       rtol=2.0 ** -20, atol=0)
            np.testing.assert_allclose(got[0][live].numpy(),
                                       np.asarray(acc)[live],
                                       rtol=2.0 ** -20, atol=2.0 ** -20)
        merged = attention.merge_shard_stats(parts, tq.dtype)
        whole = decode_attn.paged_decode_split_reference(tq, tk, tv, tt, tpos,
                                                         **kw)
        np.testing.assert_allclose(merged[:3].numpy(), whole[:3].numpy(),
                                   rtol=2.0 ** -20, atol=2.0 ** -20)
        assert torch.equal(merged[:2], whole[:2])  # lanes on one shard


# ----- partition rules, specs, the env ladder --------------------------------


def _axis(spec):
    """A JAX PartitionSpec (or a QTensor of two) as the port's split axis."""
    if isinstance(spec, jquant.QTensor):
        return tquant.QTensor(_axis(spec.q), _axis(spec.scale))
    hits = [i for i, a in enumerate(tuple(spec)) if a is not None]
    return hits[0] if hits else None


def _axes_of_jax(spec_tree):
    """A JAX PartitionSpec tree as the port's split axes."""
    return {k: (_axes_of_jax(v) if isinstance(v, dict) else _axis(v))
            for k, v in spec_tree.items()}


def _shaped_pair(jcfg, fused: bool, quantized: bool):
    """``(jax_shapes, torch_params, torch_cfg)`` of one layout: JAX's
    parameter tree traced to its shapes (init, fuse and quantize are not
    computed; the specs read only shapes), and the port's parameters of
    those shapes, random from a seed, through the bridge."""
    def make():
        params = jt.init_params(jax.random.PRNGKey(0), jcfg)
        if fused:
            params = jt.fuse_decoder_params(params)
        return jquant.quantize_decoder_params(params) if quantized else params

    shapes = jax.eval_shape(make)
    rng = np.random.default_rng(0)
    arrays = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    tcfg = bridge.config_from_fields(dataclasses.asdict(jcfg))
    return shapes, bridge.params_from_numpy(arrays, tcfg, "cpu"), tcfg


@pytest.mark.parametrize("family", sorted(CONFIGS) + sorted(FAMILIES))
def test_serving_rules_split_every_family_as_jax(family):
    """Every parameter of every family, in the training, fused and int8
    fused layouts, splits on the axis JAX's serving specs shard; the
    shards' pieces reassemble into the whole leaf; an unmatched path
    raises in both packages."""
    jcfg = {**CONFIGS, **FAMILIES}[family]()
    for fused, quantized in ((False, False), (True, False), (True, True)):
        jp, tp, tcfg = _shaped_pair(jcfg, fused, quantized)
        assert tshard.serving_param_specs(tp) == _axes_of_jax(
            jshard.serving_param_specs(jp))
        trees = tshard.shard_serving_params(tp, tcfg, 2)
        for name, leaf in tp["layers"].items():
            axis = tshard.serving_param_specs(tp)["layers"][name]
            if isinstance(leaf, tquant.QTensor):
                leaf, axis = leaf.q, axis.q
                pieces = [t["layers"][name].q for t in trees]
            else:
                pieces = [t["layers"][name] for t in trees]
            if axis is None:
                assert all(p is leaf for p in pieces)
            elif name in ("wqkv", "bqkv", "w_gateup"):
                sizes = {"wqkv": (tcfg.q_dim, tcfg.kv_dim, tcfg.kv_dim),
                         "bqkv": (tcfg.q_dim, tcfg.kv_dim, tcfg.kv_dim),
                         "w_gateup": (tcfg.d_ff, tcfg.d_ff)}[name]
                halves = [p.split([n // 2 for n in sizes], dim=axis)
                          for p in pieces]
                whole = torch.cat([torch.cat([h[i] for h in halves], dim=axis)
                                   for i in range(len(sizes))], dim=axis)
                assert torch.equal(whole, leaf)
            else:
                assert torch.equal(torch.cat(pieces, dim=axis), leaf)
    bad = {"layers": {"mystery": torch.zeros(2, 3)}}
    with pytest.raises(ValueError, match="no serving partition rule"):
        tshard.serving_param_specs(bad)
    with pytest.raises(ValueError, match="no serving partition rule"):
        jshard.serving_param_specs({"layers": {"mystery": jnp.zeros((2, 3))}})


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_kv_specs_per_layout_as_jax(model, tp):
    """``decode_attn_specs`` gives, per layout, the axes of JAX's
    PartitionSpecs, and the heads split where JAX's do."""
    jcfg, _, _, tcfg = model
    for layout in ttp.KV_LAYOUTS:
        for quantized in (False, True):
            assert tshard.decode_attn_specs(tcfg, tp, quantized, layout) == tuple(
                _axis(s) for s in jshard.decode_attn_specs(jcfg, tp, quantized,
                                                           layout))
    assert ttp.kv_heads_shardable(tcfg, tp) == jtp.kv_heads_shardable(jcfg, tp)


def test_tp_from_env_ladder_and_degrades():
    """JAX's ladder (``tests/test_tp_serving.py``): nothing injected is 1,
    the chip list's length, the accelerator type's host-local chips, the
    override over both (0 and 1 pin one shard), a malformed override
    degrades to the derived degree, a degree above the devices to 1."""
    for env, want in (
            ({}, 1), ({"TPU_VISIBLE_CHIPS": "0,1,2,3"}, 4),
            ({"TPU_ACCELERATOR_TYPE": "v5litepod-8"}, 8),
            ({"TPU_ACCELERATOR_TYPE": "v4-16"}, 4),
            ({"TPU_ACCELERATOR_TYPE": "bogus-8"}, 1),
            ({"TPU_VISIBLE_CHIPS": "0,1,2,3", "KATA_TPU_TP": "2"}, 2),
            ({"TPU_VISIBLE_CHIPS": "0,1,2,3", "KATA_TPU_TP": "1"}, 1),
            ({"TPU_VISIBLE_CHIPS": "0,1,2,3", "KATA_TPU_TP": "0"}, 1),
            ({"TPU_VISIBLE_CHIPS": "0,1", "KATA_TPU_TP": "lots"}, 2),
            ({"TPU_VISIBLE_CHIPS": "0,1", "KATA_TPU_TP": "-3"}, 2),
            ({"KATA_TPU_TP": "64"}, 1)):
        assert ttp.tp_from_env(env, device_count=8) == want, env
        assert jtp.tp_from_env(env=env, device_count=8) == want, env
    # This package counts the devices itself: one CPU here.
    assert ttp.tp_from_env({"KATA_TPU_TP": "2"}) == ttp.tp_from_env(
        {"KATA_TPU_TP": "2"}, device_count=ttp.local_device_count())


def test_tp_knob_contract(model, monkeypatch):
    """Explicit values that cannot serve raise, env values degrade: tp < 1,
    tp with ring caches or speculation, a degree the heads do not divide,
    an unknown layout, blocks on a slotted server; KVPool rounds a sharded
    pool to whole blocks a shard with the reserved blocks on shard 0."""
    _, _, tp, tcfg = model
    kw = dict(max_batch=2, max_len=48, prefill_buckets=(16,))
    with pytest.raises(ValueError, match="tp must be >= 1"):
        GenerationServer(tp, tcfg, device="cpu", tp=0, **kw)
    for bad, reason in ((dict(ring_kv=True), "ring_kv"),
                        (dict(speculative_k=2), "speculative")):
        with pytest.raises(ValueError, match=reason):
            GenerationServer(tp, tcfg, device="cpu", tp=2, **kw, **bad)
    with pytest.raises(ValueError, match="indivisible:n_heads"):
        GenerationServer(tp, tcfg, device="cpu", tp=3, **kw)
    with pytest.raises(ValueError, match="unknown kv_layout"):
        GenerationServer(tp, tcfg, device="cpu", kv_layout="rows", **kw)
    with pytest.raises(ValueError, match="requires a paged KV pool"):
        GenerationServer(tp, tcfg, device="cpu", kv_layout="blocks", **kw)
    with pytest.raises(ValueError, match="tp_min must be >= 1"):
        GenerationServer(tp, tcfg, device="cpu", tp_min=0, **kw)
    monkeypatch.setenv("KATA_TPU_KV_LAYOUT", "blocks")
    monkeypatch.setenv("KATA_TPU_TP", "3")
    st = GenerationServer(tp, tcfg, device="cpu", **kw).stats()
    assert (st["kv_layout"], st["tp_degree"]) == ("heads", 1)
    monkeypatch.setenv("KATA_TPU_KV_LAYOUT", "bogus")
    assert GenerationServer(tp, tcfg, device="cpu", kv_pool_tokens=256,
                            kv_block_size=8, **kw).stats()["kv_layout"] == "heads"
    pool = KVPool(tcfg, 8 * 15, 8, shards=4)
    assert (pool.num_blocks, pool.shard_blocks, pool.blocks_total) == (12, 3, 10)
    assert pool.shard_occupancy() == [0.0] * 4
    got = pool.try_alloc(5)
    assert [pool.shard_of(b) for b in got] == [1, 2, 3, 1, 2]
    assert pool.shard_occupancy() == [0.0, 0.6667, 0.6667, 0.3333]
    pool.unref(got)
    assert pool.blocks_in_use == 0
