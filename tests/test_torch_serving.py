"""PyTorch port, serving: the port's ``GenerationServer`` against the JAX
one on the same weights (fp32, the CPU) — ragged prompts, ``max_batch=2``
so slots refill, mixed budgets, an eos case, int8 and bf16 KV, both decode
backends of the port. ``kv_quant`` is passed explicitly: the suite pins
``KATA_TPU_KV_QUANT=bf16``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu_torch.guest import resilience as tres
from kata_xpu_device_plugin_tpu_torch.guest import serving as tserving
from kata_xpu_device_plugin_tpu_torch.guest.serving import (
    GenerationServer,
    serve_batch,
)

from .torch_parity import CONFIGS, build_pair

BUCKETS = (8, 16)
# Lengths 5 and 7 share bucket 8, so the first admission is batched.
LENGTHS = (5, 7, 11, 16, 3)
BUDGETS = (6, 9, 4, 12, 7)
KW = dict(max_batch=2, max_len=48, prefill_buckets=BUCKETS)


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


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
def test_server_matches_jax_server(models, kv_quant):
    jcfg, jp, tp, tcfg = models
    want = _serve(JaxServer(jp, jcfg, kv_quant=kv_quant, **KW))
    for backend in tserving.attention.DECODE_ATTN_BACKENDS:
        srv = GenerationServer(tp, tcfg, kv_quant=kv_quant, decode_attn=backend,
                               device="cpu", **KW)
        got = _serve(srv)
        for w, g, b in zip(want, got, BUDGETS):
            assert len(g) == b
            np.testing.assert_array_equal(g, w)
        stats = srv.stats()
        assert stats["decode_backend"] == backend
        assert stats["kv_quant"] == ("int8" if kv_quant else "bf16")
        assert stats["prefills"] == len(LENGTHS)
        assert stats["prefill_batches"] >= 1
        assert stats["tokens_emitted"] >= sum(BUDGETS)
        assert srv.failures() == {}


def test_server_eos_matches_jax_server(models):
    jcfg, jp, tp, tcfg = models
    plain = _serve(GenerationServer(tp, tcfg, kv_quant=True, device="cpu", **KW))
    eos = int(plain[3][4])  # a token the longest request emits mid-stream
    want = _serve(JaxServer(jp, jcfg, kv_quant=True, eos_id=eos, **KW))
    got = _serve(GenerationServer(tp, tcfg, kv_quant=True, eos_id=eos,
                                  decode_attn="cuda_paged", device="cpu", **KW))
    assert len(got[3]) <= 5 and got[3][-1] == eos
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_stats_keep_the_jax_names(models):
    jcfg, jp, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, kv_quant=True, device="cpu", **KW)
    _serve(srv)
    ours = srv.stats()
    theirs = JaxServer(jp, jcfg, kv_quant=True, **KW).stats()
    shared = {"rounds", "prefills", "prefill_batches", "tokens_emitted",
              "ttft_s", "decode_token_s", "arena_bytes", "decode_backend",
              "decode_backend_reason"}
    assert shared <= set(ours) and shared <= set(theirs)
    assert ours["ttft_s"]["count"] == len(LENGTHS)
    assert ours["decode_token_s"]["count"] == ours["rounds"] > 0
    # int8 arena: payload bytes plus fp32 scales, k and v.
    L, KV, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert ours["arena_bytes"] == 2 * L * 2 * 48 * KV * (D + 4)


def test_serve_batch_returns_input_order(models):
    _, _, tp, tcfg = models
    prompts = _prompts(tcfg.vocab_size)
    out = serve_batch(tp, tcfg, prompts, 5, kv_quant=False, device="cpu", **KW)
    assert [len(o) for o in out] == [5] * len(prompts)


def test_decode_attn_resolution(models, monkeypatch):
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", **KW)
    assert srv.stats()["decode_backend"] == "reference"
    assert srv.stats()["decode_backend_reason"] == "cpu_backend"
    monkeypatch.setenv("KATA_TPU_DECODE_ATTN", "cuda_paged")
    stats = GenerationServer(tp, tcfg, device="cpu", **KW).stats()
    assert (stats["decode_backend"], stats["decode_backend_reason"]) == (
        "cuda_paged", "forced")
    monkeypatch.setenv("KATA_TPU_DECODE_ATTN", "bogus")
    assert GenerationServer(tp, tcfg, device="cpu", **KW).stats()[
        "decode_backend"] == "reference"
    with pytest.raises(ValueError, match="unknown decode_attn"):
        GenerationServer(tp, tcfg, device="cpu", decode_attn="bogus", **KW)


def test_kv_quant_resolution(monkeypatch):
    monkeypatch.setenv("KATA_TPU_KV_QUANT", "bf16")
    assert tserving.resolve_kv_quant(None) is False
    assert tserving.resolve_kv_quant(True) is True
    monkeypatch.setenv("KATA_TPU_KV_QUANT", "int8")
    assert tserving.resolve_kv_quant(None) is True
    monkeypatch.setenv("KATA_TPU_KV_QUANT", "nonsense")
    assert tserving.resolve_kv_quant(None) is True  # degrades to the default
    monkeypatch.delenv("KATA_TPU_KV_QUANT")
    assert tserving.resolve_kv_quant(None) is True


# The JAX server's arguments for modes not ported yet, each at a value that
# selects the mode, and the ROADMAP item its error names.
UNPORTED = {
    "speculative_k": (2, "11b"), "ring_kv": (True, "11b"),
    "checkpoint_rounds": (4, "9b"), "mesh": (object(), "12b"),
    "draft": ((None, None), "11b"), "spec_opt_in": (True, "11b"),
    "strict": (True, "9a"), "tripwire": (True, "9a"),
    "heartbeat_rounds": (2, "9a"), "watchdog": (True, "9a"),
    "fault_injector": (tres.FaultInjector([tres.FaultSpec("prefill", 0)]),
                       "9b"), "fence_timeout_s": (5.0, "9b"),
    "quarantine_after": (2, "9b"), "recovery_backoff_s": (0.0, "9b"),
    "degraded": (True, "9b"),
}
# Their no-op values, which build.
NO_OP = dict(mesh=None, draft=None, strict=False, tripwire=False,
             fault_injector=None, fence_timeout_s=None, quarantine_after=None,
             recovery_backoff_s=None, spec_opt_in=False, tp_min=1,
             degraded=False, heartbeat_rounds=0, watchdog=None)


@pytest.mark.parametrize("kwarg", [
    dict(kv_host_tokens=64), dict(kv_layout="blocks", kv_pool_tokens=256),
    dict(tp=2), dict(prefix_cache_tokens=64),
    dict(temperature=0.7, persistent=True),
    dict(sched_policy="slo_chunked"),
    dict(persistent=True),
] + [{k: v} for k, (v, _) in UNPORTED.items()],
    ids=lambda kw: next(iter(kw)))
def test_unported_modes_raise(models, kwarg):
    """Modes not ported yet raise ``NotImplementedError`` naming their
    ROADMAP item. The chunked admission policy, persistent decode, the
    prefix cache and tensor parallelism under both KV layouts are ported:
    they build, and sampled persistent decode raises the JAX server's
    ``ValueError`` (its rounds are greedy only), as does the host KV tier
    on this slotted server (it needs a paged pool). The telemetry
    arguments of item 9a, the crash-tolerance arguments of item 9b and
    the speculative and ring arguments of item 11b are ported: they build
    and arm what they name (a draft with the ``speculative_k`` it needs,
    a ring on the config with a window it needs; the suite sets
    ``KATA_TPU_SPEC=1``, which opts speculation in)."""
    _, _, tp, tcfg = models
    if UNPORTED.get(next(iter(kwarg)), (None, ""))[1] == "11b":
        from dataclasses import replace

        from kata_xpu_device_plugin_tpu_torch.models import self_draft

        (name,) = kwarg
        if name == "ring_kv":
            wcfg = replace(tcfg, sliding_window=8)
            srv = GenerationServer(tp, wcfg, device="cpu", **KW, **kwarg)
            assert srv.ring_kv and srv.arena[0].shape[2] == 8
            assert srv.stats()["decode_backend_reason"] == "ring_kv"
        else:
            kw = {"speculative_k": 2, "spec_opt_in": True, **kwarg}
            if name == "draft":
                kw["draft"] = self_draft(tp, tcfg, 1)
            srv = GenerationServer(tp, tcfg, device="cpu", **KW, **kw)
            assert srv.speculative_k == 2
            assert srv.stats()["draft_acceptance"] == 0.0
            assert srv.stats()["decode_backend_reason"] == "speculative"
            assert (srv.draft is not None) == (name == "draft")
    elif UNPORTED.get(next(iter(kwarg)), (None, ""))[1] == "9b":
        srv = GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
        ((name, value),) = kwarg.items()
        armed = {"checkpoint_rounds": srv.stats()["checkpoint_rounds"],
                 "fault_injector": srv._inj, "fence_timeout_s":
                 srv._fence_timeout_s, "quarantine_after": srv._quarantine_k,
                 "recovery_backoff_s": srv._backoff_s,
                 "degraded": srv._degraded_ok}[name]
        assert armed is value or armed == value
        if name == "fault_injector":
            assert srv._inj.armed
    elif UNPORTED.get(next(iter(kwarg)), (None, ""))[1] == "9a":
        srv = GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
        stats = srv.stats()
        (name,) = kwarg
        if name == "strict":
            assert srv.strict is True
        elif name == "tripwire":
            assert stats["tripwire_enabled"] == 1
        elif name == "heartbeat_rounds":
            assert stats["heartbeat_rounds"] == 2
            assert stats["devledger"]["armed"] == 1
        else:
            assert stats["watchdog"]["observed"] == 0
            assert srv._watchdog is not None
    elif "kv_host_tokens" in kwarg:
        with pytest.raises(ValueError, match="paged"):
            GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
    elif "kv_layout" in kwarg or "tp" in kwarg:
        stats = GenerationServer(tp, tcfg, device="cpu",
                                 **KW, **{"tp": 2, **kwarg}).stats()
        assert stats["tp_degree"] == 2
        assert stats["kv_layout"] == kwarg.get("kv_layout", "heads")
        assert stats["kv_pool_shards"] == (2 if "kv_layout" in kwarg else 1)
    elif "prefix_cache_tokens" in kwarg:
        srv = GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
        assert srv.prefix_store.capacity_tokens == 64
    elif "persistent" in kwarg and "temperature" in kwarg:
        with pytest.raises(ValueError, match="sampling"):
            GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
    elif "persistent" in kwarg or "sched_policy" in kwarg:
        stats = GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg).stats()
        assert stats["persistent"] == int("persistent" in kwarg)
        assert stats["sched_policy"] == kwarg.get("sched_policy", "fifo_batch")
    else:
        (name,) = kwarg
        item = UNPORTED[name][1]
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP Queue 1 item {item}\).* not ported yet"):
            GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)


def test_server_takes_every_argument_of_the_jax_server(models):
    """Every parameter of the JAX server's constructor is one of the
    port's (a JAX caller's keywords never raise ``TypeError``), and their
    no-op values build."""
    import inspect

    ours = set(inspect.signature(GenerationServer.__init__).parameters)
    theirs = set(inspect.signature(JaxServer.__init__).parameters)
    assert theirs <= ours, sorted(theirs - ours)
    assert set(NO_OP) | set(UNPORTED) <= theirs
    _, _, tp, tcfg = models
    stats = GenerationServer(tp, tcfg, device="cpu", **KW, **NO_OP).stats()
    assert stats["tp_degree"] == 1


# JAX stats keys the port does not compute yet, by the ROADMAP item that
# brings them (resilience, 9b, brought all of its own).
STATS_NOT_YET = {
    "9b": set(),
}


@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_stats_have_the_jax_keys(models, paged):
    """The port's ``stats()`` keys include the JAX server's, less the
    named keys of items not ported (none left); the occupancy and
    resilience keys it shares take the JAX values mid-run, after one
    lock-step round of the same requests."""
    jcfg, jp, tp, tcfg = models
    kw = dict(KW, kv_quant=True, overlap=False)
    if paged:
        kw.update(kv_pool_tokens=256, kv_block_size=8, prefix_cache_tokens=1,
                  kv_host_tokens=64)
    ours = GenerationServer(tp, tcfg, device="cpu", **kw)
    theirs = JaxServer(jp, jcfg, **kw)
    for srv in (ours, theirs):
        for p in _prompts(tcfg.vocab_size):
            srv.submit(p, 20)
        srv.step()
    a, b = ours.stats(), theirs.stats()
    assert set(b) - set(a) == set().union(*STATS_NOT_YET.values())
    for k in ("tokens_per_round", "slots_busy", "queued", "batch_occupancy",
              "kv_slot_utilization", "kv_layout", "kv_pool_shards",
              "tp_degree", "tp_degraded", "tp_shrinks",
              "kv_pool_shard_occupancy", "recoveries", "quarantined",
              "device_stalls", "checkpoints", "checkpoint_rounds"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert a["slots_busy"] == 2 and a["queued"] == len(LENGTHS) - 2


def test_submit_validates_like_jax(models):
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", **KW)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([], 4)
    with pytest.raises(ValueError, match="exceeds arena max_len"):
        srv.submit(np.zeros(40, np.int32), 9)


def test_cuda_servers_need_flash_buckets():
    """On CUDA every prefill runs the flash kernel, so a server there needs
    prefill buckets that are all flash-kernel lengths."""
    with pytest.raises(ValueError, match="needs prefill_buckets"):
        tserving.require_flash_buckets((), 256)
    with pytest.raises(ValueError, match=r"\[100, 200\]"):
        tserving.require_flash_buckets((100, 128, 200), 256)
    tserving.require_flash_buckets((128, 256, 512, 1024), 256)
