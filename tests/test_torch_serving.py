"""PyTorch port, serving: the port's ``GenerationServer`` against the JAX
one on the same weights (fp32, the CPU) — ragged prompts, ``max_batch=2``
so slots refill, mixed budgets, an eos case, int8 and bf16 KV, both decode
backends of the port. ``kv_quant`` is passed explicitly: the suite pins
``KATA_TPU_KV_QUANT=bf16``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
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


@pytest.mark.parametrize("kwarg", [
    dict(kv_host_tokens=64), dict(kv_layout="blocks"), dict(tp=2),
    dict(speculative_k=2),
    dict(ring_kv=True), dict(prefix_cache_tokens=64),
    dict(temperature=0.7, persistent=True),
    dict(sched_policy="slo_chunked"),
    dict(persistent=True), dict(checkpoint_rounds=4),
], ids=lambda kw: next(iter(kw)))
def test_unported_modes_raise(models, kwarg):
    """Modes not ported yet raise ``NotImplementedError``. The chunked
    admission policy and persistent decode are ported: they build, and
    sampled persistent decode raises the JAX server's ``ValueError`` (its
    rounds are greedy only)."""
    _, _, tp, tcfg = models
    if "persistent" in kwarg and "temperature" in kwarg:
        with pytest.raises(ValueError, match="sampling"):
            GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)
    elif "persistent" in kwarg or "sched_policy" in kwarg:
        stats = GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg).stats()
        assert stats["persistent"] == int("persistent" in kwarg)
        assert stats["sched_policy"] == kwarg.get("sched_policy", "fifo_batch")
    else:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            GenerationServer(tp, tcfg, device="cpu", **KW, **kwarg)


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
