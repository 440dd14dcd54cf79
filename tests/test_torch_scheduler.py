"""PyTorch port, admission scheduling: the policy objects of
``guest/scheduler.py`` against the JAX package's on the same observation
sequences; ``prefill_suffix`` against the JAX function (scalar and ``[B]``
``true_len``, chained slices against one prefill); the port's
``slo_chunked`` server against the JAX server built with the same
arguments (slotted and paged, overlapped and lock-step, fused and not):
equal tokens and equal ``sched_chunks``/``sched_defers``/
``fused_admissions``/``rounds``/``prefills``; and the knob rules (an env
value degrades, an explicit one raises). fp32, the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest import scheduler as jsched
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.guest import scheduler as tsched
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, build_pair, pool_from_jax, pool_to_numpy

# The JAX scheduler tests' requests: staggered budgets, so admissions land
# while other lanes decode and chunking engages.
LENS = (14, 9, 12, 7, 15, 11)
BUDGETS = (6, 12, 9, 5, 11, 7)
KW = dict(max_batch=2, max_len=32, chunk=4, prefill_buckets=(16,))
# itl_slo_ms=0 defers whenever estimates exist: maximal chunking.
SLO = dict(sched_policy="slo_chunked", prefill_chunk=4, itl_slo_ms=0.0)
LAYOUTS = {
    "slotted": {},
    "paged": dict(max_batch=3, kv_pool_tokens=64, kv_block_size=4),
}
COUNTERS = ("rounds", "prefills", "tokens_emitted", "sched_chunks",
            "sched_defers", "fused_admissions", "preemptions",
            "prefill_chunk_tokens", "itl_slo_ms", "fused_enabled")


@pytest.fixture(scope="module")
def models():
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + build_pair(jcfg, seed=0)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def _serve(server):
    rids = [server.submit(p, b) for p, b in zip(_prompts(server.cfg.vocab_size),
                                                BUDGETS)]
    out = server.run()
    return [out[r] for r in rids], server.stats()


def _both(models, **kw):
    jcfg, jp, tp, tcfg = models
    kw = {**KW, **kw}
    return (_serve(JaxServer(jp, jcfg, **kw)),
            _serve(GenerationServer(tp, tcfg, device="cpu", **kw)))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----- policy objects ---------------------------------------------------------

# Observation scripts: ("directive", kwargs) | ("prefill", tokens, s) |
# ("round", s, steps) | ("queue", s) | ("config", kwargs) | ("reset",).
SCRIPTS = {
    "bootstrap_then_defer": [
        ("directive", dict(live_lanes=2, pending_tokens=1024)),
        ("prefill", 1000, 0.1), ("round", 0.010, 0),
        ("directive", dict(live_lanes=0, pending_tokens=4096)),
        ("directive", dict(live_lanes=2, pending_tokens=64)),
        ("directive", dict(live_lanes=2, pending_tokens=1024)),
        ("directive", dict(live_lanes=1, pending_tokens=256)),
        ("directive", dict(live_lanes=2, pending_tokens=32, partial=True)),
        ("queue", 0.25), ("queue", -1.0),
    ],
    "violations_and_steps": [
        ("round", 0.2, 4), ("round", 0.02, 4), ("round", 0.5, 1),
        ("round", 0.0, 2), ("prefill", 0, 1.0), ("prefill", 64, 0.05),
        ("directive", dict(live_lanes=3, pending_tokens=512)),
        ("directive", dict(live_lanes=3, pending_tokens=512, partial=True)),
    ],
    "regime_change": [
        ("prefill", 128, 0.04), ("round", 0.08, 8),
        ("config", dict(decode_steps=8)),
        ("directive", dict(live_lanes=1, pending_tokens=900)),
        ("config", dict(decode_steps=2, fused=True)),
        ("directive", dict(live_lanes=1, pending_tokens=900)),
        ("prefill", 128, 0.04), ("round", 0.08, 0),
        ("directive", dict(live_lanes=1, pending_tokens=900)),
        ("reset",),
        ("directive", dict(live_lanes=1, pending_tokens=900)),
    ],
}


def _play(sched, script):
    seen = []
    for op, *args in script:
        if op == "directive":
            d = sched.directive(**args[0])
            seen.append((d.admit, d.defer_reason, d.projected_itl_ms, d.fused))
        elif op == "prefill":
            sched.note_prefill(*args)
        elif op == "round":
            seen.append(sched.note_round(*args))
        elif op == "queue":
            sched.note_queue_delay(*args)
        elif op == "config":
            seen.append(sched.note_config(**args[0]))
        else:
            sched.reset_estimates()
        seen.append(sched.projected_itl_s(700))
    return seen, sched.stats()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("policy,fused", [
    ("fifo_batch", False), ("slo_chunked", False), ("slo_chunked", True)])
def test_policy_matches_jax(policy, fused, script):
    kw = dict(chunk_tokens=64, slo_ms=50.0, decode_steps=4, fused=fused)
    want = _play(jsched.make_scheduler(policy, **kw), SCRIPTS[script])
    got = _play(tsched.make_scheduler(policy, **kw), SCRIPTS[script])
    assert got == want


def test_policy_constants_and_errors_match_jax():
    assert tsched.DEFAULT_PREFILL_CHUNK == jsched.DEFAULT_PREFILL_CHUNK
    assert tsched.DEFAULT_ITL_SLO_MS == jsched.DEFAULT_ITL_SLO_MS
    assert tsched.POLICIES == jsched.POLICIES
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        tsched.make_scheduler("round_robin", chunk_tokens=4, slo_ms=1.0)
    with pytest.raises(ValueError, match="prefill chunk"):
        tsched.SLOChunkedScheduler(chunk_tokens=0)
    assert tsched.Directive(admit=True) == tsched.Directive(True, "", 0.0, False)


# ----- prefill_suffix ---------------------------------------------------------


def _jax_caches(jcfg, B, max_len, quantized):
    return jt.init_kv_caches(jcfg, B, max_len, quantized=quantized)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32-kv", "int8-kv"])
@pytest.mark.parametrize("form", ["scalar", "vector", "none"])
def test_prefill_suffix_matches_jax(models, quantized, form):
    """A suffix of 6 tokens (right-padded rows) after a prefix of 7 rows
    already in the caches: logits, ``pos`` and every cache row."""
    jcfg, jp, tp, tcfg = models
    rng = np.random.default_rng(5)
    B, off, S, max_len = 2, 7, 6, 24
    prefix = rng.integers(0, jcfg.vocab_size, (B, off)).astype(np.int32)
    suffix = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc, _l, _p = jt.prefill(jp, jnp.asarray(prefix), jcfg, max_len,
                            kv_quantized=quantized)
    tl = {"scalar": 4, "vector": np.array([6, 3], np.int32), "none": None}[form]
    tc = pool_from_jax(jc)
    jargs = {} if tl is None else dict(true_len=jnp.asarray(tl, jnp.int32))
    targs = {} if tl is None else dict(true_len=torch.as_tensor(tl))
    jc, jlast, jpos = jt.prefill_suffix(jp, jnp.asarray(suffix), jcfg, jc,
                                        jnp.int32(off), return_logits=True,
                                        **jargs)
    tc2, tlast, tpos = tt.prefill_suffix(tp, torch.from_numpy(suffix).long(),
                                         tcfg, tc, off, return_logits=True,
                                         **targs)
    assert tc2 is tc  # written in place
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(tpos), (B,)),
                                  np.broadcast_to(np.asarray(jpos), (B,)))
    for a, b in zip(pool_to_numpy(tc), pool_to_numpy(jc)):
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                   rtol=1e-4, atol=1e-4 if a.dtype != np.int8 else 1)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32-kv", "int8-kv"])
def test_chained_slices_equal_one_prefill(models, quantized):
    """13 prompt tokens in slices of 5, 5 and 3 (the last right-padded to
    5) from empty caches, against the same slices in JAX and, with fp32
    caches, against one prefill of the prompt in the port: logits,
    ``pos``, cache rows. (An int8 cache's slices attend to the quantized
    rows of the slices before, where one prefill attends to its fresh
    k/v.)"""
    jcfg, jp, tp, tcfg = models
    prompt = np.random.default_rng(11).integers(0, jcfg.vocab_size, 13).astype(np.int32)
    max_len = 32
    full, f_last, f_pos = tt.prefill(tp, torch.from_numpy(prompt).long()[None],
                                     tcfg, max_len, return_logits=True,
                                     kv_quantized=quantized)
    tc = tt.init_kv_caches(tcfg, 1, max_len, device="cpu", quantized=quantized)
    jc = _jax_caches(jcfg, 1, max_len, quantized)
    off = 0
    while off < len(prompt):
        take = min(5, len(prompt) - off)
        sl = np.zeros(5, np.int32)
        sl[:take] = prompt[off:off + take]
        _c, t_last, t_pos = tt.prefill_suffix(
            tp, torch.from_numpy(sl).long()[None], tcfg, tc, off,
            return_logits=True, true_len=take)
        jc, j_last, j_pos = jt.prefill_suffix(
            jp, jnp.asarray(sl)[None], jcfg, jc, jnp.int32(off),
            return_logits=True, true_len=jnp.int32(take))
        off += take
    assert int(t_pos) == int(f_pos) == int(j_pos) == len(prompt)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), rtol=1e-4,
                               atol=1e-4)
    n = len(prompt)
    for a, b in zip(pool_to_numpy(tc), pool_to_numpy(jc)):
        np.testing.assert_allclose(a[:, :, :n].astype(np.float32),
                                   b[:, :, :n].astype(np.float32),
                                   rtol=1e-4, atol=1e-4 if a.dtype != np.int8 else 1)
    if quantized:
        return
    np.testing.assert_allclose(t_last.numpy(), f_last.numpy(), rtol=1e-4, atol=1e-4)
    for a, b in zip(pool_to_numpy(tc), pool_to_numpy(full)):
        np.testing.assert_allclose(a[:, :, :n].astype(np.float32),
                                   b[:, :, :n].astype(np.float32),
                                   rtol=1e-4, atol=1e-4)


def test_prefill_suffix_takes_the_plain_attention(models, monkeypatch):
    """The span reads the cache back, so it never reaches the flash
    dispatch (the JAX rule: no flash kernel once q_offset is set)."""
    from kata_xpu_device_plugin_tpu_torch.ops import attention

    _, _, tp, tcfg = models
    assert not attention.flash_eligible(128, 2048, 128, q_offset=0, on_cuda=True)
    monkeypatch.setattr(attention, "flash_attention", lambda *a, **k: 1 / 0)
    tc = tt.init_kv_caches(tcfg, 1, 16, device="cpu")
    tt.prefill_suffix(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, tc, 3)


# ----- the slo_chunked server against the JAX server -------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_slo_chunked_server_matches_jax(models, layout, overlap, fused):
    (want, jst), (got, tst) = _both(models, overlap=overlap, fused=fused,
                                    **SLO, **LAYOUTS[layout])
    _same(got, want)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert tst["sched_chunks"] > 0 and tst["sched_defers"] > 0
    assert (tst["fused_admissions"] > 0) == fused
    if layout == "paged":
        assert tst["kv_blocks_in_use"] == 0


def test_slo_chunked_tokens_equal_fifo_and_default_slo(models):
    """Scheduling is invisible in the output: chunked, fused and the
    default deadline all give the fifo_batch server's tokens (and the
    JAX server's counters at the default deadline, where the estimates
    alone decide)."""
    _, _, tp, tcfg = models
    base, _ = _serve(GenerationServer(tp, tcfg, device="cpu", **KW))
    for kw in (SLO, dict(sched_policy="slo_chunked")):
        got, st = _serve(GenerationServer(tp, tcfg, device="cpu", **KW, **kw))
        _same(got, base)
        assert st["sched_queue_delay_s"]["count"] == len(LENS)


def test_chunked_drain_finishes_started_work(models):
    """A drain requested while an admission is chunked finishes it (it is
    started work) and fails only what never started."""
    _, _, tp, tcfg = models
    srv = GenerationServer(tp, tcfg, device="cpu", **KW, **SLO, overlap=False)
    rids = [srv.submit(p, b) for p, b in zip(_prompts(tcfg.vocab_size), BUDGETS)]
    while srv._partial is None:
        assert srv.step()
    started = srv._partial.req.rid
    out = srv.drain("test")
    assert started in out
    assert set(out) | set(srv.failures()) == set(rids)
    assert srv._partial is None and srv.stats()["draining"]


# ----- knob rules -------------------------------------------------------------


def test_env_knobs_select_the_policy(models, monkeypatch):
    _, _, tp, tcfg = models
    monkeypatch.setenv("KATA_TPU_SCHED_POLICY", "slo_chunked")
    monkeypatch.setenv("KATA_TPU_PREFILL_CHUNK", "6")
    monkeypatch.setenv("KATA_TPU_ITL_SLO_MS", "7.5")
    st = GenerationServer(tp, tcfg, device="cpu", **KW).stats()
    assert (st["sched_policy"], st["prefill_chunk_tokens"], st["itl_slo_ms"],
            st["fused_enabled"]) == ("slo_chunked", 6, 7.5, 1)
    monkeypatch.setenv("KATA_TPU_FUSED", "0")
    assert GenerationServer(tp, tcfg, device="cpu", **KW).stats()["fused_enabled"] == 0


@pytest.mark.parametrize("env", [
    dict(KATA_TPU_SCHED_POLICY="round_robin"),
    dict(KATA_TPU_SCHED_POLICY="slo_chunked", KATA_TPU_PREFILL_CHUNK="128k",
         KATA_TPU_ITL_SLO_MS="fast", KATA_TPU_FUSED="maybe"),
    dict(KATA_TPU_SCHED_POLICY="slo_chunked", KATA_TPU_PREFILL_CHUNK="-5"),
    dict(KATA_TPU_FUSED="1"),
], ids=["policy", "malformed", "below_one", "fused_without_slo"])
def test_env_knobs_degrade_like_jax(models, monkeypatch, env):
    jcfg, jp, tp, tcfg = models
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    keys = ("sched_policy", "prefill_chunk_tokens", "itl_slo_ms", "fused_enabled")
    want = JaxServer(jp, jcfg, **KW).stats()
    got = GenerationServer(tp, tcfg, device="cpu", **KW).stats()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("kw,match", [
    (dict(sched_policy="round_robin"), "sched_policy"),
    (dict(sched_policy="slo_chunked", prefill_chunk=0), "prefill_chunk"),
    (dict(prefill_chunk=0), "prefill_chunk"),
    (dict(fused=True), "slo_chunked"),
], ids=["policy", "chunk", "chunk_without_slo", "fused_without_slo"])
def test_explicit_bad_knobs_raise(models, monkeypatch, kw, match):
    _, _, tp, tcfg = models
    monkeypatch.setenv("KATA_TPU_SCHED_POLICY", "slo_chunked")
    if "fused" in kw:
        monkeypatch.delenv("KATA_TPU_SCHED_POLICY")
    with pytest.raises(ValueError, match=match):
        GenerationServer(tp, tcfg, device="cpu", **KW, **kw)
