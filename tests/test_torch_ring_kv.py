"""PyTorch port, ring and cycle KV arenas against the JAX package (fp32 and
int8 caches on both sides, the CPU): ``ring_positions``, the ring and cycle
folds and ``init_cycle_kv_caches`` bit for bit on a tiny Mistral (window
8), Gemma-2 (cycle (6, 0)) and Gemma-3 (cycle (8, 8, 0)); ``generate(...,
ring_kv=True)`` and ``decode(..., ring=True, return_state=True)`` against
JAX's and the port's full arena over streams that wrap the ring more than
twice; the ``ring_kv`` server (bf16 and int8, plain and cycle arena)
against the JAX server's tokens and ``stats()``, and a ring server under a
fault schedule against the JAX server under the same schedule. Logits
and caches that both packages compute are held to the transformer parity
tolerance of ``test_torch_model.py`` (``atol=rtol=1e-4``); folds, which
only move rows, and greedy tokens must be equal."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

from .torch_faults import CHAOS, assert_same, clean_port, serve_both
from .torch_parity import FAMILIES, numpy_pair

TOL = dict(atol=1e-4, rtol=1e-4)
FAMS = ("mistral", "gemma2", "gemma3")
# One prefill bucket: each JAX server compiles one admission prefill.
SERVE = dict(max_batch=2, max_len=48, chunk=4, prefill_buckets=(16,))
LENGTHS = (5, 11, 3, 8)
BUDGETS = (17, 9, 21, 13)


@pytest.fixture(scope="module")
def models():
    """``{family: (jcfg, jax params, port params, port cfg)}`` for the
    families the forwards run (numpy draws, :func:`numpy_pair`); the
    folds need only the configs (:func:`_cfgs`)."""
    out = {}
    for i, name in enumerate(("mistral", "gemma2")):
        jcfg = FAMILIES[name]()
        out[name] = (jcfg,) + numpy_pair(jcfg, 30 + i)
    return out


def _cfgs(fam: str):
    jcfg = FAMILIES[fam]()
    return jcfg, bridge.config_from_fields(dataclasses.asdict(jcfg))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _leaves(tree) -> list:
    """A cache tree's arrays (either package), QTensor payloads and scales
    alike, as numpy."""
    if isinstance(tree, (tquant.QTensor, jquant.QTensor)):
        return [_to_numpy(t) for t in tree]
    if isinstance(tree, tuple):
        return [x for c in tree for x in _leaves(c)]
    return [_to_numpy(tree)]


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _random_caches(cfg, kind: str, S: int = 16, B: int = 2, seed: int = 0):
    """One prefill's cache pair ``[L, B, S, KV, D]`` for both packages from
    one numpy draw: fp32, bf16 (the same bits), or int8 payloads with fp32
    scales."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)

    def one():
        if kind == "int8":
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = rng.random(shape[:-1] + (1,)).astype(np.float32)
            return (jquant.QTensor(jnp.asarray(q), jnp.asarray(s)),
                    tquant.QTensor(torch.from_numpy(q), torch.from_numpy(s)))
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "bf16":
            j = jnp.asarray(x, jnp.bfloat16)
            return j, torch.from_numpy(np.array(j).view(np.int16)).view(
                torch.bfloat16)
        return jnp.asarray(x), torch.from_numpy(x)

    (jk, tk), (jv, tv) = one(), one()
    return (jk, jv), (tk, tv)


def _assert_bits(got, want) -> None:
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("window", [4, 8, 11])
def test_ring_positions_match_jax(window):
    for pos in (0, 1, 3, 9, 23):
        want = np.asarray(jt.ring_positions(jnp.int32(pos), window))
        got = tt.ring_positions(torch.tensor(pos), window).numpy()
        np.testing.assert_array_equal(got, want)
    col = np.array([[0], [5], [17]], np.int32)
    np.testing.assert_array_equal(
        tt.ring_positions(torch.from_numpy(col).long(), window).numpy(),
        np.asarray(jt.ring_positions(jnp.asarray(col), window)))
    # The JAX docstring's case: 10 positions in a 4-slot ring.
    if window == 4:
        assert tt.ring_positions(torch.tensor(9), 4).tolist() == [8, 9, 6, 7]


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("fam", FAMS)
def test_folds_are_jax_bit_for_bit(fam, kind):
    """The ring fold at the first window (a prompt past the window with a
    margin, a short one without), the cycle fold (Gemma-2, Gemma-3) and a
    fresh cycle arena: the same shapes, dtypes and bits as JAX's;
    unwritten slots of a short prompt zero, payload and scale."""
    jcfg, tcfg = _cfgs(fam)
    jc, tc = _random_caches(jcfg, kind)
    w0 = jcfg.window_cycle[0]
    for pos, margin in ((13, 3), (3, 0)):
        _assert_bits(tt.ring_caches_from_prefill(tc, pos, w0 + margin),
                     jt.ring_caches_from_prefill(jc, jnp.int32(pos),
                                                 w0 + margin))
    short = tt.ring_caches_from_prefill(tc, 2, w0)
    for leaf in _leaves(short):
        assert not leaf[:, :, 2:].any()
    if len(jcfg.window_cycle) > 1:
        for pos, margin in ((11, 0), (5, 2)):
            _assert_bits(
                tt.cycle_ring_caches_from_prefill(tc, pos, tcfg, 32, margin),
                jt.cycle_ring_caches_from_prefill(jc, jnp.int32(pos), jcfg, 32,
                                                  margin))
    quant = kind == "int8"
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}.get(kind)
    got = tt.init_cycle_kv_caches(tcfg, 2, 32, device="cpu", dtype=dtype,
                                  quantized=quant, margin=3)
    want = jt.init_cycle_kv_caches(
        jcfg, 2, 32, dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}.get(kind),
        quantized=quant, margin=3)
    _assert_bits(got, want)


GEN_CASES = [("mistral", False), ("gemma2", True)]


@pytest.mark.parametrize("fam,quantized", GEN_CASES,
                         ids=[f"{f}-{'int8' if q else 'fp32'}" for f, q in GEN_CASES])
def test_generate_ring_matches_jax_and_full_arena(models, fam, quantized):
    """A 5-token prompt and 24 steps: the ring (Mistral's window 8; the
    cycle arena's window 6) wraps more than twice. Tokens equal JAX's ring generate and the port's
    full-arena generate."""
    jcfg, jp, tp, tcfg = models[fam]
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    want = np.asarray(jt.generate(jp, jnp.asarray(prompt), jcfg, 24, max_len=40,
                                  ring_kv=True, kv_quantized=quantized))
    got = tt.generate(tp, prompt, tcfg, 24, max_len=40, ring_kv=True,
                      kv_quantized=quantized, device="cpu").numpy()
    full = tt.generate(tp, prompt, tcfg, 24, max_len=40,
                       kv_quantized=quantized, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)


def test_generate_ring_validation(models):
    from dataclasses import replace

    _jcfg, _jp, tp, tcfg = models["mistral"]
    with pytest.raises(ValueError, match="sliding-window"):
        tt.generate(tp, np.zeros((1, 4), np.int32),
                    replace(tcfg, sliding_window=0), 4, ring_kv=True,
                    device="cpu")
    # A ring wraps: no max_len bound for a uniform window.
    out = tt.generate(tp, np.ones((1, 4), np.int32), tcfg, 30, max_len=8,
                      ring_kv=True, device="cpu")
    assert out.shape == (1, 30)


@pytest.mark.parametrize("fam", ["gemma2"])
def test_decode_ring_return_state_matches_jax(models, fam):
    """``decode(..., ring=True, return_state=True)`` over the folded
    prefill (Gemma-2's cycle arena: a ring and a global arena), 12 steps,
    then 8 more from the returned state: the 20 tokens, the last token and
    the positions equal to one JAX call of 20 steps, the caches within the
    parity tolerance."""
    jcfg, jp, tp, tcfg = models[fam]
    prompt = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jc, jlast, jpos = jt.prefill(jp, jnp.asarray(prompt), jcfg, 7)
    tc, tlast, tpos = tt.prefill(tp, torch.from_numpy(prompt).long(), tcfg, 7)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    if len(jcfg.window_cycle) > 1:
        jc = jt.cycle_ring_caches_from_prefill(jc, jpos, jcfg, 40)
        tc = tt.cycle_ring_caches_from_prefill(tc, tpos, tcfg, 40)
    else:
        jc = jt.ring_caches_from_prefill(jc, jpos, jcfg.sliding_window)
        tc = tt.ring_caches_from_prefill(tc, tpos, tcfg.sliding_window)
    pos = np.full(2, int(jpos), np.int32)
    jout = jt.decode(jp, jc, jlast, jnp.asarray(pos), jcfg, 20,
                     return_state=True, ring=True)
    first = tt.decode(tp, tc, tlast, torch.from_numpy(pos), tcfg, 12,
                      return_state=True, ring=True)
    tout = tt.decode(tp, *first[1:], tcfg, 8, return_state=True, ring=True)
    np.testing.assert_array_equal(
        torch.cat([first[0], tout[0]], dim=1).numpy(), np.asarray(jout[0]))
    for i in (2, 3):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    for a, b in zip(_leaves(tout[1]), _leaves(jout[1])):
        np.testing.assert_allclose(a, b, **TOL)


def test_ring_layer_refuses_an_undersized_ring(models):
    """A verify span of S rows over a ring of fewer than ``window + S - 1``
    slots would evict keys a live window still sees: JAX's guard, its
    text."""
    _jcfg, _jp, tp, tcfg = models["mistral"]
    caches = tt.init_kv_caches(tcfg, 1, tcfg.sliding_window, device="cpu",
                               dtype=torch.float32)
    toks = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="undersized ring would evict"):
        tt.forward(tp, toks, tcfg, positions=torch.arange(3)[None],
                   kv_caches=caches, cache_offset=torch.zeros(1, dtype=torch.int32),
                   ring=True)
    with pytest.raises(ValueError, match="single-token"):
        big = tt.init_kv_caches(tcfg, 1, 16, device="cpu", dtype=torch.float32)
        tt.forward(tp, toks, tcfg, positions=torch.arange(3)[None],
                   kv_caches=big, cache_offset=0, ring=True)


# ----- the ring_kv server -------------------------------------------------


def _prompts(vocab, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(srv, prompts):
    rids = [srv.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    res = srv.run()
    return [np.asarray(res[r]) for r in rids], srv.stats()


# stats() keys both servers must agree on.
STATS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
         "tokens_per_round", "arena_bytes", "decode_backend_reason",
         "kv_slot_utilization", "slots_busy", "queued", "batch_occupancy")

SERVER_CASES = {
    "mistral-bf16": ("mistral", dict(kv_quant=False)),
    "gemma2-cycle-int8": ("gemma2", dict(kv_quant=True)),
}


@pytest.fixture(scope="module")
def served(models):
    """``{case: (jax tokens, jax stats, port tokens, port stats, port
    server, port full-arena tokens and stats)}``, each server run once."""
    out = {}
    for case, (fam, kw) in SERVER_CASES.items():
        jcfg, jp, tp, tcfg = models[fam]
        prompts = _prompts(jcfg.vocab_size)
        jtok, jst = _serve(JaxServer(jp, jcfg, ring_kv=True, **SERVE, **kw),
                           prompts)
        srv = GenerationServer(tp, tcfg, ring_kv=True, device="cpu", **SERVE,
                               **kw)
        ttok, tst = _serve(srv, prompts)
        full = _serve(GenerationServer(tp, tcfg, device="cpu", **SERVE, **kw),
                      prompts)
        out[case] = (jtok, jst, ttok, tst, srv, full)
    return out


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_ring_server_matches_jax_server(served, case):
    """Tokens and counters equal to the JAX ``ring_kv`` server's, and
    tokens equal to the port's full-arena server's; the arena holds the
    window (the cycle arena: rings for local layers, ``max_len`` for the
    global ones) and is smaller than the full arena."""
    jtok, jst, ttok, tst, srv, (full, full_st) = served[case]
    for w, g, f, b in zip(jtok, ttok, full, BUDGETS):
        assert len(g) == b
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)
    for key in STATS:
        assert tst[key] == jst[key], (key, jst[key], tst[key])
    assert tst["decode_backend"] == "reference"
    assert tst["decode_backend_reason"] == "ring_kv"
    cfg = srv.cfg
    if len(cfg.window_cycle) > 1:
        local, glob = srv.arena
        assert tquant.QTensor is type(local[0])
        assert local[0].q.shape[2] == cfg.window_cycle[0]
        assert glob[0].q.shape[2] == SERVE["max_len"]
    else:
        leaf = srv.arena[0]
        leaf = leaf.q if isinstance(leaf, tquant.QTensor) else leaf
        assert leaf.shape[2] == cfg.sliding_window
    # Slots a lane over the layers: a ring's window, a global layer's
    # max_len; the full arena max_len everywhere.
    slots = sum(cfg.layer_window(i) or SERVE["max_len"]
                for i in range(cfg.n_layers))
    assert tst["arena_bytes"] * SERVE["max_len"] * cfg.n_layers \
        == full_st["arena_bytes"] * slots


def test_ring_server_rules(models, monkeypatch):
    """The JAX server's refusals and degrades for ``ring_kv``: a config
    without a window raises; an explicit pool, ``slo_chunked``,
    ``decode_steps > 1``, ``persistent`` or ``tp > 1`` raises, the env
    value degrades with JAX's event and reason; the prefix cache falls
    back to cold admission."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch import obs as tobs

    _jcfg, _jp, tp, tcfg = models["mistral"]
    with pytest.raises(ValueError, match="sliding-window"):
        GenerationServer(tp, replace(tcfg, sliding_window=0), ring_kv=True,
                         device="cpu")
    for kw, what in ((dict(kv_pool_tokens=256), "kv_pool_tokens=256"),
                     (dict(sched_policy="slo_chunked"), "slo_chunked"),
                     (dict(decode_steps=2), "decode_steps=2"),
                     (dict(persistent=True), "persistent=True"),
                     (dict(tp=2), "tp=2")):
        with pytest.raises(ValueError, match=rf"{what}.*\(ring_kv\)"):
            GenerationServer(tp, tcfg, ring_kv=True, device="cpu", **SERVE, **kw)
    seen = []
    monkeypatch.setattr(tobs, "emit", lambda kind, name, **f: seen.append(
        (name, f.get("reason"))))
    for env, val in (("KATA_TPU_KV_POOL_TOKENS", "256"),
                     ("KATA_TPU_SCHED_POLICY", "slo_chunked"),
                     ("KATA_TPU_DECODE_STEPS", "2"),
                     ("KATA_TPU_PERSISTENT", "1"),
                     ("KATA_TPU_TP", "2"),
                     ("KATA_TPU_PREFIX_CACHE_TOKENS", "64")):
        monkeypatch.setenv(env, val)
    srv = GenerationServer(tp, tcfg, ring_kv=True, device="cpu", **SERVE)
    st = srv.stats()
    assert (st["sched_policy"], st["decode_steps"], st["persistent"],
            st["tp_degree"], st["kv_pool_tokens"]) == ("fifo_batch", 1, 0, 1, 0)
    assert srv.prefix_store is None
    assert sorted(e for e in seen if e[0].endswith(("_disabled", "_invalid"))) \
        == sorted([("kv_pool_disabled", "ring_kv"), ("sched_disabled", "ring_kv"),
                   ("decode_steps_invalid", "ring_kv"),
                   ("persistent_disabled", "ring_kv"), ("tp_disabled", "ring_kv"),
                   ("prefix_store_disabled", "ring_kv")])


@pytest.fixture(scope="module")
def mistral_models(models):
    return models["mistral"]


def test_ring_server_recovers_like_jax(mistral_models, tmp_path):
    """The JAX recovery tests' chaos schedule (a dispatch raise, a fence
    hang, an admission raise) on an overlapped ``ring_kv`` server with a
    checkpoint every 2 rounds: the same outcome as the JAX server (tokens,
    fired faults, counters, recovery and checkpoint events) and tokens
    equal to the port's fault-free ring run. The recovery zeroes the ring
    in place."""
    # The served mistral case's shapes: the JAX server reuses its compiles.
    kw = dict(ring_kv=True, checkpoint_rounds=2, overlap=True,
              max_len=SERVE["max_len"], prefill_buckets=SERVE["prefill_buckets"])
    got = assert_same(serve_both(mistral_models, tmp_path, schedule=CHAOS,
                                 seed=3, lengths=(4, 9, 6, 3), budgets=14,
                                 **kw))
    assert got["results"] == clean_port(mistral_models, lengths=(4, 9, 6, 3),
                                        budgets=14, **kw)
    assert got["stats"]["recoveries"] == 3 and got["failures"] == {}
