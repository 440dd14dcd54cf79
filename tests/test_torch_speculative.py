"""PyTorch port, speculative decoding against the JAX package (fp32, the
CPU): ``generate_speculative`` greedy at k = 1 and 3 with n-gram drafts, a
self draft and the target as its own draft, on a tiny decoder and on
Gemma-2's softcap and window cycle, equal to the port's greedy
``generate`` and to JAX's ``generate_speculative``; the speculative server
(n-gram, draft model, perfect draft, ring x speculation, the cycle arena x
speculation x a draft, eos and budgets) against the JAX server's tokens
and ``stats()``; the JAX server's refusals and degrade events with their
reasons; speculative sampling (the rejection scheme on the device and on
the host) against the target distribution, with a bound derived from the
number of draws, and seeded determinism. Greedy tokens and counters must
be equal."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu import obs as jobs
from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import speculative as js
from kata_xpu_device_plugin_tpu_torch import obs as tobs
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import speculative as ts
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, FAMILIES, numpy_pair

LENGTHS = (4, 9, 6, 12)
BUDGETS = (9, 7, 11, 9)
STATS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
         "tokens_per_round", "draft_acceptance", "arena_bytes",
         "decode_backend_reason", "kv_slot_utilization")


@pytest.fixture(scope="module")
def models():
    """``{name: (jcfg, jax params, port params, port cfg)}``: a tiny
    decoder, Mistral (window 8) and Gemma-2 (cycle (6, 0), softcaps), each
    drawn by numpy (:func:`numpy_pair`)."""
    out = {}
    for i, (name, make) in enumerate((("tiny", CONFIGS["tiny"]),
                                      ("mistral", FAMILIES["mistral"]),
                                      ("gemma2", FAMILIES["gemma2"]))):
        jcfg = make()
        out[name] = (jcfg,) + numpy_pair(jcfg, 40 + i)
    return out


def _prompts(vocab, seed=9):
    """Ragged prompts; the last repeats a 3-token pattern, so n-gram
    drafts land there."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS[:-1]]
    return out + [np.tile(np.array([5, 17, 3], np.int32), 4)]


def _drafts(models, name: str, which):
    """Both packages' drafts: None (n-gram), ``"self"`` (the first window
    cycle of layers) or ``"target"`` (the target as its own draft)."""
    jcfg, jp, tp, tcfg = models[name]
    if which == "self":
        n = len(jcfg.window_cycle)
        return js.self_draft(jp, jcfg, n), ts.self_draft(tp, tcfg, n)
    if which == "target":
        return (jp, jcfg), (tp, tcfg)
    return None, None


# (model, k, draft, against JAX's generate_speculative too): every case
# against the port's greedy generate (itself held to JAX's by
# test_torch_model.py); two, one a window cycle with a self draft, against
# JAX's speculative run, whose compiles dominate this file's time.
GEN_CASES = [("tiny", 1, None, False), ("tiny", 3, None, True),
             ("tiny", 1, "self", False), ("tiny", 3, "self", False),
             ("tiny", 3, "target", False), ("gemma2", 3, None, False),
             ("gemma2", 2, "self", True)]


@pytest.mark.parametrize("name,k,draft,vs_jax", GEN_CASES,
                         ids=[f"{n}-k{k}-{d or 'ngram'}" for n, k, d, _ in GEN_CASES])
def test_generate_speculative_is_greedy_and_jax(models, name, k, draft, vs_jax):
    """Lossless: the tokens of greedy ``generate``, whatever the drafts,
    and JAX's ``generate_speculative``'s. One row repeats (drafts land),
    one is random (they mostly do not): rows advance at their own rates."""
    jcfg, jp, tp, tcfg = models[name]
    rng = np.random.default_rng(1)
    prompt = np.stack([np.tile(np.array([3, 19, 7], np.int32), 3),
                       rng.integers(0, jcfg.vocab_size, 9).astype(np.int32)])
    jd, td = _drafts(models, name, draft)
    got = ts.generate_speculative(tp, prompt, tcfg, 14, k=k, max_len=40,
                                  draft=td, device="cpu")
    greedy = tt.generate(tp, prompt, tcfg, 14, max_len=40, device="cpu").numpy()
    np.testing.assert_array_equal(got, greedy)
    if vs_jax:
        want = js.generate_speculative(jp, jnp.asarray(prompt), jcfg, 14, k=k,
                                       max_len=40, draft=jd)
        np.testing.assert_array_equal(got, want)


def test_generate_speculative_validation_and_rounds(models, monkeypatch):
    """JAX's refusals (``k < 1``, too little headroom, a draft of another
    vocabulary, ``self_draft`` depths), and a repetitive prompt finishes in
    fewer verify rounds than tokens."""
    from dataclasses import replace

    _jcfg, _jp, tp, tcfg = models["tiny"]
    z = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="k must be"):
        ts.generate_speculative(tp, z, tcfg, 4, k=0, device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        ts.generate_speculative(tp, z, tcfg, 8, k=4, max_len=12, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ts.generate_speculative(tp, z, tcfg, 4, k=2, device="cpu", draft=(
            tp, replace(tcfg, vocab_size=tcfg.vocab_size + 1)))
    for n in (0, tcfg.n_layers):
        with pytest.raises(ValueError, match="depth"):
            ts.self_draft(tp, tcfg, n)
    _g, _gp, gtp, gcfg = models["gemma2"]
    with pytest.raises(ValueError, match="cycle"):
        ts.self_draft(gtp, gcfg, 1)
    dp, dc = ts.self_draft(tp, tcfg, 1)
    assert dc.n_layers == 1 and dp["layers"]["wq"].shape[0] == 1
    calls = {"n": 0}
    real = ts.verify_step

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ts, "verify_step", counting)
    prompt = np.tile(np.array([11, 23, 5, 17], np.int32), 6)[None]
    out = ts.generate_speculative(tp, prompt, tcfg, 16, k=4, max_len=64,
                                  device="cpu")
    np.testing.assert_array_equal(
        out, tt.generate(tp, prompt, tcfg, 16, max_len=64, device="cpu").numpy())
    assert calls["n"] < 16


def test_speculative_sampling_is_seeded(models):
    """Sampled speculative generation repeats under one seed and moves
    with the seed, with draft-model and n-gram proposals."""
    _jcfg, _jp, tp, tcfg = models["tiny"]
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 8))
    draft = ts.self_draft(tp, tcfg, 1)
    kw = dict(steps=12, k=3, max_len=40, temperature=0.8, device="cpu")
    a = ts.generate_speculative(tp, prompt, tcfg, draft=draft, seed=5, **kw)
    b = ts.generate_speculative(tp, prompt, tcfg, draft=draft, seed=5, **kw)
    c = ts.generate_speculative(tp, prompt, tcfg, draft=draft, seed=6, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    d = ts.generate_speculative(tp, prompt, tcfg, seed=5, **kw)
    assert d.shape == (2, 12) and ((d >= 0) & (d < tcfg.vocab_size)).all()


# ----- the rejection scheme against the target distribution ---------------

P = np.array([[.4, .3, .1, .1, .05, .05],
              [.1, .1, .5, .1, .1, .1],
              [.2, .2, .2, .2, .1, .1]])
Q = np.array([[.3, .3, .2, .1, .05, .05],
              [.25, .25, .1, .2, .1, .1]])
N = 20000


def _within_draw_bound(counts: np.ndarray, p: np.ndarray, n: int) -> None:
    """Each bin's frequency within 4.5 standard deviations of a binomial
    of ``n`` draws at its target probability: a bin leaves it by chance
    with probability below 1e-5, so a failure is a wrong distribution."""
    sigma = np.sqrt(p * (1 - p) / n)
    err = np.abs(counts / n - p)
    assert (err <= 4.5 * sigma).all(), (err, 4.5 * sigma)


def test_sample_accept_device_matches_target_distribution():
    """The on-device scheme the server runs: over ``N`` rows of one (p, q),
    drafts drawn from q, the first emitted token is distributed as p[0];
    counts lie in [1, k+1]. Then a perfect proposal (q = p) accepts every
    draft and emits k+1 tokens."""
    k, V = 2, P.shape[1]
    gen = torch.Generator().manual_seed(0)
    q = torch.tensor(Q, dtype=torch.float32)
    drafts = torch.stack([torch.multinomial(q[i], N, replacement=True,
                                            generator=gen) for i in range(k)],
                         dim=1).to(torch.int32)
    logits = torch.log(torch.tensor(P, dtype=torch.float32))[None].expand(N, -1, -1)
    toks, counts = ts.sample_accept_device(
        drafts, q[None].expand(N, -1, -1), logits, 1.0, gen, k)
    _within_draw_bound(np.bincount(toks[:, 0].numpy(), minlength=V), P[0], N)
    assert ((counts >= 1) & (counts <= k + 1)).all()
    same = torch.log(torch.tensor(P[:k + 1], dtype=torch.float32))
    pq = torch.softmax(same, -1)[:k]
    d2 = torch.stack([torch.multinomial(pq[i], 200, replacement=True,
                                        generator=gen) for i in range(k)],
                     dim=1).to(torch.int32)
    toks2, counts2 = ts.sample_accept_device(
        d2, pq[None].expand(200, -1, -1), same[None].expand(200, -1, -1), 1.0,
        gen, k)
    assert (counts2 == k + 1).all()
    assert torch.equal(toks2[:, :k], d2)


def test_sample_accept_row_matches_target_distribution():
    """The host scheme (JAX's numpy copy): the first token of ``N`` rounds
    is distributed as p[0]; a perfect proposal accepts all k drafts."""
    rng = np.random.default_rng(0)
    k, V = 2, P.shape[1]
    counts = np.zeros(V)
    for _ in range(N):
        drafts = np.array([rng.choice(V, p=Q[i]) for i in range(k)])
        counts[ts.sample_accept_row(drafts, Q, P, rng)[0]] += 1
    _within_draw_bound(counts, P[0], N)
    p3 = np.tile(np.array([.3, .3, .2, .1, .1]), (4, 1))
    for _ in range(200):
        drafts = np.array([rng.choice(5, p=p3[i]) for i in range(3)])
        out = ts.sample_accept_row(drafts, p3[:3], p3, rng)
        assert len(out) == 4 and out[:3] == list(drafts)


def test_ngram_propose_and_accept_match_jax():
    hist = np.array([5, 9, 7, 3, 9, 8, 2], np.int32)
    for cur, k in ((9, 4), (6, 3), (2, 2), (5, 5)):
        np.testing.assert_array_equal(ts.ngram_propose(hist, cur, k),
                                      js.ngram_propose(hist, cur, k))
    d, g = np.array([4, 5, 6]), np.array([4, 5, 7, 8])
    assert ts.accept_drafts(d, g, 3) == js.accept_drafts(d, g, 3) == [4, 5, 7]


# ----- the speculative server ---------------------------------------------

SERVER_CASES = {
    # name: (model, server kwargs, against the JAX server too); "draft"
    # names a draft of _drafts. Every case is held to the port's plain
    # greedy server; the JAX server's runs (their compiles are this file's
    # cost) cover n-gram with and without eos, a self draft (it rejects
    # drafts, so its acceptance and rounds test the draft arena), a ring,
    # and a perfect draft on the cycle arena.
    "ngram": ("tiny", dict(speculative_k=3), True),
    "ngram-eos": ("tiny", dict(speculative_k=3, eos_id="mid"), True),
    "draft-self": ("tiny", dict(speculative_k=3, draft="self"), True),
    "draft-perfect": ("tiny", dict(speculative_k=3, draft="target"), False),
    "ring-ngram": ("mistral", dict(speculative_k=3, ring_kv=True), True),
    "cycle-draft-perfect": ("gemma2", dict(speculative_k=2, ring_kv=True,
                                           draft="target", kv_quant=True), True),
}
# One prefill bucket: each JAX server compiles one admission prefill.
BASE = dict(max_batch=2, max_len=48, prefill_buckets=(16,),
            spec_opt_in=True)


def _serve(srv, prompts, budgets=BUDGETS):
    rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    res = srv.run()
    return [np.asarray(res[r]) for r in rids], srv.stats()


@pytest.fixture(scope="module")
def served(models):
    """``{case: (jax tokens, jax stats, port tokens, port stats, port
    plain-server tokens)}`` (the JAX pair None where a case has no JAX
    run), each server run once; ``eos_id="mid"`` is a token the plain
    server emits mid-stream."""
    out, plain = {}, {}
    for case, (name, kw, vs_jax) in SERVER_CASES.items():
        jcfg, jp, tp, tcfg = models[name]
        prompts = _prompts(jcfg.vocab_size)
        kq = kw.get("kv_quant", False)
        if (name, kq) not in plain:
            plain[name, kq] = _serve(GenerationServer(
                tp, tcfg, device="cpu", chunk=4, kv_quant=kq,
                **{k: v for k, v in BASE.items() if k != "spec_opt_in"}),
                prompts)[0]
        ref = plain[name, kq]
        kw = dict(BASE, **{**kw, "kv_quant": kq})
        if kw.get("eos_id") == "mid":
            kw["eos_id"] = int(ref[1][3])
        jd, td = _drafts(models, name, kw.pop("draft", None))
        want = (_serve(JaxServer(jp, jcfg, draft=jd, **kw), prompts) if vs_jax
                else (None, None))
        got = _serve(GenerationServer(tp, tcfg, draft=td, device="cpu", **kw),
                     prompts)
        if "eos_id" in kw:
            ref = [r[: list(r).index(kw["eos_id"]) + 1]
                   if kw["eos_id"] in r else r for r in ref]
        out[case] = want + got + (ref,)
    return out


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_speculative_server_matches_jax_server(served, case):
    """Tokens equal to the port's plain greedy server's (eos and budgets
    trimmed alike) and, where the case runs it, to the JAX server's, with
    the counters equal to JAX's, ``draft_acceptance`` among them; the
    self draft accepts some drafts and rejects others; a perfect draft
    accepts every draft."""
    jtok, jst, ttok, tst, ref = served[case]
    for g, r in zip(ttok, ref):
        np.testing.assert_array_equal(g, r)
    if jtok is not None:
        for w, g in zip(jtok, ttok):
            np.testing.assert_array_equal(g, w)
        for key in STATS:
            assert tst[key] == jst[key], (key, jst[key], tst[key])
    assert tst["decode_backend"] == "reference"
    assert tst["decode_backend_reason"] == (
        "ring_kv" if "ring" in case or "cycle" in case else "speculative")
    assert 0.0 <= tst["draft_acceptance"] <= 1.0
    if case == "draft-self":
        assert 0.0 < tst["draft_acceptance"] < 1.0
    if "perfect" in case:
        assert tst["draft_acceptance"] == 1.0
        assert tst["rounds"] < tst["tokens_emitted"] - tst["prefills"]


def test_perfect_draft_rounds(models):
    """Target as draft, one lane: every round accepts k+1 tokens, so 11
    decode tokens take ceil(11 / 4) = 3 rounds (JAX's count)."""
    _jcfg, _jp, tp, tcfg = models["tiny"]
    (p,) = _prompts(tcfg.vocab_size, seed=12)[:1]
    srv = GenerationServer(tp, tcfg, max_batch=1, max_len=40, speculative_k=3,
                           draft=(tp, tcfg), spec_opt_in=True, device="cpu")
    rid = srv.submit(p, 12)
    out = srv.run()[rid]
    np.testing.assert_array_equal(
        out, tt.generate(tp, p[None], tcfg, 12, max_len=40, device="cpu")[0])
    st = srv.stats()
    assert st["draft_acceptance"] == 1.0 and st["rounds"] == 3


def test_sampled_speculative_server_is_seeded(models):
    """A sampling speculative server (n-gram and draft-model proposals):
    one seed gives the same tokens twice, another seed others."""
    _jcfg, _jp, tp, tcfg = models["tiny"]
    prompts = _prompts(tcfg.vocab_size)
    runs = {}
    for draft in (None, ts.self_draft(tp, tcfg, 1)):
        for seed in (3, 3, 4):
            srv = GenerationServer(tp, tcfg, temperature=0.8, seed=seed,
                                   speculative_k=3, draft=draft, device="cpu",
                                   **BASE)
            runs.setdefault(draft is None, []).append(_serve(srv, prompts)[0])
    for a, b, c in runs.values():
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert any(not np.array_equal(x, z) for x, z in zip(a, c))


def _events(pkg, path, make):
    sink = pkg.EventSink(path)
    prev = pkg.set_default_sink(sink)
    try:
        make()
    finally:
        pkg.set_default_sink(prev)
        sink.close()
    return [(e["name"], e.get("reason")) for e in pkg.read_events(path)
            if e["name"].endswith(("_disabled", "_invalid"))]


DEGRADE_ENVS = {
    "spec_disabled": ({"KATA_TPU_SPEC": "0"}, {}),
    "kv_pool_disabled": ({"KATA_TPU_KV_POOL_TOKENS": "256"}, {}),
    "sched_disabled": ({"KATA_TPU_SCHED_POLICY": "slo_chunked"}, {}),
    "decode_steps_invalid": ({"KATA_TPU_DECODE_STEPS": "2"}, {}),
    "persistent_disabled": ({"KATA_TPU_PERSISTENT": "1"}, {}),
    "checkpoint_disabled": ({"KATA_TPU_CHECKPOINT_ROUNDS": "2"}, {}),
    "prefix_store_disabled": ({"KATA_TPU_PREFIX_CACHE_TOKENS": "64"},
                              {"draft": "self"}),
}


@pytest.mark.parametrize("event", sorted(DEGRADE_ENVS))
def test_degrade_events_match_jax(models, event, monkeypatch, tmp_path):
    """An env knob a speculative server cannot take degrades with JAX's
    event and reason (the spec opt-in's ``spec_disabled`` when it is
    off), and the server builds."""
    jcfg, jp, tp, tcfg = models["tiny"]
    env, extra = DEGRADE_ENVS[event]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jd, td = _drafts(models, "tiny", extra.get("draft"))
    kw = dict(max_batch=2, max_len=48, speculative_k=3, prefill_buckets=(16,))
    want = _events(jobs, str(tmp_path / "j.jsonl"),
                   lambda: JaxServer(jp, jcfg, draft=jd, **kw))
    got = _events(tobs, str(tmp_path / "t.jsonl"),
                  lambda: GenerationServer(tp, tcfg, draft=td, device="cpu",
                                           **kw))
    assert sorted(got) == sorted(want)
    assert event in {n for n, _r in got}


def test_speculative_server_refusals(models):
    """The JAX server's ``ValueError``s: a negative k, a draft without k, a
    draft of another vocabulary, top-k/top-p with k; and explicit knobs a
    speculative server cannot take."""
    from dataclasses import replace

    _jcfg, _jp, tp, tcfg = models["tiny"]
    kw = dict(device="cpu", max_batch=2, max_len=48)
    for bad, match in ((dict(speculative_k=-1), "speculative_k must be"),
                       (dict(draft=(tp, tcfg)), "requires speculative_k"),
                       (dict(speculative_k=2, draft=(tp, replace(
                           tcfg, vocab_size=tcfg.vocab_size + 1))), "vocab"),
                       (dict(speculative_k=2, temperature=0.7, top_p=0.9),
                        "top_k/top_p"),
                       (dict(speculative_k=2, kv_pool_tokens=256),
                        r"kv_pool_tokens=256.*\(speculative\)"),
                       (dict(speculative_k=2, sched_policy="slo_chunked"),
                        r"\(speculative\)"),
                       (dict(speculative_k=2, decode_steps=2),
                        r"decode_steps=2.*\(speculative\)"),
                       (dict(speculative_k=2, persistent=True),
                        r"persistent=True.*\(speculative\)"),
                       (dict(speculative_k=2, checkpoint_rounds=2),
                        "checkpoint_rounds=2 is incompatible"),
                       (dict(speculative_k=2, tp=2), r"tp=2.*\(speculative\)")):
        with pytest.raises(ValueError, match=match):
            GenerationServer(tp, tcfg, spec_opt_in=True, **kw, **bad)
    GenerationServer(tp, tcfg, temperature=0.7, speculative_k=3,
                     spec_opt_in=True, **kw)
