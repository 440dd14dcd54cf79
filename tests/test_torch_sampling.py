"""PyTorch port, sampling (``sample_token``, ``generate`` and the server with
``temperature``/``top_k``/``top_p``). The JAX package's oracles on
constructed distributions whose nucleus is known exactly; the draw's
frequencies against the exact masked softmax; determinism within the port
(one seed, the same tokens; another seed, other tokens). The one exact
check across the frameworks: ``top_k=1`` sampling equals the JAX package's
greedy tokens, in ``generate`` and in the server (threefry and PyTorch's
generators cannot be matched)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode
from kata_xpu_device_plugin_tpu_torch.guest.serving import (
    GenerationServer,
    serve_batch,
)
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.models.transformer import sample_token

from .torch_parity import CONFIGS, FAMILIES, build_pair

BUCKETS = (8, 16)
LENGTHS = (5, 7, 11, 16, 3)
BUDGETS = (6, 9, 4, 12, 7)
SERVE_KW = dict(max_len=48, prefill_buckets=BUCKETS, chunk=4, kv_quant=True)
LAYOUTS = {
    "slotted": dict(max_batch=2),
    "paged": dict(max_batch=3, kv_pool_tokens=64, kv_block_size=4),
}
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.9)
ALL_CONFIGS = {**CONFIGS, **FAMILIES}


def _dist_logits(probs):
    return torch.log(torch.tensor([probs], dtype=torch.float32))


def _draws(logits, n=200, seed=0, **kw):
    """The tokens of ``n`` draws from one row (one batched call)."""
    gen = torch.Generator().manual_seed(seed)
    return set(sample_token(logits.expand(n, -1), gen, 1.0, **kw).tolist())


def _jax_draws(probs, n=200, **kw):
    logits = jnp.log(jnp.asarray([probs], jnp.float32))
    return {int(jt.sample_token(logits, jax.random.PRNGKey(s), jnp.float32(1.0),
                                **kw)[0]) for s in range(n)}


def test_top_p_nucleus_membership():
    logits = _dist_logits([0.5, 0.3, 0.15, 0.05])
    # top_p=0.6: the mass before each token is [0, .5, .8, .95]: {0, 1}.
    assert _draws(logits, top_k=0, top_p=0.6) == {0, 1}
    # top_p=0.4: only the argmax survives (the nucleus is never empty).
    assert _draws(logits, top_k=0, top_p=0.4) == {0}
    # top_p=1.0: everything stays reachable.
    assert _draws(logits, top_k=0, top_p=1.0) == {0, 1, 2, 3}


def test_top_p_composes_with_top_k():
    logits = _dist_logits([0.4, 0.3, 0.2, 0.1])
    # top_k=3 drops token 3; top_p=0.75 of the renormalized {0, 1, 2}
    # (0.44, 0.33, 0.22) keeps the prefix {0, 1}.
    assert _draws(logits, top_k=3, top_p=0.75) == {0, 1}
    assert _draws(logits, top_k=2) == {0, 1}


def test_top_p_exact_prefix_under_ties():
    """Four tied tokens at top_p=0.3: exactly two survive (0.25, then
    0.5), and the same two as in the JAX package, whose descending order
    is a stable ascending sort flipped."""
    probs = [0.25, 0.25, 0.25, 0.25]
    got = _draws(_dist_logits(probs), top_k=0, top_p=0.3)
    assert len(got) == 2
    assert got == _jax_draws(probs, top_k=0, top_p=0.3)


def test_validation_messages_match_jax():
    cfg = tt.tiny_test_config(dtype=torch.float32)
    params = tt.init_params(cfg, seed=0, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="top_p must be"):
        tt.generate(params, prompt, cfg, 4, temperature=0.5, top_p=1.5,
                    generator=gen, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        tt.generate(params, prompt, cfg, 4, top_p=0.9, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        tt.generate(params, prompt, cfg, 4, top_k=3, device="cpu")
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        tt.generate(params, prompt, cfg, 4, temperature=0.5, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        GenerationServer(params, cfg, top_p=0.9, device="cpu")
    with pytest.raises(ValueError, match="top_p must be"):
        GenerationServer(params, cfg, temperature=0.5, top_p=1.5, device="cpu")


def _masked_softmax(logits, temperature, top_k, top_p):
    """The exact distribution sample_token draws from, in float64."""
    z = np.asarray(logits, np.float64) / temperature
    keep = np.ones_like(z, bool)
    if top_k:
        keep &= z >= np.sort(z)[-top_k]
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    if 0.0 < top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        before = np.cumsum(p[order]) - p[order]
        nucleus = np.zeros_like(keep)
        nucleus[order[before < top_p]] = True
        p = np.where(nucleus, p, 0.0)
        p /= p.sum()
    return p


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 0.0), (0.8, 8, 0.0), (1.3, 0, 0.85), (0.7, 9, 0.9)])
def test_frequencies_match_the_masked_softmax(temperature, top_k, top_p):
    """100000 draws at seed 0 (fixed, so the test cannot flake): every
    token's frequency within 5 standard errors of its exact probability
    plus 1/N, and never a filtered token."""
    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal(12).astype(np.float32) * 1.5)
    n = 100_000
    gen = torch.Generator().manual_seed(0)
    toks = sample_token(logits[None].expand(n, -1), gen,
                        torch.full((), temperature), top_k, top_p)
    freq = np.bincount(toks.numpy(), minlength=12) / n
    p = _masked_softmax(logits.numpy(), temperature, top_k, top_p)
    bound = 5.0 * np.sqrt(p * (1.0 - p) / n) + 1.0 / n
    assert np.all(np.abs(freq - p) <= bound), (freq, p)
    assert np.all(freq[p == 0.0] == 0.0)


def _prompt(cfg, shape=(2, 6), seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_generate_one_seed_same_tokens_another_seed_others():
    cfg = tt.tiny_test_config(dtype=torch.float32)
    params = tt.init_params(cfg, seed=0, device="cpu")

    def run(seed):
        return tt.generate(params, _prompt(cfg), cfg, 10, temperature=1.0,
                           top_p=0.95, generator=torch.Generator().manual_seed(seed),
                           device="cpu")

    a, b, c = run(3), run(3), run(4)
    assert a.shape == (2, 10) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def _prompts(cfg):
    rng = np.random.default_rng(22)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENGTHS]


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_server_one_seed_same_tokens_another_seed_others(layout, overlap):
    jcfg = CONFIGS["gemma_tiny"]()
    _, tp, tcfg = build_pair(jcfg, seed=21, fused=True)

    def run(seed):
        return serve_batch(tp, tcfg, _prompts(tcfg), max_new_tokens=10,
                           device="cpu", seed=seed, overlap=overlap,
                           **SAMPLED, **LAYOUTS[layout], **SERVE_KW)

    a, b, c = run(3), run(3), run(4)
    assert all(len(t) == 10 for t in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_a_sampled_chunk_repeats_from_a_restored_generator():
    """The CPU form of the card's sampled ``graph_check``: a chunk run from
    the generator's saved state repeats the draws of the same chunk run
    before (same tokens, same arena bytes); run on without the restore it
    draws fresh numbers."""
    jcfg = CONFIGS["gemma_tiny"]()
    _, tp, tcfg = build_pair(jcfg, seed=21, fused=True)
    srv = GenerationServer(tp, tcfg, device="cpu", overlap=False, max_batch=3,
                           **SAMPLED, **SERVE_KW)
    for p in _prompts(tcfg)[:3]:
        srv.submit(p, 30)
    srv.step()
    exe = srv._decode
    tok, pos = torch.from_numpy(srv._last.copy()), torch.from_numpy(srv._pos.copy())
    arena0 = [t.clone() for c in srv.arena for t in c]
    state = srv.generator.get_state()
    want = serve_decode(tp, srv.arena, tok, pos, tcfg, exe.steps, **exe._kw)
    arena1 = [t.clone() for c in srv.arena for t in c]
    for live, saved in zip((t for c in srv.arena for t in c), arena0):
        live.copy_(saved)
    srv.generator.set_state(state)
    got = exe(tok, pos)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(a, b) for a, b in
               zip((t for c in srv.arena for t in c), arena1))
    again = exe(tok, pos)
    assert not torch.equal(again[0], got[0])


@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_top_k_1_generate_equals_jax_greedy(name):
    jcfg = ALL_CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=7, fused=True)
    toks = _prompt(tcfg, (2, 9), seed=8).astype(np.int32)
    want = np.asarray(jt.generate(jp, jnp.asarray(toks), jcfg, 12))
    got = tt.generate(tp, toks, tcfg, 12, temperature=0.7, top_k=1,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["gemma_tiny", "qwen2", "gemma2"])
def test_top_k_1_server_equals_jax_greedy_server(name, layout):
    jcfg = ALL_CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=21, fused=True)
    kw = dict(**LAYOUTS[layout], **SERVE_KW)
    jsrv = JaxServer(jp, jcfg, **kw)
    tsrv = GenerationServer(tp, tcfg, device="cpu", temperature=0.7, top_k=1,
                            seed=5, **kw)
    out = []
    for srv in (jsrv, tsrv):
        rids = [srv.submit(p, b) for p, b in zip(_prompts(tcfg), BUDGETS)]
        res = srv.run()
        out.append([res[r] for r in rids])
    for g, w in zip(out[1], out[0]):
        np.testing.assert_array_equal(g, w)
    counters = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
                "preemptions")
    assert ({k: tsrv.stats()[k] for k in counters}
            == {k: jsrv.stats()[k] for k in counters})
