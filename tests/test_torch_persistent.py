"""PyTorch port, persistent decode rounds: the port's persistent loop
(``models.transformer._decode_while``) against JAX
``_persistent_serve_decode`` at each of its exits (``cap``, ``done`` on a
budget, on eos and with a dead lane, ``window``), also run several steps a
group with no-op steps past the exit; the port's ``persistent=True``
server against the JAX server built with the same arguments (slotted,
with ``decode_steps``, with fused chunked admission, paged over a pool
small enough to preempt, with ``eos_id``): tokens, ``persistent_rounds``,
``persistent_exits``, delivered totals, preemptions; the steps the rounds
ran against the steps they delivered; and the knob rules (sampling
raises when explicit and degrades from the env). fp32, the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.guest.serving import _persistent_serve_decode
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, build_pair, pool_from_jax, pool_to_numpy

LENS = (14, 9, 12, 7, 15, 11)
BUDGETS = (6, 12, 9, 5, 11, 7)
KW = dict(max_batch=2, max_len=64, chunk=4, prefill_buckets=(16,))
COUNTERS = ("rounds", "prefills", "tokens_emitted", "persistent",
            "persistent_cap", "persistent_rounds", "persistent_exits",
            "delivered_steps_total", "preemptions", "sched_chunks",
            "fused_admissions")
SERVERS = {
    "slotted": {},
    "slotted_k4": dict(decode_steps=4),
    "fused_slo": dict(sched_policy="slo_chunked", prefill_chunk=4,
                      itl_slo_ms=0.0),
    # 8 usable blocks of 8 for 3 lanes that reserve up to 4 each: preempts.
    "paged": dict(max_batch=3, kv_pool_tokens=80, kv_block_size=8),
}


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


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----- the loop ---------------------------------------------------------------

MAX_LEN = 32
PROMPT = 6
# exit -> (budget, window, max_steps, eos): the delivered count they give.
EXITS = {
    "cap": ([20, 20], [MAX_LEN, MAX_LEN], 5, None),
    "done_budget": ([3, 20], [MAX_LEN, MAX_LEN], 16, None),
    "done_dead_lane": ([0, 7], [MAX_LEN, MAX_LEN], 16, None),
    "done_eos": ([20, 20], [MAX_LEN, MAX_LEN], 16, "lane1_step3"),
    "window": ([20, 20], [MAX_LEN, PROMPT + 4], 16, None),
}
DELIVERED = {"cap": 5, "done_budget": 3, "done_dead_lane": 7, "window": 4}


def _loop_inputs(models):
    jcfg, jp, _tp, _tcfg = models
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    caches, tok, _pos = jt.prefill(jp, jnp.asarray(prompts), jcfg, MAX_LEN)
    return caches, np.asarray(tok, np.int32).reshape(2)


@pytest.mark.parametrize("sub_steps", [1, 3])
@pytest.mark.parametrize("exit_", sorted(EXITS))
def test_persistent_loop_matches_jax(models, exit_, sub_steps):
    """``out[:, :delivered]``, ``tok``, ``pos``, ``delivered`` and every
    cache row equal JAX's; three steps a group run up to two no-op steps
    past the exit and change none of them."""
    jcfg, jp, tp, tcfg = models
    caches, tok = _loop_inputs(models)
    budget, window, max_steps, eos = EXITS[exit_]
    pos = np.full(2, PROMPT, np.int32)
    want_d = DELIVERED.get(exit_)
    if eos is not None:
        # eos: the token lane 1 emits at its third step; the round ends
        # at the first step either lane emits it.
        ref = np.asarray(_persistent_serve_decode(
            jp, jax.tree.map(jnp.copy, caches), jnp.asarray(tok),
            jnp.asarray(pos), jnp.asarray(budget, jnp.int32),
            jnp.asarray(window, jnp.int32), jcfg, max_steps)[0])
        eos = int(ref[1, 2])
        want_d = 1 + int(np.argmax((ref == eos).any(axis=0)))
    tc = pool_from_jax(caches)
    want = _persistent_serve_decode(
        jp, jax.tree.map(jnp.copy, caches), jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(budget, jnp.int32), jnp.asarray(window, jnp.int32), jcfg,
        max_steps, eos_id=eos)
    out, tc2, t_tok, t_pos, delivered = tt._decode_while(
        tp, tc, torch.from_numpy(tok.copy()), torch.from_numpy(pos),
        torch.tensor(budget), torch.tensor(window), tcfg, max_steps,
        eos_id=eos, sub_steps=sub_steps)
    j_out, j_caches, j_tok, j_pos, j_delivered = want
    d = int(j_delivered)
    assert int(delivered) == d == want_d
    assert tuple(out.shape) == (2, max_steps)
    np.testing.assert_array_equal(out[:, :d].numpy(), np.asarray(j_out)[:, :d])
    assert not out[:, d:].any()
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    # A no-op step writes each lane's k/v at its pinned position, the row
    # the lane's next step writes there anyway: rows below it are equal,
    # and with no step past the exit every row is.
    for a, b in zip(pool_to_numpy(tc2), pool_to_numpy(j_caches)):
        if sub_steps == 1:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        for lane, p in enumerate(np.asarray(j_pos)):
            np.testing.assert_allclose(a[:, lane, :p], b[:, lane, :p],
                                       rtol=1e-4, atol=1e-4)


def test_persistent_steps_past_the_exit_change_nothing(models):
    """After the exit the loop's steps are no-ops: the state stays as the
    exit left it (the stop flag set), the first of them writes only each
    lane's row at its pinned position, and later ones change nothing."""
    _, _, tp, tcfg = models
    caches, tok = _loop_inputs(models)
    tc = pool_from_jax(caches)
    st = tt.persistent_state(torch.from_numpy(tok.copy()),
                             torch.full((2,), PROMPT), torch.tensor([2, 20]),
                             torch.full((2,), MAX_LEN), 8)
    tt._persistent_steps(tp, tc, st, tcfg, 2, 8)
    assert bool(st["stop"]) and int(st["delivered"]) == 2
    before = {k: v.clone() for k, v in st.items()}
    rows = [a.copy() for a in pool_to_numpy(tc)]
    tt._persistent_steps(tp, tc, st, tcfg, 1, 8)
    once = [a.copy() for a in pool_to_numpy(tc)]
    tt._persistent_steps(tp, tc, st, tcfg, 3, 8)
    for k, v in st.items():
        assert torch.equal(v, before[k]), k
    pinned = st["pos"].tolist()
    for a, b, c in zip(pool_to_numpy(tc), rows, once):
        np.testing.assert_array_equal(a, c)
        for lane, p in enumerate(pinned):
            np.testing.assert_array_equal(a[:, lane, :p], b[:, lane, :p])
            np.testing.assert_array_equal(a[:, lane, p + 1:], b[:, lane, p + 1:])


# ----- the server -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_persistent_server_matches_jax(models, monkeypatch, name):
    monkeypatch.delenv("KATA_TPU_PERSISTENT", raising=False)
    jcfg, jp, tp, tcfg = models
    kw = {**KW, **SERVERS[name], "persistent": True}
    want, jst = _serve(JaxServer(jp, jcfg, **kw))
    got, tst = _serve(GenerationServer(tp, tcfg, device="cpu", **kw))
    _same(got, want)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    exits = tst["persistent_exits"]
    assert sum(exits.values()) == tst["persistent_rounds"] > 0
    # Each request's first token comes from its prefill and every other
    # one from a persistent round, which ends at the step a lane froze:
    # no token is trimmed (a fused round runs a fixed chunk instead).
    if name != "fused_slo":
        assert tst["persistent_rounds"] == tst["rounds"]
        assert (tst["tokens_emitted"] - tst["prefills"]
                == tst["delivered_lane_steps"] == sum(BUDGETS) - len(BUDGETS))
    if name == "paged":
        assert tst["preemptions"] >= 1 and tst["kv_blocks_in_use"] == 0


def test_persistent_server_with_eos_matches_jax(models):
    jcfg, jp, tp, tcfg = models
    kw = {**KW, "persistent": True, "eos_id": 7}
    want, jst = _serve(JaxServer(jp, jcfg, **kw))
    got, tst = _serve(GenerationServer(tp, tcfg, device="cpu", **kw))
    _same(got, want)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}


@pytest.mark.parametrize("sub_steps", [1, 3])
def test_rounds_run_at_most_a_group_past_their_exit(models, sub_steps):
    """Tokens and delivered counts do not depend on the steps a group
    runs; each round runs fewer than ``sub_steps`` steps past its exit
    (none at one step a group), counted in ``persistent_steps_executed``."""
    _, _, tp, tcfg = models
    base, _ = _serve(GenerationServer(tp, tcfg, device="cpu", **KW))
    srv = GenerationServer(tp, tcfg, device="cpu", persistent=True, **KW)
    srv._round.sub_steps = sub_steps
    got, st = _serve(srv)
    _same(got, base)
    rounds, delivered = st["persistent_rounds"], st["delivered_steps_total"]
    past = st["persistent_steps_executed"] - delivered
    assert 0 <= past <= rounds * (sub_steps - 1)
    assert st["persistent_steps_executed"] % sub_steps == 0
    assert st["tokens_emitted"] == sum(len(o) for o in got)


# ----- knob rules -------------------------------------------------------------


def test_sampling_conflict_raises_when_explicit(models):
    _, _, tp, tcfg = models
    with pytest.raises(ValueError, match="sampling"):
        GenerationServer(tp, tcfg, device="cpu", temperature=0.8,
                         persistent=True, **KW)


@pytest.mark.parametrize("env,kw,on", [
    ("1", dict(temperature=0.8), 0), ("maybe", {}, 0), ("1", {}, 1),
    ("0", {}, 0), ("1", dict(persistent=False), 0),
], ids=["sampling", "malformed", "enables", "off", "explicit_wins"])
def test_env_knob_degrades_like_jax(models, monkeypatch, env, kw, on):
    jcfg, jp, tp, tcfg = models
    monkeypatch.setenv("KATA_TPU_PERSISTENT", env)
    want = JaxServer(jp, jcfg, **KW, **kw).stats()
    got = GenerationServer(tp, tcfg, device="cpu", **KW, **kw).stats()
    keys = ("persistent", "persistent_cap")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["persistent"] == on


def test_stats_schema_always_present(models, monkeypatch):
    monkeypatch.delenv("KATA_TPU_PERSISTENT", raising=False)
    _, _, tp, tcfg = models
    _out, st = _serve(GenerationServer(tp, tcfg, device="cpu", **KW))
    assert (st["persistent"], st["persistent_cap"], st["persistent_rounds"],
            st["delivered_steps"], st["delivered_steps_total"],
            st["persistent_steps_executed"]) == (0, 0, 0, 0, 0, 0)
    assert st["persistent_exits"] == {"cap": 0, "done": 0, "window": 0}
