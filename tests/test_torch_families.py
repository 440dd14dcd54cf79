"""PyTorch port, the dense families beyond Gemma-1 and Llama-3 (Qwen2's qkv
biases, Mistral's sliding window, Gemma-2's window cycle, post-norms and
softcaps, Gemma-3's QK-norm and rope cycles) against the JAX package on the
same weights (fp32, the CPU), with every bias and norm moved off the
constants ``init_params`` gives them so that a missing term shows:
``forward`` logits, prefill then decode, greedy ``generate`` tokens, both
weight layouts and int8 weights, and the server's tokens and counters,
slotted and paged, overlapped and lock-step. Also the decode backend the
server picks by config (a window or a softcap rules the kernel out, as in
the JAX server) and the decode kernels' gates at every GQA group 1-8, with
the plain versions at group 7 against the JAX kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import decode_attn as jdec
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch import models as tmodels
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt
from kata_xpu_device_plugin_tpu_torch.ops import decode_attn as tdec
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

from .torch_parity import FAMILIES, build_pair

# Logits of the same fp32 model: XLA and PyTorch sum in other orders, a few
# ulps an op through the layers (max |diff| 3.4e-5 at logits ~9, gemma3).
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# One fp32 attention call against the JAX kernel in interpret mode.
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = sorted(FAMILIES)

BUCKETS = (8, 16)
# Prompts and budgets past the test windows (6 and 8), so that the band
# masks both prefill and decode.
LENGTHS = (5, 7, 11, 16, 3, 9)
BUDGETS = (6, 9, 4, 12, 7, 10)
SERVE_KW = dict(max_len=48, prefill_buckets=BUCKETS, chunk=4, kv_quant=True)
LAYOUTS = {
    "slotted": dict(max_batch=3),
    # 14 usable blocks of 4: growth runs the pool dry, lanes are preempted.
    "paged": dict(max_batch=4, kv_pool_tokens=64, kv_block_size=4),
}
COUNTERS = ("rounds", "prefills", "prefill_batches", "tokens_emitted",
            "preemptions")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=NAMES)
def family(request):
    """``(name, jax_cfg, jax_params, torch_params, torch_cfg)``, fused and
    perturbed, one per family."""
    jcfg = FAMILIES[request.param]()
    return (request.param, jcfg) + build_pair(jcfg, seed=31, fused=True,
                                              perturbed=True)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, fused):
    jcfg = FAMILIES[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=1, fused=fused, perturbed=True)
    if jcfg.qkv_bias:
        assert ("bqkv" if fused else "bq") in tp["layers"]
    toks = _tokens(2, (2, 19), jcfg.vocab_size)
    lj = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    lt = tt.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(lt.numpy(), lj, **LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_perturbed_leaves_change_the_logits(name):
    """The perturbation reaches the output: the same model with its biases
    and norms at init_params' constants gives other logits."""
    jcfg = FAMILIES[name]()
    _, tp, tcfg = build_pair(jcfg, seed=1, perturbed=True)
    _, tp0, _ = build_pair(jcfg, seed=1)
    toks = torch.from_numpy(_tokens(2, (1, 9), jcfg.vocab_size))
    moved = (tt.forward(tp, toks, tcfg) - tt.forward(tp0, toks, tcfg)).abs()
    assert float(moved.max()) > 0.1


def test_prefill_then_decode_matches_jax(family):
    """Ragged batched prefill, then eight ragged decode steps from each
    row's own position: logits, caches, tokens and positions."""
    _, jcfg, jp, tp, tcfg = family
    toks = _tokens(4, (3, 16), jcfg.vocab_size)
    lens = np.array([16, 9, 12], np.int32)
    cj, lj, pj = jt.prefill_batch(jp, jnp.asarray(toks), jcfg, 32,
                                  jnp.asarray(lens))
    ct, lt, pt = tt.prefill_batch(tp, torch.from_numpy(toks), tcfg, 32,
                                  torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOGIT_TOL)
    first = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    oj, _, _, posj = jt._decode_scan(
        jp, cj, jnp.asarray(first), pj, jcfg, 8, None, False, 0,
        jnp.float32(0.0), jax.random.PRNGKey(0), return_state=True)
    ot, _, _, post = tt._decode_scan(
        tp, ct, torch.from_numpy(first), pt, tcfg, 8, return_state=True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(post.numpy(), np.asarray(posj))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_jax(name, fused):
    jcfg = FAMILIES[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=7, fused=fused, perturbed=True)
    toks = _tokens(8, (2, 11), jcfg.vocab_size)
    gj = np.asarray(jt.generate(jp, jnp.asarray(toks), jcfg, 14))
    gt = tt.generate(tp, toks, tcfg, 14, device="cpu")
    np.testing.assert_array_equal(gt.numpy(), gj)


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_and_kv_match_jax(name):
    jcfg = FAMILIES[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=9, fused=True, quantized=True,
                              perturbed=True)
    assert isinstance(tp["layers"]["wqkv"], tquant.QTensor)
    toks = _tokens(10, (2, 12), jcfg.vocab_size)
    lj = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    lt = tt.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(lt.numpy(), lj, **LOGIT_TOL)
    gj = np.asarray(jt.generate(jp, jnp.asarray(toks), jcfg, 8, kv_quantized=True))
    gt = tt.generate(tp, toks, tcfg, 8, kv_quantized=True, device="cpu")
    np.testing.assert_array_equal(gt.numpy(), gj)


def _serve(server):
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, server.cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    rids = [server.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    out = server.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "lockstep"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_server_matches_jax_server(family, layout, overlap):
    name, jcfg, jp, tp, tcfg = family
    kw = dict(overlap=overlap, **LAYOUTS[layout], **SERVE_KW)
    jsrv = JaxServer(jp, jcfg, **kw)
    tsrv = GenerationServer(tp, tcfg, device="cpu", **kw)
    want, got = _serve(jsrv), _serve(tsrv)
    for g, w, b in zip(got, want, BUDGETS):
        assert len(g) == b
        np.testing.assert_array_equal(g, w)
    jstats, tstats = jsrv.stats(), tsrv.stats()
    assert {k: tstats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert tstats["decode_backend"] == "reference"  # JAX: "xla_reference"
    assert tstats["decode_backend_reason"] == jstats["decode_backend_reason"]
    if layout == "paged":
        assert tstats["preemptions"] >= 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_qwen2_through_the_paged_kernels_plain_version(layout):
    """The GQA group of 2 and the qkv biases through the decode kernel's
    plain version (what the wrapper runs on CPU tensors) equal the JAX
    server's tokens."""
    jcfg = FAMILIES["qwen2"]()
    jp, tp, tcfg = build_pair(jcfg, seed=33, fused=True, perturbed=True)
    kw = dict(**LAYOUTS[layout], **SERVE_KW)
    want = _serve(JaxServer(jp, jcfg, **kw))
    srv = GenerationServer(tp, tcfg, device="cpu", decode_attn="cuda_paged", **kw)
    for g, w in zip(_serve(srv), want):
        np.testing.assert_array_equal(g, w)
    assert srv.stats()["decode_backend"] == "cuda_paged"


# ----- the decode backend by config (a fault: the port chose the kernel
# without looking at the config, and the kernel raised on the card) -----


CONFLICTS = {
    "mistral": "sliding_window",
    "gemma2": "sliding_window",
    "gemma3": "sliding_window",
    "softcap_only": "logits_softcap",
}


def _conflict_cfg(name):
    if name == "softcap_only":
        return jt.tiny_test_config(attn_logits_softcap=50.0, dtype=jnp.float32)
    return FAMILIES[name]()


@pytest.mark.parametrize("name", sorted(CONFLICTS))
def test_decode_backend_resolves_by_config_as_jax(name, monkeypatch):
    """A window or an attention-logit softcap rules the decode kernel out
    before anything runs, whatever the device: the server decodes with the
    plain attention and names the reason, as the JAX server does; an
    explicit kernel raises at construction; an env-injected one degrades."""
    jcfg = _conflict_cfg(name)
    jp, tp, tcfg = build_pair(jcfg, seed=3)
    kw = dict(max_len=48, prefill_buckets=BUCKETS)
    stats = GenerationServer(tp, tcfg, device="cpu", **kw).stats()
    jstats = JaxServer(jp, jcfg, **kw).stats()
    assert (stats["decode_backend"], stats["decode_backend_reason"]) == (
        "reference", CONFLICTS[name])
    assert stats["decode_backend_reason"] == jstats["decode_backend_reason"]
    with pytest.raises(ValueError, match=CONFLICTS[name]):
        GenerationServer(tp, tcfg, device="cpu", decode_attn="cuda_paged", **kw)
    monkeypatch.setenv("KATA_TPU_DECODE_ATTN", "cuda_paged")
    stats = GenerationServer(tp, tcfg, device="cpu", **kw).stats()
    assert (stats["decode_backend"], stats["decode_backend_reason"]) == (
        "reference", CONFLICTS[name])
    assert GenerationServer(tp, tcfg, device="cpu", decode_attn="reference",
                            **kw).stats()["decode_backend_reason"] == "forced"


def test_qwen2_keeps_the_kernel():
    """No window, no softcap: the config rules nothing out."""
    jcfg = FAMILIES["qwen2"]()
    _, tp, tcfg = build_pair(jcfg, seed=3)
    stats = GenerationServer(tp, tcfg, device="cpu", max_len=48,
                             decode_attn="cuda_paged").stats()
    assert (stats["decode_backend"], stats["decode_backend_reason"]) == (
        "cuda_paged", "forced")


# ----- GQA groups 1-8 (a fault: the decode kernels took 1, 2, 4 and 8, and
# Qwen2-7B's 28 query heads over 4 KV heads are a group of 7) -----


@pytest.mark.parametrize("group", range(1, 9))
def test_decode_kernel_gates_take_every_group(group):
    tdec.check_kernel_shapes(128, group, 16)
    tdec.check_dense_shapes(1, 2048, 128, group)
    for bad in (0, 9, 16):
        with pytest.raises(ValueError, match="paged decode kernel"):
            tdec.check_kernel_shapes(128, bad, 16)
        with pytest.raises(ValueError, match="dense decode kernel"):
            tdec.check_dense_shapes(1, 2048, 128, bad)


def test_qwen2_7b_decode_builder_passes_the_card_gate():
    """The serving decode builder checks the kernel's shapes for a CUDA
    device at construction (no card needed): Qwen2-7B's group of 7, paged
    at tile 16 and slotted."""
    cfg = tmodels.qwen2_7b()
    assert cfg.n_heads // cfg.n_kv_heads == 7
    fn = tatt.make_decode_attn_fn(cfg, paged=True, block_size=16,
                                  paged_len=8192, device="cuda")
    assert fn.multi_query
    tatt.make_decode_attn_fn(cfg, arena_len=2048, device="cuda")


def _g7_pool(seed, bs, B=3, KV=2, D=16, NB=6):
    """Group 7: 14 query heads over 2 KV heads; permuted tables, ZERO past
    each lane's frontier, ragged positions with a block edge and 0."""
    rng = np.random.default_rng(seed)
    H = 7 * KV
    plen = NB * bs
    NT = (2 + B * NB) * bs
    q = rng.standard_normal((B, 1, H, D), np.float32)
    pk = rng.standard_normal((1, NT, KV, D), np.float32)
    pv = rng.standard_normal((1, NT, KV, D), np.float32)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0
    pos = np.array([bs * 3 - 1, 0, plen - 1], np.int32)
    tables = rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2
    for b in range(B):
        tables[b, int(pos[b]) // bs + 1:] = 0
    return q, pk, pv, tables, pos, plen


@pytest.mark.parametrize("int8", [False, True], ids=["fp32-pool", "int8-pool"])
def test_group7_paged_decode_matches_jax_interpret(int8):
    bs = 4
    q, pk, pv, tables, pos, plen = _g7_pool(40, bs)
    kj, vj = jnp.asarray(pk), jnp.asarray(pv)
    kt, vt = torch.from_numpy(pk), torch.from_numpy(pv)
    if int8:
        kj, vj = jquant.quantize_kv(kj), jquant.quantize_kv(vj)
        kt, vt = tquant.quantize_kv(kt), tquant.quantize_kv(vt)
    want = np.asarray(jdec.pallas_paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(pos),
        block_size=bs, paged_len=plen, interpret=True))
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
            torch.from_numpy(pos))
    got = tdec.paged_decode_attention(*args, block_size=bs, paged_len=plen)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # The CPU model of the kernels' split-K passes, at group 7.
    split = tdec.paged_decode_split_reference(*args, block_size=bs,
                                              paged_len=plen)
    np.testing.assert_allclose(split.numpy(), want, **ATTN_TOL)


def test_group7_dense_decode_matches_jax_interpret():
    rng = np.random.default_rng(41)
    B, S, KV, D = 2, 256, 2, 16
    q = rng.standard_normal((B, 1, 7 * KV, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    want = np.asarray(jdec.pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(200),
        interpret=True))
    got = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.tensor(200, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


# ----- configs, leaves and the rope cycles -----


@pytest.mark.parametrize("name", [
    "gemma2_2b", "gemma2_9b", "gemma2_test_config", "gemma3_4b",
    "gemma3_test_config", "qwen2_7b", "qwen2_test_config", "mistral_7b",
    "mistral_test_config",
])
def test_family_configs_equal_jax(name):
    from kata_xpu_device_plugin_tpu import models as jmodels

    want = dataclasses.asdict(getattr(jmodels, name)())
    got = dataclasses.asdict(getattr(tmodels, name)())
    assert want.pop("dtype") == jnp.bfloat16 and got.pop("dtype") == torch.bfloat16
    assert got == want
    tt.check_supported(getattr(tmodels, name)())


def test_init_params_makes_the_family_leaves():
    cfg = bridge.config_from_fields({
        **dataclasses.asdict(FAMILIES["gemma3"]()), "qkv_bias": True})
    p = tt.init_params(cfg, seed=0, device="cpu")["layers"]
    L = cfg.n_layers
    for k in ("post_attn_norm", "post_mlp_norm"):
        assert torch.equal(p[k], torch.ones(L, cfg.d_model))
    for k in ("q_norm", "k_norm"):
        assert torch.equal(p[k], torch.ones(L, cfg.head_dim))
    assert torch.equal(p["bq"], torch.zeros(L, cfg.q_dim))
    assert p["bk"].shape == p["bv"].shape == (L, cfg.kv_dim)
    fused = tt.fuse_decoder_params({"layers": p})["layers"]
    assert "bq" not in fused and fused["bqkv"].shape == (L, cfg.q_dim + 2 * cfg.kv_dim)


def test_check_supported_refuses_what_jax_refuses():
    base = tt.tiny_test_config(n_layers=4)
    # MoE is ported; JAX's MoEConfig still refuses top_k > num_experts.
    with pytest.raises(ValueError, match="top_k"):
        tt.check_supported(dataclasses.replace(base, moe_num_experts=2,
                                               moe_top_k=3))
    with pytest.raises(ValueError, match="not divisible"):
        tt.check_supported(dataclasses.replace(base, attn_windows=(4, 4, 0)))
    with pytest.raises(ValueError, match="one entry per"):
        tt.check_supported(dataclasses.replace(
            base, attn_windows=(4, 0), rope_theta_cycle=(1e4,)))


def test_layer_window_and_rope_follow_the_cycles():
    cfg = tmodels.gemma3_4b()
    assert [cfg.layer_window(i) for i in range(6)] == [1024] * 5 + [0]
    assert cfg.layer_rope(0) == (10000.0, 1.0)
    assert cfg.layer_rope(5) == (1_000_000.0, 8.0)
    assert tmodels.mistral_7b().layer_window(31) == 4096
    assert tmodels.qwen2_7b().layer_rope(3) == (1e6, 1.0)


@pytest.mark.parametrize("linear", [1.0, 8.0])
def test_rope_linear_factor_matches_jax(linear):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    rj = jt.rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (), linear)
    rt = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (), linear)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4, rtol=1e-4)
