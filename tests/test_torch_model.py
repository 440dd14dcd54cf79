"""PyTorch port, model: ``forward``, ``prefill``, ``prefill_batch`` and
``generate`` against the JAX package on the same weights (fp32, the CPU),
on three test configs, both weight layouts, int8 weights and int8 KV."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt

from .torch_parity import CONFIGS, build_pair

# Logits of the same fp32 model: summation order differs between XLA and
# PyTorch, a few ulps per op through two layers.
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

NAMES = sorted(CONFIGS)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, fused):
    jcfg = CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=1, fused=fused)
    toks = _tokens(2, (2, 11), jcfg.vocab_size)
    lj = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    lt = tt.forward(tp, torch.from_numpy(toks), tcfg)
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), lj, **LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(name):
    jcfg = CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=3, fused=True)
    toks = _tokens(4, (1, 16), jcfg.vocab_size)
    cj, lj, pj = jt.prefill(jp, jnp.asarray(toks), jcfg, 24, return_logits=True,
                            true_len=jnp.int32(13))
    ct, lt, pt = tt.prefill(tp, torch.from_numpy(toks), tcfg, 24,
                            return_logits=True, true_len=13)
    assert pt == int(pj) == 13
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOGIT_TOL)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32-kv", "int8-kv"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_batch_matches_jax(name, kv_int8):
    jcfg = CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=5, fused=True)
    toks = _tokens(6, (3, 16), jcfg.vocab_size)
    lens = np.array([16, 9, 3], np.int32)
    cj, lj, pj = jt.prefill_batch(jp, jnp.asarray(toks), jcfg, 20,
                                  jnp.asarray(lens), kv_quantized=kv_int8)
    ct, lt, pt = tt.prefill_batch(tp, torch.from_numpy(toks), tcfg, 20,
                                  torch.from_numpy(lens), kv_quantized=kv_int8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    if kv_int8:  # the same fp32 k/v to a few ulps: payloads equal almost all
        agree = np.mean(ct[0].q.numpy() == np.asarray(cj[0].q))
        assert agree > 0.999


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_jax(name, fused):
    jcfg = CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=7, fused=fused)
    toks = _tokens(8, (2, 7), jcfg.vocab_size)
    gj = np.asarray(jt.generate(jp, jnp.asarray(toks), jcfg, 12))
    gt = tt.generate(tp, toks, tcfg, 12, device="cpu")
    np.testing.assert_array_equal(gt.numpy(), gj)


@pytest.mark.parametrize("name", NAMES)
def test_int8_weights_through_bridge_match_jax(name):
    jcfg = CONFIGS[name]()
    jp, tp, tcfg = build_pair(jcfg, seed=9, fused=True, quantized=True)
    assert isinstance(tp["layers"]["wqkv"], tt.QTensor)
    toks = _tokens(10, (2, 9), jcfg.vocab_size)
    lj = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    lt = tt.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(lt.numpy(), lj, **LOGIT_TOL)
    gj = np.asarray(jt.generate(jp, jnp.asarray(toks), jcfg, 8, kv_quantized=True))
    gt = tt.generate(tp, toks, tcfg, 8, kv_quantized=True, device="cpu")
    np.testing.assert_array_equal(gt.numpy(), gj)


def test_port_quantizes_weights_as_jax_does():
    jcfg = CONFIGS["tiny"]()
    jp, tp, tcfg = build_pair(jcfg, seed=11, fused=True)
    from kata_xpu_device_plugin_tpu.ops.quant import quantize_decoder_params
    from kata_xpu_device_plugin_tpu_torch.ops.quant import (
        quantize_decoder_params as tquantize,
    )

    qj = quantize_decoder_params(jp)["layers"]["w_gateup"]
    qt = tquantize(tp)["layers"]["w_gateup"]
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(qj.q))
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale), rtol=1e-6)


def test_decode_scan_budget_freezes_lanes_as_jax_does():
    jcfg = CONFIGS["gemma_tiny"]()
    jp, tp, tcfg = build_pair(jcfg, seed=12, fused=True)
    toks = _tokens(13, (3, 6), jcfg.vocab_size)
    cj, lj, pj = jt.prefill(jp, jnp.asarray(toks), jcfg, 20)
    ct, lt, pt = tt.prefill(tp, torch.from_numpy(toks), tcfg, 20)
    budget = np.array([5, 0, 2], np.int32)
    pos = np.full(3, 6, np.int32)
    oj, _, tokj, posj = jt._decode_scan(
        jp, cj, lj, jnp.asarray(pos), jcfg, 6, None, False, 0,
        jnp.float32(0.0), jax.random.PRNGKey(0), return_state=True,
        budget=jnp.asarray(budget))
    ot, _, tokt, post = tt._decode_scan(
        tp, ct, lt, torch.from_numpy(pos), tcfg, 6, return_state=True,
        budget=torch.from_numpy(budget))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(post.numpy(), np.asarray(posj))
    np.testing.assert_array_equal(post.numpy(), pos + budget)


def test_building_blocks_keep_the_jax_conventions():
    """rms_norm scales by (1 + scale); Gemma's embedding scale is
    sqrt(d_model) rounded to the model dtype first (bf16 45.25)."""
    x = torch.tensor([[3.0, 4.0]])
    np.testing.assert_allclose(
        tt.rms_norm(x, torch.ones(2), 0.0).numpy(),
        2.0 * x.numpy() / np.sqrt(12.5), rtol=1e-6)
    cfg = tt.DecoderConfig(vocab_size=4, d_model=2048, n_layers=1, n_heads=1,
                           n_kv_heads=1, head_dim=8, d_ff=8)
    params = {"embed": torch.ones(4, 2048, dtype=torch.bfloat16)}
    x = tt.embed(params, torch.tensor([[1]]), cfg)
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 45.25


@pytest.mark.parametrize("flag,value", [
    ("qkv_bias", True), ("qk_norm", True), ("post_norms", True),
    ("attn_windows", (4, 0)), ("rope_theta_cycle", (1e4,)),
    ("moe_num_experts", 4),
])
def test_unported_flags_raise(flag, value):
    tcfg = bridge.config_from_fields(
        {**dataclasses.asdict(CONFIGS["tiny"]()), flag: value})
    with pytest.raises(NotImplementedError):
        tt.init_params(tcfg, device="cpu")


def test_bridge_refuses_mismatched_trees():
    jcfg = CONFIGS["tiny"]()
    jp, _, tcfg = build_pair(jcfg)
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="embed"):
        bridge.params_from_numpy(tree, dataclasses.replace(tcfg, vocab_size=7),
                                 "cpu")
    del tree["layers"]["wo"]
    with pytest.raises(ValueError, match="wo"):
        bridge.params_from_numpy(tree, tcfg, "cpu")
    with pytest.raises(ValueError, match="unknown DecoderConfig"):
        bridge.config_from_fields({"nope": 1})


def test_init_params_distributions_follow_jax():
    tcfg = bridge.config_from_fields(dataclasses.asdict(CONFIGS["llama3_test"]()))
    p = tt.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(p["layers"]["attn_norm"], torch.ones_like(p["layers"]["attn_norm"]))
    std = float(p["layers"]["w_down"].std()) * np.sqrt(tcfg.d_ff)
    assert abs(std - 1.0) < 0.05
    assert "unembed" in p and p["unembed"].shape == (tcfg.d_model, tcfg.vocab_size)
    again = tt.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(p["embed"], again["embed"])


@pytest.mark.parametrize("scaling", [(), (8.0, 1.0, 4.0, 32.0)],
                         ids=["plain", "llama3"])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    rj = jt.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling)
    rt = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0, scaling)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4, rtol=1e-4)
