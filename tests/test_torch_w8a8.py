"""PyTorch port, W8A8 (int8 x int8 dots with per-row activation scales) and
the int8-KV quality gate, against the JAX package on the same numpy
weights (fp32, the CPU).

W8A8: ``weight_matmul`` under ``set_w8a8(True)`` in both packages (reset
in ``finally``): the activation's int8 payload and scales bit-equal to
JAX's, the int32 dot exact, the output within 1e-6 relative of JAX's;
against weight-only int8 within JAX's op bound ``0.05 x max|ref| + 1e-3``;
a W8A8 model's logits within 1e-4 of scale of JAX's W8A8 model and a
W8A8 server's tokens equal to the JAX W8A8 server's. The config's widths
are used by no other test, so no JAX executable traced before the switch
is reused. MoE experts stay weight-only. The env knob is read once at
import.

The gate (``scripts/torch_eval_kv_quant.py``): the port's evidence against
``tools/eval_quality.py``'s on the same params and prompts (equal token
agreement, drift within 1e-4), and the gate passing at JAX's thresholds
(0.7 and 0.5), as JAX's Tier-1 asserts it."""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import moe as tmoe
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant
from tools import eval_quality as jeval

from .torch_parity import CONFIGS, numpy_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gate_module():
    spec = importlib.util.spec_from_file_location(
        "torch_eval_kv_quant", os.path.join(ROOT, "scripts", "torch_eval_kv_quant.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def w8a8():
    """Both packages switched to W8A8 for the test, back off after it."""
    jquant.set_w8a8(True)
    tquant.set_w8a8(True)
    try:
        yield
    finally:
        jquant.set_w8a8(False)
        tquant.set_w8a8(False)


@pytest.fixture(scope="module")
def model():
    """Widths of this file alone (d_ff 160, vocabulary 320): the JAX
    executables it traces are its own."""
    jcfg = dataclasses.replace(CONFIGS["tiny"](), d_ff=160, vocab_size=320)
    jp, tp, tcfg = numpy_pair(jcfg, seed=31)
    jq = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
    tq = tquant.quantize_decoder_params(tt.fuse_decoder_params(tp))
    return jcfg, jq, tcfg, tq


def test_weight_matmul_matches_jax(model, w8a8):
    _, jq, _, tq = model
    x = np.random.default_rng(1).standard_normal((2, 4, 64)).astype(np.float32)
    for name in ("wqkv", "w_down"):
        jw = jquant.QTensor(jq["layers"][name].q[0], jq["layers"][name].scale[0])
        tw = tquant.QTensor(tq["layers"][name].q[0], tq["layers"][name].scale[0])
        xin = x if name == "wqkv" else np.random.default_rng(2).standard_normal(
            (2, 4, 160)).astype(np.float32)
        got = tquant.weight_matmul(torch.from_numpy(xin), tw).numpy()
        want = np.asarray(jquant.weight_matmul(jnp.asarray(xin), jw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        xq_t = tquant.quantize(torch.from_numpy(xin), dim=-1)
        xq_j = jquant.quantize(jnp.asarray(xin), axis=-1)
        np.testing.assert_array_equal(xq_t.q.numpy(), np.asarray(xq_j.q))
        np.testing.assert_array_equal(xq_t.scale.numpy(), np.asarray(xq_j.scale))
        tquant.set_w8a8(False)
        ref = tquant.weight_matmul(torch.from_numpy(xin), tw).numpy()
        tquant.set_w8a8(True)
        assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max() + 1e-3
        assert np.abs(got - ref).max() > 0  # the int8 x int8 path ran


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (5, 3, 48)).astype(np.int8)
    b = rng.integers(-127, 128, (48, 24)).astype(np.int8)
    got = tquant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (5, 3, 24)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_w8a8_model_and_server_match_jax(model, w8a8):
    """Logits of the int8 fused model under W8A8 against JAX's, further
    from the weight-only logits than from JAX's; a paged overlapped W8A8
    server's tokens equal to the JAX W8A8 server's."""
    jcfg, jq, tcfg, tq = model
    toks = np.random.default_rng(4).integers(0, 320, (2, 9)).astype(np.int32)
    want = np.asarray(jt.forward(jq, jnp.asarray(toks), jcfg))
    got = tt.forward(tq, torch.from_numpy(toks).long(), tcfg).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    tquant.set_w8a8(False)
    weight_only = tt.forward(tq, torch.from_numpy(toks).long(), tcfg).numpy()
    tquant.set_w8a8(True)
    assert np.abs(weight_only - got).max() > 10 * np.abs(got - want).max()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 320, n).astype(np.int32) for n in (5, 9, 14, 3)]
    budgets = (7, 5, 9, 6)
    kw = dict(max_batch=3, max_len=40, prefill_buckets=(8, 16), chunk=4,
              kv_pool_tokens=96, kv_block_size=4)
    outs = []
    for srv in (JaxServer(jq, jcfg, **kw),
                GenerationServer(tq, tcfg, device="cpu", **kw)):
        rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
        res = srv.run()
        outs.append([np.asarray(res[r]) for r in rids])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)


def test_moe_experts_stay_weight_only(w8a8):
    """Under W8A8 an MoE layer's int8 experts give the weight-only result
    bit for bit, as JAX's ``_expert_einsum`` ignores the switch."""
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, num_experts=4, top_k=2,
                         capacity_factor=4.0)
    p = tmoe.init_moe_params(cfg, torch.Generator().manual_seed(2))
    for k in ("w_gate", "w_in", "w_out"):
        p[k] = tquant.quantize(p[k])
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(3))
    on, _ = tmoe.moe_ffn(p, x, cfg)
    tquant.set_w8a8(False)
    off, _ = tmoe.moe_ffn(p, x, cfg)
    assert torch.equal(on, off)


def test_w8a8_env_is_read_at_import():
    code = ("from kata_xpu_device_plugin_tpu_torch.ops import quant; "
            "print(quant.w8a8_enabled())")
    env = dict(os.environ, KATA_TPU_W8A8="1", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "True"
    assert not tquant.w8a8_enabled()


def test_kv_gate_matches_jax_and_passes():
    jcfg = CONFIGS["tiny"]()
    jp, tp, tcfg = numpy_pair(jcfg, seed=0)
    gate = _gate_module()
    prompts = gate.default_prompts(tcfg.vocab_size, 4, seed=0)
    # One cache length for every prompt: JAX compiles its decode once.
    got = gate.evaluate_kv_quant(tp, tcfg, prompts, steps=12, max_len=32)
    want = jeval.evaluate_kv_quant(jp, jcfg, prompts, steps=12, max_len=32)
    assert got["greedy_match"] == want["greedy_match"]
    assert [p["tokens_agree"] for p in got["per_prompt"]] == [
        p["tokens_agree"] for p in want["per_prompt"]]
    np.testing.assert_allclose(got["logit_max_abs_err"],
                               want["logit_max_abs_err"], rtol=0, atol=1e-4)
    assert (gate.DEFAULT_MIN_GREEDY_MATCH, gate.DEFAULT_MAX_LOGIT_ERR) == (
        jeval.DEFAULT_MIN_GREEDY_MATCH, jeval.DEFAULT_MAX_LOGIT_ERR)
    assert gate.gate(got), got
    assert gate.gate(got) == jeval.gate(want)
    assert not gate.gate(dict(got, greedy_match=0.69))
    assert not gate.gate(dict(got, logit_max_abs_err=0.51))
