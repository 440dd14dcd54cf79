"""PyTorch port against Hugging Face ``transformers``: random-init tiny
Qwen2 (GQA groups 2 and 7), Mistral, Gemma-2 and Gemma-3 models built from
config objects (no downloads), their weights taken through the JAX
package's ``params_from_hf`` and the port's bridge, and the port's logits
and greedy tokens held against the HF model's. Windows small enough to
bite at the test length."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kata_xpu_device_plugin_tpu.models.convert import from_hf  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import bridge  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt  # noqa: E402

B, S = 2, 32
# Both fp32 with other op orders; logits O(1-10) at random init. The JAX
# package's own HF parity tests use the same bound.
HF_TOL = dict(rtol=2e-3, atol=2e-3)

COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2,
              attn_implementation="eager")
MODELS = {
    "qwen2": lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        num_hidden_layers=3, **COMMON)),
    # Qwen2-7B's group of 7 (7 query heads over one KV head) at test width.
    "qwen2_g7": lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **{**COMMON, "hidden_size": 112, "num_attention_heads": 7,
           "num_key_value_heads": 1}, num_hidden_layers=2)),
    "mistral": lambda: transformers.MistralForCausalLM(transformers.MistralConfig(
        num_hidden_layers=3, head_dim=16, sliding_window=8, **COMMON)),
    "gemma2": lambda: transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        num_hidden_layers=4, head_dim=16, query_pre_attn_scalar=16,
        sliding_window=8, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, **COMMON)),
    "gemma3": lambda: transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        num_hidden_layers=6, head_dim=16, query_pre_attn_scalar=16,
        sliding_window=8, sliding_window_pattern=3, rope_theta=100_000.0,
        rope_local_base_freq=1000.0,
        rope_scaling={"rope_type": "linear", "factor": 4.0}, **COMMON)),
}


def _port_model(hf_model):
    params, jcfg = from_hf(hf_model)
    tcfg = bridge.config_from_fields(
        {**dataclasses.asdict(jcfg), "dtype": "float32"})
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                       "cpu")
    return tparams, tcfg


def _hf_model(name, seed):
    """The HF model from ``seed``, with its biases and norm scales moved off
    the constants HF initialises them to (zeros, ones), so that a term the
    port drops shows in the logits."""
    torch.manual_seed(seed)
    model = MODELS[name]()
    model.eval()
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "bias" in pname or "norm" in pname:
                p.add_(0.3 * torch.randn_like(p))
    return model


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_hf(name):
    model = _hf_model(name, seed=len(name))
    toks = np.random.default_rng(len(name)).integers(0, 128, (B, S))
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(toks).long()).logits.float()
    tparams, tcfg = _port_model(model)
    if name.startswith("qwen2"):
        assert tcfg.qkv_bias and float(tparams["layers"]["bq"].abs().max()) > 0
    if name == "gemma3":
        assert tcfg.qk_norm and 4.0 in tcfg.rope_linear_cycle
    got = tt.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HF_TOL)


@pytest.mark.parametrize("name", ["qwen2_g7", "mistral", "gemma2"])
def test_greedy_tokens_match_hf(name):
    """Greedy decoding past the window through the port's caches against
    HF's full forward over the growing sequence (no HF cache)."""
    model = _hf_model(name, seed=3)
    prompt = np.random.default_rng(4).integers(0, 128, (1, 6))
    tparams, tcfg = _port_model(model)
    got = tt.generate(tparams, prompt, tcfg, 10, device="cpu").numpy()[0]
    seq = torch.from_numpy(prompt).long()
    want = []
    with torch.no_grad():
        for _ in range(10):
            nxt = model(input_ids=seq).logits[0, -1].argmax()
            want.append(int(nxt))
            seq = torch.cat([seq, nxt.view(1, 1)], dim=1)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bridge_config_keeps_the_family_flags():
    """The converted Gemma-3 config keeps its cycles through the bridge."""
    _, jcfg = from_hf(_hf_model("gemma3", seed=1))
    tcfg = bridge.config_from_fields(dataclasses.asdict(jcfg))
    assert tcfg.attn_windows == tuple(jcfg.attn_windows)
    assert tcfg.rope_theta_cycle == tuple(jcfg.rope_theta_cycle)
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
