"""PyTorch port, Hugging Face checkpoint conversion
(``models/convert.py``) against the JAX package's: for each of the seven
model types a random-init ``transformers`` model (built from a config
object, nothing downloaded) goes through both ``from_hf``; the params are
equal as numpy arrays and the configs field by field; ``to_hf_state_dict``
and ``hf_config_dict`` give JAX's output; a save and load through
``safetensors`` round-trips bit for bit; the port's logits match the HF
model's within ``HF_TOL`` (``tests/test_torch_hf_families.py``'s bound);
and JAX's refusals are raised with JAX's messages."""
import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kata_xpu_device_plugin_tpu.models import convert as jconvert  # noqa: E402
from kata_xpu_device_plugin_tpu.models import transformer as jt  # noqa: E402
from kata_xpu_device_plugin_tpu.ops import quant as jquant  # noqa: E402
from kata_xpu_device_plugin_tpu_torch import models as tmodels  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import bridge  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import convert as tconvert  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt  # noqa: E402
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant  # noqa: E402

from .test_torch_hf_families import HF_TOL  # noqa: E402

COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2,
              attn_implementation="eager")
MODELS = {
    "llama": lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        num_hidden_layers=2, max_position_embeddings=512,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}, **COMMON)),
    "mistral": lambda: transformers.MistralForCausalLM(transformers.MistralConfig(
        num_hidden_layers=2, head_dim=16, sliding_window=8, **COMMON)),
    "mixtral": lambda: transformers.MixtralForCausalLM(transformers.MixtralConfig(
        num_hidden_layers=2, num_local_experts=4, num_experts_per_tok=2,
        **COMMON)),
    "qwen2": lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        num_hidden_layers=2, **COMMON)),
    "gemma": lambda: transformers.GemmaForCausalLM(transformers.GemmaConfig(
        num_hidden_layers=2, head_dim=16, **COMMON)),
    "gemma2": lambda: transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        num_hidden_layers=2, head_dim=16, query_pre_attn_scalar=16,
        sliding_window=8, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, **COMMON)),
    "gemma3_text": lambda: transformers.Gemma3ForCausalLM(
        transformers.Gemma3TextConfig(
            num_hidden_layers=3, head_dim=16, query_pre_attn_scalar=16,
            sliding_window=8, sliding_window_pattern=3, **COMMON)),
}


def _hf_model(name, seed=0):
    """The HF model from ``seed``, biases and norm scales moved off HF's
    constant init so a dropped term shows."""
    torch.manual_seed(seed)
    model = MODELS[name]()
    model.eval()
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "bias" in pname or "norm" in pname:
                p.add_(0.3 * torch.randn_like(p))
    return model


def _flat(tree):
    return {k: np.asarray(v) for k, v in _items(tree)}


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module", params=sorted(MODELS))
def converted(request):
    """``(name, hf model, jax (params, cfg), port (params, cfg))``."""
    name = request.param
    model = _hf_model(name, seed=len(name))
    return (name, model, jconvert.from_hf(model),
            tconvert.from_hf(model, device="cpu"))


def test_params_and_config_equal_jax(converted):
    """Every leaf equal as numpy (both go through fp32 numpy), the same
    keys, and the config field by field (the port's through the bridge's
    field reading of JAX's); the model type is one of the seven."""
    name, _model, (jp, jcfg), (tp, tcfg) = converted
    assert name in jconvert._FAMILIES and name in tconvert._FAMILIES
    want, got = _flat(jp), {k: v.numpy() for k, v in _items(tp)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcfg == bridge.config_from_fields(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_export_equals_jax(converted):
    """``to_hf_state_dict`` and ``hf_config_dict`` equal JAX's (the same
    keys and arrays; ``max_position_embeddings`` stamped when given);
    Gemma-3 refuses export with JAX's message on both sides."""
    name, model, (jp, jcfg), (tp, tcfg) = converted
    if name == "gemma3_text":
        with pytest.raises(ValueError) as jerr:
            jconvert.to_hf_state_dict(jp, jcfg, name)
        with pytest.raises(ValueError) as terr:
            tconvert.to_hf_state_dict(tp, tcfg, name)
        assert str(terr.value) == str(jerr.value)
        return
    jsd, jhf = jconvert.to_hf_state_dict(jp, jcfg, name, 4096)
    tsd, thf = tmodels.to_hf_state_dict(tp, tcfg, name, 4096)
    assert thf == jhf == tconvert.hf_config_dict(tcfg, name, 4096)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        assert tsd[k].is_contiguous()
        np.testing.assert_array_equal(tsd[k].numpy(), np.asarray(jsd[k]), err_msg=k)
    # The export is HF's own state dict again: the model's weights back.
    hf = model.state_dict()
    for k, v in tsd.items():
        np.testing.assert_allclose(v.numpy(), hf[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_save_load_round_trip(converted, tmp_path):
    """``save_hf_checkpoint`` then ``load_hf_checkpoint`` (the lazy
    safetensors view): the same params bit for bit, the same config; a
    bf16 leaf exports as bf16."""
    pytest.importorskip("safetensors")
    name, _model, _j, (tp, tcfg) = converted
    if name == "gemma3_text":
        return
    tconvert.save_hf_checkpoint(tp, tcfg, name, str(tmp_path))
    back, bcfg = tconvert.load_hf_checkpoint(str(tmp_path), device="cpu")
    assert bcfg == tcfg
    for (k, a), (k2, b) in zip(_items(tp), _items(back)):
        assert k == k2 and torch.equal(a, b), k
    half = tt.map_leaf(lambda t: t.to(torch.bfloat16), tp["embed"])
    sd, _ = tconvert.to_hf_state_dict({**tp, "embed": half}, tcfg, name)
    assert sd["model.embed_tokens.weight"].dtype == torch.bfloat16


def test_logits_match_hf(converted):
    """The port's fp32 forward of the converted tree against the HF
    model's logits (Mixtral's capacity at the default factor drops no copy
    of these 32 tokens over 4 experts at top-2)."""
    name, model, _j, (tp, tcfg) = converted
    toks = np.random.default_rng(len(name)).integers(0, 128, (2, 16))
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(toks).long()).logits.float()
    got = tt.forward(tp, torch.from_numpy(toks),
                     dataclasses.replace(tcfg, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HF_TOL)


def _cfg(model_type, **kw):
    base = dict(model_type=model_type, vocab_size=32, hidden_size=16,
                num_hidden_layers=1, num_attention_heads=2,
                num_key_value_heads=1, intermediate_size=32)
    return {**base, **kw}


BAD_CONFIGS = {
    "model_type": _cfg("gpt2"),
    "rope_yarn": _cfg("llama", rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    "rope_llama3_fields": _cfg("llama", rope_scaling={"rope_type": "llama3"}),
    "gemma3_rope": _cfg("gemma3_text", rope_scaling={"rope_type": "yarn"}),
    "attention_bias": _cfg("llama", attention_bias=True),
    "mlp_bias": _cfg("mistral", mlp_bias=True),
    "hidden_act": _cfg("gemma", hidden_act="gelu"),
    "gemma2_scalar": _cfg("gemma2", head_dim=8, query_pre_attn_scalar=16),
    "gemma3_layer_types": _cfg("gemma3_text", layer_types=["mystery"]),
    "gemma3_window": _cfg("gemma3_text", layer_types=["sliding_attention"],
                          sliding_window=-1),
    "qwen2_window": _cfg("qwen2", use_sliding_window=True),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_refusals_are_jax_s(case):
    """Each convention this forward does not implement is refused by both
    ``config_from_hf`` with the same error and message."""
    bad = BAD_CONFIGS[case]
    with pytest.raises(Exception) as jerr:
        jconvert.config_from_hf(bad)
    with pytest.raises(Exception) as terr:
        tconvert.config_from_hf(bad)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def _export_cases(jp, jcfg, tp, tcfg):
    return {
        "fused": ((jt.fuse_decoder_params(jp), jcfg, "llama"),
                  (tt.fuse_decoder_params(tp), tcfg, "llama")),
        "int8": (({**jp, "layers": {**jp["layers"], "wq": jquant.quantize(
            jp["layers"]["wq"])}}, jcfg, "llama"),
                 ({**tp, "layers": {**tp["layers"], "wq": tquant.quantize(
                     tp["layers"]["wq"])}}, tcfg, "llama")),
        "activation": ((jp, jcfg, "gemma"), (tp, tcfg, "gemma")),
        "moe": ((jp, jcfg, "mixtral"), (tp, tcfg, "mixtral")),
        "qkv_bias": ((jp, jcfg, "qwen2"), (tp, tcfg, "qwen2")),
        "llama3_rope": ((jp, jcfg, "mistral"), (tp, tcfg, "mistral")),
        "model_type": ((jp, jcfg, "gpt2"), (tp, tcfg, "gpt2")),
    }


def test_param_and_export_refusals_are_jax_s():
    """``params_from_hf`` on a mismatched projection shape, a missing key,
    an untied config without ``lm_head``; ``to_hf_state_dict`` on fused,
    int8 and mismatched-family trees: the same errors and messages."""
    model = _hf_model("llama")
    sd = model.state_dict()
    jp, jcfg = jconvert.from_hf(model)
    tp, tcfg = tconvert.from_hf(model, device="cpu")
    wrong = dataclasses.replace(tcfg, head_dim=8)
    jwrong = dataclasses.replace(jcfg, head_dim=8)
    missing = {k: v for k, v in sd.items() if "up_proj" not in k}
    untied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    cases = [
        ((sd, jwrong, "llama"), (sd, wrong, "llama")),
        ((missing, jcfg, "llama"), (missing, tcfg, "llama")),
        ((untied, jcfg, "llama"), (untied, tcfg, "llama")),
        ((sd, jcfg, "gpt2"), (sd, tcfg, "gpt2")),
    ]
    for jargs, targs in cases:
        with pytest.raises(Exception) as jerr:
            jconvert.params_from_hf(*jargs)
        with pytest.raises(Exception) as terr:
            tconvert.params_from_hf(*targs, device="cpu")
        assert type(terr.value) is type(jerr.value)
        assert str(terr.value) == str(jerr.value)
    for name, (jargs, targs) in _export_cases(jp, jcfg, tp, tcfg).items():
        with pytest.raises(Exception) as jerr:
            jconvert.to_hf_state_dict(*jargs)
        with pytest.raises(Exception) as terr:
            tconvert.to_hf_state_dict(*targs)
        assert type(terr.value) is type(jerr.value), name
        assert str(terr.value) == str(jerr.value), name
    with pytest.raises(ValueError) as jerr:
        jconvert.from_hf(sd)
    with pytest.raises(ValueError) as terr:
        tconvert.from_hf(sd, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_entry_points_default_to_the_card():
    """Without ``device`` the conversion places the tree on CUDA, which
    this machine lacks: it raises, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = _hf_model("llama")
    with pytest.raises(Exception, match="CUDA|cuda"):
        tconvert.from_hf(model)
