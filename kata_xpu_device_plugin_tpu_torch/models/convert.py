"""Hugging Face checkpoint conversion (counterpart of
``kata_xpu_device_plugin_tpu/models/convert.py``): a ``transformers``
``state_dict`` to this package's parameter tree and
:class:`.transformer.DecoderConfig`, and back.

The "switch to this framework" piece for weights: users of the supported
families (Llama/Mistral, Mixtral, Qwen2, Gemma 1-3) hold checkpoints in the
HF ``transformers`` layout; this module maps them onto the stacked-layer
tree :func:`.transformer.init_params` defines, so ``forward``,
``generate``, the servers and ``make_train_step`` run them unchanged.
Every convention difference is resolved here, once, with the JAX
package's rules, checks and error messages:

- **Linear layout**: HF ``nn.Linear.weight`` is ``[out, in]``; this tree is
  input-major ``[in, out]``: every projection is transposed.
- **RMSNorm offset**: :func:`.transformer.rms_norm` computes ``(1 + scale)
  * x_hat`` (HF ``Gemma*RMSNorm``); Llama-family HF norms compute ``weight
  * x_hat``, so their converted scale is ``weight - 1``.
- **Norm placement**: Llama/Gemma-1 ``post_attention_layernorm`` is the
  pre-MLP norm (``mlp_norm``); Gemma-2/3 add output norms
  (``post_attn_norm``/``post_mlp_norm``, ``pre_feedforward_layernorm`` as
  ``mlp_norm``).
- **Windows and softcaps**: Gemma-2's sliding window on even layers,
  Gemma-3's ``layer_types`` compressed to their period, the softcaps.
- **Mixtral experts**: per-expert ``w1/w3/w2`` stack into
  ``moe_w_gate/moe_w_in/moe_w_out [L, E, ...]``; the router ``[E, d]``
  transposes into ``router [d, E]``.

Weights go through fp32 numpy (:func:`_t`, JAX's ``_t``), so converted
params equal the JAX package's bit for bit before the cast to the target
dtype. The entry points place the tree on ``device`` (CUDA unless the
caller passes another). ``safetensors`` is imported only by the two file
functions (:func:`load_hf_checkpoint`, :func:`save_hf_checkpoint`), so the
module imports without it; the in-memory path needs neither it nor
``transformers``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from .transformer import DecoderConfig

# HF model_type → (activation, scale_embeddings, rmsnorm has the +1 baked
# in, tie_word_embeddings CLASS default). The tie default matters for raw
# config.json dicts: save_pretrained omits fields equal to the class
# default, so a tied Gemma checkpoint's dict has no tie_word_embeddings
# key at all.
_FAMILIES = {
    "llama": ("swiglu", False, False, False),
    "mistral": ("swiglu", False, False, False),
    "mixtral": ("swiglu", False, False, False),
    "qwen2": ("swiglu", False, False, False),
    "gemma": ("geglu", True, True, True),
    "gemma2": ("geglu", True, True, True),
    "gemma3_text": ("geglu", True, True, True),
}


def config_from_hf(hf_config: Any) -> DecoderConfig:
    """Map a ``transformers`` config object (or plain dict) to
    :class:`DecoderConfig`. Raises on unsupported ``model_type``."""
    get = (hf_config.get if isinstance(hf_config, Mapping)
           else lambda k, d=None: getattr(hf_config, k, d))
    model_type = get("model_type")
    if model_type not in _FAMILIES:
        raise ValueError(
            f"unsupported model_type {model_type!r}; supported: "
            f"{sorted(_FAMILIES)}"
        )
    activation, scale_embeddings, _, tie_default = _FAMILIES[model_type]
    # Fail closed on conventions this forward does not implement, so a
    # checkpoint never converts cleanly into wrong logits:
    scaling = get("rope_scaling")
    rope_llama3_scaling: tuple = ()
    gemma3_linear_factor = 1.0
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type")) or "default"
        if model_type == "gemma3_text":
            # HF applies rope_scaling to the GLOBAL rotary only (local
            # layers force rope_type=default at rope_local_base_freq), so
            # only the linear rescale maps — anything else (llama3/yarn)
            # would be applied per-layer differently than here.
            if rope_type == "linear":
                gemma3_linear_factor = float(scaling["factor"])
            elif rope_type != "default":
                raise ValueError(
                    f"rope_scaling rope_type={rope_type!r} is not "
                    "supported for gemma3_text (only the released "
                    "checkpoints' 'linear' global-layer rescale is)"
                )
        elif rope_type == "llama3":
            try:
                rope_llama3_scaling = (
                    float(scaling["factor"]),
                    float(scaling["low_freq_factor"]),
                    float(scaling["high_freq_factor"]),
                    float(scaling["original_max_position_embeddings"]),
                )
            except (KeyError, TypeError, ValueError) as bad:
                raise ValueError(
                    "rope_scaling rope_type='llama3' needs numeric "
                    "factor, low_freq_factor, high_freq_factor and "
                    f"original_max_position_embeddings fields: {bad!r}"
                ) from None
        elif rope_type != "default":
            raise ValueError(
                f"rope_scaling={scaling!r} is not supported: this forward "
                "implements plain RoPE and the llama3 per-band rescale "
                "only (yarn/linear/dynamic would convert without error "
                "but produce wrong logits at every position)"
            )
    for bias_field in ("attention_bias", "mlp_bias"):
        # qwen2's q/k/v biases ARE modeled (its branch sets qkv_bias) —
        # an attention_bias:true annotation there is accurate, not an
        # unsupported convention.
        if bias_field == "attention_bias" and model_type == "qwen2":
            continue
        if get(bias_field):
            raise ValueError(
                f"{bias_field}=True is not supported for "
                f"{model_type!r}: this family's projections are "
                "bias-free here (qwen2 is the one family whose q/k/v "
                "biases are modeled) and a silently dropped bias would "
                "corrupt the logits"
            )
    # The MLP gate nonlinearity is hardcoded per family (swiglu=silu,
    # geglu=tanh-approx gelu); a checkpoint trained with a different
    # hidden_act must not convert into silently different logits.
    allowed_acts = (
        {"silu"} if activation == "swiglu" else {"gelu_pytorch_tanh"}
    )
    for act_field in ("hidden_act", "hidden_activation"):
        act = get(act_field)
        if act is not None and act not in allowed_acts:
            raise ValueError(
                f"{act_field}={act!r} is not supported for "
                f"{model_type!r}: this forward applies "
                f"{sorted(allowed_acts)[0]!r} (exact-erf 'gelu' included "
                "— the tanh approximation here would drift from it)"
            )
    n_heads = get("num_attention_heads")
    d_model = get("hidden_size")
    head_dim = get("head_dim")
    if head_dim is None:
        # save_pretrained omits fields equal to the class default, and every
        # Gemma config class defaults head_dim=256 — which does NOT equal
        # d_model // n_heads for gemma-7b (3072/16=192), gemma2-9b (224) or
        # gemma3-4b (320). The quotient fallback is only correct for the
        # llama-family classes, which derive head_dim that way.
        head_dim = 256 if model_type.startswith("gemma") else d_model // n_heads
    kw = dict(
        vocab_size=get("vocab_size"),
        d_model=d_model,
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=get("num_key_value_heads") or n_heads,
        head_dim=head_dim,
        d_ff=get("intermediate_size"),
        rope_theta=float(get("rope_theta", 10000.0)),
        rope_llama3_scaling=rope_llama3_scaling,
        norm_eps=float(get("rms_norm_eps", 1e-6)),
        activation=activation,
        scale_embeddings=scale_embeddings,
        tie_embeddings=bool(get("tie_word_embeddings", tie_default)),
    )
    if model_type == "gemma2":
        kw.update(
            post_norms=True,
            # HF Gemma2Attention: even layer indices are sliding-window,
            # odd are global — layer 0 local matches cycle order.
            attn_windows=(int(get("sliding_window") or 0), 0),
            attn_logits_softcap=float(get("attn_logit_softcapping") or 0.0),
            logits_softcap=float(get("final_logit_softcapping") or 0.0),
        )
        scalar = get("query_pre_attn_scalar")
        if scalar is not None and int(scalar) != head_dim:
            raise ValueError(
                f"query_pre_attn_scalar={scalar} != head_dim={head_dim}: "
                "this forward scales attention by head_dim**-0.5 only "
                "(true for the released Gemma-2 2B/9B/27B checkpoints)"
            )
    elif model_type == "mistral":
        kw.update(sliding_window=int(get("sliding_window") or 0))
    elif model_type == "mixtral":
        kw.update(
            # Mixtral carries mistral's sliding_window field (None in the
            # released 8x7B config, set by community fine-tunes) — dropping
            # it would un-mask attention past the window.
            sliding_window=int(get("sliding_window") or 0),
            moe_num_experts=int(get("num_local_experts")),
            moe_top_k=int(get("num_experts_per_tok")),
        )
    elif model_type == "gemma3_text":
        layer_types = list(get("layer_types") or [])
        if not layer_types:
            # Raw config.json dicts saved before transformers introduced
            # layer_types carry sliding_window_pattern instead; HF's
            # Gemma3TextConfig derives the list the same way (every
            # pattern-th layer is global).
            pattern = int(get("sliding_window_pattern") or 6)
            layer_types = [
                "sliding_attention" if (i + 1) % pattern else "full_attention"
                for i in range(int(get("num_hidden_layers")))
            ]
        # Compress the per-layer attention types to their minimal period
        # (the released checkpoints repeat 5 sliding : 1 full) — the scan
        # unrolls one period, so compile cost scales with it.
        known = {"sliding_attention", "full_attention"}
        unknown = sorted(set(layer_types) - known)
        if unknown:
            raise ValueError(
                f"unknown gemma3 layer_types {unknown}: only "
                f"{sorted(known)} are modeled — an unrecognized type "
                "must not silently become full attention"
            )
        # 4096 is Gemma3TextConfig's class default — absent from raw
        # dicts saved with use_diff (save_pretrained omits defaults).
        sw = int(get("sliding_window") or 4096)
        if "sliding_attention" in layer_types and sw <= 0:
            raise ValueError(
                "gemma3_text config declares sliding_attention layers "
                f"but sliding_window={get('sliding_window')!r} — "
                "converting them to full attention would un-mask them"
            )
        n = len(layer_types)
        period = next(
            p for p in range(1, n + 1)
            if n % p == 0 and layer_types == layer_types[:p] * (n // p)
        )
        windows = tuple(
            sw if t == "sliding_attention" else 0
            for t in layer_types[:period]
        )
        theta_local = float(get("rope_local_base_freq", 10000.0))
        theta_global = kw["rope_theta"]
        kw.update(
            post_norms=True,
            qk_norm=True,
            attn_windows=windows,
            # local (windowed) layers rope at the local base frequency;
            # global layers at rope_theta, linearly rescaled on 4B+.
            rope_theta_cycle=tuple(
                theta_local if w > 0 else theta_global for w in windows
            ),
            rope_linear_cycle=(
                tuple(
                    1.0 if w > 0 else gemma3_linear_factor for w in windows
                )
                if gemma3_linear_factor != 1.0 else ()
            ),
        )
        scalar = get("query_pre_attn_scalar")
        if scalar is not None and int(scalar) != head_dim:
            raise ValueError(
                f"query_pre_attn_scalar={scalar} != head_dim={head_dim}: "
                "this forward scales attention by head_dim**-0.5 only "
                "(true for the released Gemma-3 1B/4B/12B text "
                "checkpoints; 27B scales by hidden/heads and is not "
                "supported)"
            )
    elif model_type == "qwen2":
        # Qwen2's q/k/v projections carry additive biases (wo/MLP do not).
        kw.update(qkv_bias=True)
        if get("use_sliding_window"):
            # Qwen2 gates its window per layer index (max_window_layers) —
            # different semantics from the uniform window here; the
            # released Qwen2/2.5 checkpoints ship use_sliding_window=False.
            raise ValueError(
                "use_sliding_window=True is not supported: Qwen2's "
                "layer-gated window (max_window_layers) has no equivalent "
                "here and a uniform window would attend differently"
            )
    return DecoderConfig(**kw)


def _t(x) -> np.ndarray:
    """A torch tensor or array-like as float32 numpy (JAX's ``_t``)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _on(a: np.ndarray, device: torch.device, dtype) -> torch.Tensor:
    """An fp32 numpy array (a transposed view is taken as it is) as a
    contiguous tensor of ``dtype`` on ``device``: cast on the host, so only
    the target dtype's bytes cross to the device."""
    return torch.from_numpy(a).to(dtype=dtype).to(device).contiguous()


def params_from_hf(
    state_dict: Mapping[str, Any],
    cfg: DecoderConfig,
    model_type: str,
    dtype=torch.float32,
    device=None,
) -> Any:
    """Convert an HF ``state_dict`` to the stacked-layer tree on
    ``device`` (CUDA unless given).

    ``state_dict`` keys may carry the ``model.`` prefix (ForCausalLM) or
    not (bare base model); both are accepted. Each weight is cast to
    ``dtype`` layer by layer before stacking, so no whole ``[L, ...]``
    stack is staged in fp32.
    """
    if model_type not in _FAMILIES:
        raise ValueError(f"unsupported model_type {model_type!r}")
    device = resolve_device(device)
    norm_has_plus1 = _FAMILIES[model_type][2]
    # Kept as the Mapping it is: a lazy checkpoint view resolves keys on
    # access, so the whole state_dict never materializes at once.
    sd = state_dict
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def take(name):
        key = f"{prefix}{name}"
        if key not in sd:
            raise KeyError(
                f"missing {key!r} in state_dict (family {model_type})"
            )
        return _t(sd[key])

    def norm(name):
        w = take(name)
        # rms_norm computes (1 + scale)·x̂; HF llama-family computes w·x̂.
        return w if norm_has_plus1 else w - 1.0

    def stack(fn):
        return torch.stack([_on(fn(i), device, dtype)
                            for i in range(cfg.n_layers)])

    L = "layers.{i}."
    # The projection shapes are checked before anything converts: a config
    # whose head_dim was mis-derived must fail here with the shapes, not in
    # the first forward. Shapes are read off the raw tensors.
    for proj, expected, derivation in (
        ("q_proj", (cfg.q_dim, cfg.d_model),
         f"n_heads={cfg.n_heads} × head_dim={cfg.head_dim}"),
        ("k_proj", (cfg.kv_dim, cfg.d_model),
         f"n_kv_heads={cfg.n_kv_heads} × head_dim={cfg.head_dim}"),
    ):
        key = f"{prefix}{L.format(i=0)}self_attn.{proj}.weight"
        if key not in sd:
            raise KeyError(f"missing {key!r} in state_dict (family {model_type})")
        got = tuple(sd[key].shape)  # HF linear layout [out, in]
        if got != expected:
            raise ValueError(
                f"{proj} weight is {got} but the config derives {expected} "
                f"({derivation}, d_model={cfg.d_model}): the checkpoint and "
                "config disagree — most often a re-saved config.json "
                "missing its head_dim field"
            )
    layers = {
        "attn_norm": stack(lambda i: norm(L.format(i=i) + "input_layernorm.weight")),
        "wq": stack(lambda i: take(L.format(i=i) + "self_attn.q_proj.weight").T),
        "wk": stack(lambda i: take(L.format(i=i) + "self_attn.k_proj.weight").T),
        "wv": stack(lambda i: take(L.format(i=i) + "self_attn.v_proj.weight").T),
        "wo": stack(lambda i: take(L.format(i=i) + "self_attn.o_proj.weight").T),
    }
    if cfg.qkv_bias:  # Qwen2: additive q/k/v projection biases
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
            layers[ours] = stack(
                lambda i, t=theirs: take(L.format(i=i) + f"self_attn.{t}.bias"))
    if cfg.qk_norm:  # Gemma-3: per-head QK-norms ((1+w) convention)
        layers["q_norm"] = stack(
            lambda i: norm(L.format(i=i) + "self_attn.q_norm.weight"))
        layers["k_norm"] = stack(
            lambda i: norm(L.format(i=i) + "self_attn.k_norm.weight"))
    if model_type in ("gemma2", "gemma3_text"):
        layers["post_attn_norm"] = stack(
            lambda i: norm(L.format(i=i) + "post_attention_layernorm.weight"))
        layers["mlp_norm"] = stack(
            lambda i: norm(L.format(i=i) + "pre_feedforward_layernorm.weight"))
        layers["post_mlp_norm"] = stack(
            lambda i: norm(L.format(i=i) + "post_feedforward_layernorm.weight"))
    else:
        # Llama/Gemma-1 "post_attention_layernorm" is the pre-MLP norm.
        layers["mlp_norm"] = stack(
            lambda i: norm(L.format(i=i) + "post_attention_layernorm.weight"))
    if model_type == "mixtral":
        E = cfg.moe_num_experts
        moe = L + "block_sparse_moe."
        layers["router"] = stack(lambda i: take(moe.format(i=i) + "gate.weight").T)
        for ours, theirs in (("moe_w_gate", "w1"), ("moe_w_in", "w3"),
                             ("moe_w_out", "w2")):
            layers[ours] = stack(lambda i, t=theirs: np.stack(
                [take(moe.format(i=i) + f"experts.{e}.{t}.weight").T
                 for e in range(E)]))
    else:
        layers["w_gate"] = stack(
            lambda i: take(L.format(i=i) + "mlp.gate_proj.weight").T)
        layers["w_up"] = stack(
            lambda i: take(L.format(i=i) + "mlp.up_proj.weight").T)
        layers["w_down"] = stack(
            lambda i: take(L.format(i=i) + "mlp.down_proj.weight").T)

    params = {
        "embed": _on(take("embed_tokens.weight"), device, dtype),
        "layers": layers,
        "final_norm": _on(norm("norm.weight"), device, dtype),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in sd:
            raise KeyError(
                "config says untied embeddings but state_dict has no "
                "lm_head.weight"
            )
        params["unembed"] = _on(_t(sd["lm_head.weight"]).T, device, dtype)
    return params


def _safetensors(what: str, module: str = "safetensors"):
    """``safetensors`` (or one of its modules), imported where a file is
    read or written; without the package, an ``ImportError`` naming it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(
            f"{what} needs the 'safetensors' package, which is not "
            "installed (the in-memory from_hf/to_hf_state_dict path does "
            "not)") from exc


def load_hf_checkpoint(path: str, dtype=torch.float32,
                       device=None) -> tuple[Any, DecoderConfig]:
    """Load a locally saved HF checkpoint directory (``save_pretrained``
    layout: ``config.json`` + ``model.safetensors`` or a sharded
    ``model.safetensors.index.json``) without instantiating a model:
    tensors are read one at a time, on access, through a lazy Mapping
    (:class:`_LazyCheckpoint`), so peak host memory stays near the output
    tree plus one stacked weight group, never the whole checkpoint.
    ``pytorch_model.bin`` checkpoints are rejected (pickle loading pulls
    the whole file into memory and executes pickles; convert them to
    safetensors first). The tree lands on ``device`` (CUDA unless given)."""
    import json
    import os

    safe_open = _safetensors("load_hf_checkpoint").safe_open
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    st_path = os.path.join(path, "model.safetensors")
    index_path = st_path + ".index.json"
    if os.path.exists(index_path):
        # The index's weight_map is the key -> shard mapping.
        with open(index_path) as f:
            weight_map = dict(json.load(f)["weight_map"])
    elif os.path.exists(st_path):
        with safe_open(st_path, framework="pt") as f:
            weight_map = {key: "model.safetensors" for key in f.keys()}
    else:
        raise FileNotFoundError(
            f"no model.safetensors[.index.json] under {path!r} "
            "(pytorch_model.bin is not supported — convert to safetensors)"
        )
    return from_hf(_LazyCheckpoint(path, weight_map, safe_open), hf_config,
                   dtype=dtype, device=device)


class _LazyCheckpoint(Mapping):
    """Read-on-access view of a (possibly sharded) safetensors checkpoint:
    each key lookup opens its shard and copies out ONE tensor, so
    conversion peaks near the output tree plus a single stacked group
    instead of the whole checkpoint (:func:`params_from_hf` takes the
    Mapping as it is)."""

    def __init__(self, path: str, weight_map: Mapping[str, str], safe_open):
        self._path = path
        self._weight_map = dict(weight_map)
        self._open = safe_open

    def __getitem__(self, key: str):
        import os

        shard = self._weight_map[key]
        with self._open(os.path.join(self._path, shard), framework="pt") as f:
            return f.get_tensor(key)

    def __iter__(self):
        return iter(self._weight_map)

    def __len__(self):
        return len(self._weight_map)


def from_hf(
    hf_model_or_state_dict: Any,
    hf_config: Optional[Any] = None,
    dtype=torch.float32,
    device=None,
) -> tuple[Any, DecoderConfig]:
    """One-call conversion: ``(params, cfg) = from_hf(hf_model)``, the tree
    on ``device`` (CUDA unless given).

    Accepts a ``transformers`` ``*ForCausalLM``/base model (config read
    from it) or a raw ``state_dict`` plus an explicit ``hf_config``.
    """
    if hf_config is None:
        hf_config = getattr(hf_model_or_state_dict, "config", None)
        if hf_config is None:
            raise ValueError(
                "pass hf_config when converting a raw state_dict"
            )
    state_dict = (
        hf_model_or_state_dict.state_dict()
        if hasattr(hf_model_or_state_dict, "state_dict")
        else hf_model_or_state_dict
    )
    cfg = config_from_hf(hf_config)
    get = (hf_config.get if isinstance(hf_config, Mapping)
           else lambda k, d=None: getattr(hf_config, k, d))
    params = params_from_hf(state_dict, cfg, get("model_type"), dtype, device)
    return params, cfg


# ----- the reverse direction: export back to the HF ecosystem --------------


def hf_config_dict(
    cfg: DecoderConfig,
    model_type: str,
    max_position_embeddings: Optional[int] = None,
) -> dict:
    """Inverse of :func:`config_from_hf`: a plain ``config.json``-style
    dict for ``model_type``. Raises when the config carries features the
    family cannot express (so an export never silently drops semantics).

    ``max_position_embeddings``: trained context length to stamp into the
    exported config. Without it, unscaled llama/mistral/qwen2 exports
    inherit the HF CLASS default (LlamaConfig: 2048) and serving stacks
    that read it as the context limit cap an 8k+ model at 2k. For
    llama3-rope-scaled exports it overrides the ``factor × original`` span
    derived below (3.1 checkpoints train further and ship 131072)."""
    if model_type not in _FAMILIES:
        raise ValueError(f"unsupported model_type {model_type!r}")
    if model_type == "gemma3_text":
        raise ValueError(
            "gemma3_text is an import-only family: export would need the "
            "per-layer layer_types / dual-rope reconstruction"
        )
    if cfg.qk_norm or cfg.rope_theta_cycle or cfg.rope_linear_cycle:
        raise ValueError(
            "QK-norm / per-layer rope cycles (Gemma-3) have no exportable "
            f"representation in {model_type!r}"
        )
    activation, scale_embeddings, _, _ = _FAMILIES[model_type]
    if cfg.activation != activation:
        raise ValueError(
            f"cfg.activation={cfg.activation!r} does not match "
            f"{model_type!r} (expects {activation!r})"
        )
    if cfg.scale_embeddings != scale_embeddings:
        raise ValueError(
            f"cfg.scale_embeddings={cfg.scale_embeddings} does not match "
            f"{model_type!r}"
        )
    if cfg.moe != (model_type == "mixtral"):
        raise ValueError(
            f"MoE={cfg.moe} config cannot export as {model_type!r}"
        )
    if cfg.qkv_bias != (model_type == "qwen2"):
        raise ValueError(
            f"qkv_bias={cfg.qkv_bias} cannot export as {model_type!r}: "
            "only qwen2 carries q/k/v projection biases (a mismatch "
            "would leave the HF model's biases random-initialized or "
            "drop trained ones)"
        )
    if model_type == "qwen2" and cfg.head_dim * cfg.n_heads != cfg.d_model:
        raise ValueError(
            "qwen2 derives head_dim as hidden_size // num_heads; "
            f"head_dim={cfg.head_dim} × n_heads={cfg.n_heads} != "
            f"d_model={cfg.d_model} cannot round-trip"
        )
    out = dict(
        model_type=model_type,
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.d_ff,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=cfg.tie_embeddings,
    )
    if cfg.rope_llama3_scaling:
        if model_type != "llama":
            raise ValueError(
                f"{model_type!r} cannot express the llama3 rope rescale "
                "(only LlamaConfig takes rope_scaling rope_type='llama3')"
            )
        factor, low_f, high_f, old_len = cfg.rope_llama3_scaling
        out["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": factor,
            "low_freq_factor": low_f,
            "high_freq_factor": high_f,
            "original_max_position_embeddings": int(old_len),
        }
        # Without this, LlamaConfig's 2048 default would claim a context
        # BELOW the pre-scaling one and downstream consumers (serving
        # stacks read it as the context limit) would cap the long-context
        # model the rescale exists to enable. factor×old is the span the
        # rescale guarantees; trained-further checkpoints (3.1 ships
        # 131072) override via the explicit parameter.
        out["max_position_embeddings"] = int(factor * old_len)
    if max_position_embeddings is not None:
        out["max_position_embeddings"] = int(max_position_embeddings)
    if model_type == "gemma2":
        if not cfg.post_norms:
            raise ValueError("gemma2 export requires cfg.post_norms=True")
        cyc = cfg.attn_windows
        if len(cyc) != 2 or cyc[1] != 0 or cyc[0] <= 0:
            raise ValueError(
                f"gemma2 export needs attn_windows=(window, 0), got {cyc!r}"
            )
        out.update(
            sliding_window=cyc[0],
            query_pre_attn_scalar=cfg.head_dim,
            attn_logit_softcapping=cfg.attn_logits_softcap or None,
            final_logit_softcapping=cfg.logits_softcap or None,
        )
    else:
        if cfg.post_norms:
            raise ValueError(
                f"{model_type!r} has no post-norm slots; only gemma2 does"
            )
        if cfg.attn_logits_softcap or cfg.logits_softcap:
            raise ValueError(
                f"{model_type!r} cannot express logit softcaps"
            )
        if model_type in ("mistral", "mixtral"):
            if cfg.attn_windows:
                raise ValueError(
                    f"{model_type} expresses one uniform sliding_window; "
                    f"a per-layer attn_windows cycle {cfg.attn_windows!r} "
                    "would export to silently different attention"
                )
            out["sliding_window"] = cfg.sliding_window or None
        elif cfg.sliding_window or cfg.attn_windows:
            raise ValueError(
                f"{model_type!r} cannot express sliding windows"
            )
    if model_type == "mixtral":
        out.update(
            num_local_experts=cfg.moe_num_experts,
            num_experts_per_tok=cfg.moe_top_k,
        )
    return out


def to_hf_state_dict(
    params: Any,
    cfg: DecoderConfig,
    model_type: str,
    max_position_embeddings: Optional[int] = None,
) -> tuple[dict, dict]:
    """Export the stacked-layer tree to an HF ``state_dict`` (contiguous CPU
    tensors of the TREE'S dtype: a bf16 tree exports bf16; norm offsets
    are computed in fp32 then cast back) and the matching config dict: the
    inverse of :func:`params_from_hf`, applying the same convention deltas
    in reverse (transpose back to ``[out, in]``, re-add the llama-family
    norm +1, unstack layers and Mixtral experts). The whole dict is
    materialized in host memory (one tree-sized copy).

    Fused (``wqkv``), quantized (QTensor) and LoRA trees are refused with
    the required preparation named: export takes the plain training
    layout.
    """
    hf_cfg = hf_config_dict(cfg, model_type, max_position_embeddings)
    norm_has_plus1 = _FAMILIES[model_type][2]
    layers = params["layers"]
    if "wqkv" in layers:
        raise ValueError(
            "fused inference layout cannot export — convert the separate-"
            "matrix training layout (before fuse_decoder_params)"
        )
    if any(isinstance(v, tuple) for v in layers.values()):
        raise ValueError(
            "quantized/LoRA trees cannot export — dequantize or "
            "merge_lora first"
        )

    def npf(x) -> torch.Tensor:
        return x.detach().to("cpu").contiguous()

    def npt(x) -> torch.Tensor:
        # Contiguous: safetensors writes a tensor's raw buffer.
        return x.detach().to("cpu").t().contiguous()

    def norm_out(w) -> torch.Tensor:
        w = npf(w)
        if norm_has_plus1:
            return w
        # the ±1 offset in fp32, cast back to the tree's dtype
        return (w.float() + 1.0).to(w.dtype)

    sd: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": npf(params["embed"]),
        "model.norm.weight": norm_out(params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = npt(params["unembed"])

    for i in range(cfg.n_layers):
        L = f"model.layers.{i}."
        sd[L + "input_layernorm.weight"] = norm_out(layers["attn_norm"][i])
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[L + f"self_attn.{theirs}.weight"] = npt(layers[ours][i])
        if cfg.qkv_bias:
            for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                                 ("bv", "v_proj")):
                sd[L + f"self_attn.{theirs}.bias"] = npf(layers[ours][i])
        if model_type == "gemma2":
            sd[L + "post_attention_layernorm.weight"] = norm_out(
                layers["post_attn_norm"][i])
            sd[L + "pre_feedforward_layernorm.weight"] = norm_out(
                layers["mlp_norm"][i])
            sd[L + "post_feedforward_layernorm.weight"] = norm_out(
                layers["post_mlp_norm"][i])
        else:
            sd[L + "post_attention_layernorm.weight"] = norm_out(
                layers["mlp_norm"][i])
        if model_type == "mixtral":
            moe = L + "block_sparse_moe."
            sd[moe + "gate.weight"] = npt(layers["router"][i])
            for e in range(cfg.moe_num_experts):
                sd[moe + f"experts.{e}.w1.weight"] = npt(layers["moe_w_gate"][i, e])
                sd[moe + f"experts.{e}.w3.weight"] = npt(layers["moe_w_in"][i, e])
                sd[moe + f"experts.{e}.w2.weight"] = npt(layers["moe_w_out"][i, e])
        else:
            sd[L + "mlp.gate_proj.weight"] = npt(layers["w_gate"][i])
            sd[L + "mlp.up_proj.weight"] = npt(layers["w_up"][i])
            sd[L + "mlp.down_proj.weight"] = npt(layers["w_down"][i])
    return sd, hf_cfg


def save_hf_checkpoint(
    params: Any,
    cfg: DecoderConfig,
    model_type: str,
    path: str,
    max_position_embeddings: Optional[int] = None,
) -> None:
    """Write a ``save_pretrained``-layout directory (``config.json`` +
    ``model.safetensors``) that ``transformers.AutoModelForCausalLM.
    from_pretrained``, or :func:`load_hf_checkpoint`, accepts."""
    import json
    import os

    save_file = _safetensors("save_hf_checkpoint", "safetensors.torch").save_file
    sd, hf_cfg = to_hf_state_dict(params, cfg, model_type, max_position_embeddings)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    save_file(sd, os.path.join(path, "model.safetensors"))
