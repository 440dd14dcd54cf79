"""Carry weights and configs from the JAX package into the port.

The caller turns the JAX parameter tree into numpy
(``jax.tree.map(np.asarray, params)``); this module never imports JAX. Both
layouts are accepted (separate ``wq/wk/wv``/``w_gate``/``w_up``/``bq/bk/bv``
or fused ``wqkv``/``w_gateup``/``bqkv``), with the leaves the config's
flags add (post-sublayer norms, qkv biases, QK-norms; an MoE config's
``router`` and expert stacks ``moe_w_gate``/``moe_w_in``/``moe_w_out`` in
place of the dense FFN). Wrapped leaves are recognised by duck typing: any
object with ``.q`` and ``.scale`` becomes a :class:`..ops.quant.QTensor`,
any with ``.base``, ``.a``, ``.b`` and ``.scale`` a
:class:`..ops.lora.LoRAWeight` (its base possibly int8). Matrices keep the
JAX layout ``[L, d_in, d_out]``; nothing is transposed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.lora import LoRAWeight
from ..ops.quant import QTensor
from .transformer import DecoderConfig, check_supported


def _dtype_name(d) -> str:
    return getattr(d, "__name__", None) or getattr(d, "name", None) or str(d)


def config_from_fields(fields: dict) -> DecoderConfig:
    """The port's config from ``dataclasses.asdict`` of the JAX one; the
    dtype may be a name ("bfloat16") or any dtype object that carries one."""
    known = {f.name for f in dataclasses.fields(DecoderConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown DecoderConfig fields: {sorted(unknown)}")
    kw = dict(fields)
    if "dtype" in kw and not isinstance(kw["dtype"], torch.dtype):
        name = _dtype_name(kw["dtype"])
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {kw['dtype']!r}")
        kw["dtype"] = dtype
    for k, v in kw.items():
        if isinstance(v, list):
            kw[k] = tuple(v)
    return DecoderConfig(**kw)


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")  # writable: torch shares the buffer
    if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it directly
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf(a, device):
    if all(hasattr(a, f) for f in ("base", "a", "b", "scale")):
        return LoRAWeight(_leaf(a.base, device), _tensor(a.a, device),
                          _tensor(a.b, device), _tensor(a.scale, device))
    if hasattr(a, "q") and hasattr(a, "scale"):
        return QTensor(_tensor(a.q, device), _tensor(a.scale, device))
    return _tensor(a, device)


def params_from_numpy(tree: dict, cfg: DecoderConfig, device) -> dict:
    """The port's parameter dict from a numpy copy of the JAX tree."""
    check_supported(cfg)
    layers = tree["layers"]
    fused = "wqkv" in layers
    need = ("wqkv",) if fused else ("wq", "wk", "wv")
    if cfg.moe:
        need += ("router", "moe_w_gate", "moe_w_in", "moe_w_out")
    else:
        need += (("w_gateup",) if fused else ("w_gate", "w_up")) + ("w_down",)
    need += ("attn_norm", "wo", "mlp_norm")
    if cfg.post_norms:
        need += ("post_attn_norm", "post_mlp_norm")
    if cfg.qkv_bias:
        need += ("bqkv",) if fused else ("bq", "bk", "bv")
    if cfg.qk_norm:
        need += ("q_norm", "k_norm")
    missing = [k for k in need if k not in layers]
    if missing:
        raise ValueError(f"parameter tree lacks layer weights {missing}")
    embed_shape = tuple(np.shape(tree["embed"]))
    if embed_shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {embed_shape} does not match the config")
    out = {
        "embed": _tensor(tree["embed"], device),
        "final_norm": _tensor(tree["final_norm"], device),
        "layers": {k: _leaf(layers[k], device) for k in need},
    }
    if not cfg.tie_embeddings:
        out["unembed"] = _tensor(tree["unembed"], device)
    return out
