"""Decoder-only transformer in PyTorch (counterpart of
``kata_xpu_device_plugin_tpu/models/transformer.py``).

Parameters are a plain dict of tensors in the JAX package's layout: layer
weights stacked on a leading layer axis, matrices ``[L, d_in, d_out]``
applied as ``x @ w``, so the weight bridge copies arrays without
transposing. Layers run as a Python loop; ``lax.scan`` has no counterpart
that eager PyTorch needs. KV caches are stacked ``[L, B, max_len, KV, D]``
tensors (or int8 :class:`..ops.quant.QTensor` pairs) updated IN PLACE —
the functional JAX version returns fresh arrays; writing in place saves a
copy of the cache per step. The functions that return caches return the
same tensors they were given. A windowed config may decode over ring
caches of the window's slots instead (``ring=True``; the cycle arena of
:func:`init_cycle_kv_caches` for a window cycle), whose reads take the
plain attention masked by the slots' absolute positions.

Every family of the JAX package is modelled: qkv biases (Qwen2),
per-head QK-norm and rope cycles (Gemma-3), post-sublayer norms and window
cycles (Gemma-2), sliding windows (Mistral), and the mixture-of-experts
FFN in every layer (Mixtral, :mod:`..ops.moe`), on one device. Greedy
decoding and sampling (temperature, top-k, top-p) draw from an explicit
``torch.Generator`` on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import resolve_device
from ..ops.attention import NEG_INF
from ..ops.quant import (
    QTensor,
    dequantize_kv,
    matmul_f32,
    quantize_kv,
    weight_matmul,
)

Params = dict[str, Any]
AttnFn = Callable[..., torch.Tensor]

# On CUDA, generate() pads prompts and caches to multiples of this: a length
# the flash kernel takes and a KV tile of the paged decode kernel.
CUDA_PAD = 128


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float = 10000.0
    rope_llama3_scaling: tuple = ()
    norm_eps: float = 1e-6
    activation: str = "geglu"
    scale_embeddings: bool = True
    tie_embeddings: bool = True
    logits_softcap: float = 0.0
    sliding_window: int = 0
    attn_windows: tuple = ()
    post_norms: bool = False
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta_cycle: tuple = ()
    rope_linear_cycle: tuple = ()
    attn_logits_softcap: float = 0.0
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    dtype: Any = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def moe(self) -> bool:
        return self.moe_num_experts > 0

    def moe_cfg(self):
        from ..ops.moe import MoEConfig

        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         num_experts=self.moe_num_experts,
                         capacity_factor=self.moe_capacity_factor,
                         top_k=self.moe_top_k)

    def num_params(self) -> int:
        """Every parameter, as the JAX package counts them (an MoE layer:
        the router and every expert)."""
        embed = self.vocab_size * self.d_model
        attn = self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            attn += 2 * self.head_dim
        if self.moe:
            mlp = self.d_model * self.moe_num_experts  # router
            mlp += self.moe_num_experts * 3 * self.d_model * self.d_ff
        else:
            mlp = 3 * self.d_model * self.d_ff
        norms = (4 if self.post_norms else 2) * self.d_model
        per_layer = attn + mlp + norms
        unembed = 0 if self.tie_embeddings else embed
        return embed + self.n_layers * per_layer + self.d_model + unembed

    @property
    def window_cycle(self) -> tuple:
        """The per-layer window cycle (length 1 when uniform)."""
        return self.attn_windows or (self.sliding_window,)

    def layer_window(self, i: int) -> int:
        """Attention window of layer ``i`` (0 = global)."""
        cycle = self.window_cycle
        return cycle[i % len(cycle)]

    def layer_rope(self, i: int) -> tuple[float, float]:
        """Rope ``(theta, linear divisor)`` of layer ``i``: the cycle
        position's entries where ``rope_theta_cycle``/``rope_linear_cycle``
        are set (Gemma-3's local and global layers), else the uniform
        ``rope_theta`` and 1."""
        p = i % len(self.window_cycle)
        theta = self.rope_theta_cycle[p] if self.rope_theta_cycle else self.rope_theta
        linear = self.rope_linear_cycle[p] if self.rope_linear_cycle else 1.0
        return float(theta), float(linear)


def check_supported(cfg: DecoderConfig) -> None:
    """Raise on a config the JAX package refuses: a depth the window cycle
    does not divide, a rope cycle of another length than the window cycle,
    an MoE top-k outside ``[1, num_experts]``."""
    if cfg.moe:
        cfg.moe_cfg()
    if cfg.activation not in ("geglu", "swiglu"):
        raise ValueError(f"unknown activation {cfg.activation!r}")
    P = len(cfg.window_cycle)
    if cfg.n_layers % P:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by the "
                         f"attn_windows cycle {cfg.attn_windows}")
    for name in ("rope_theta_cycle", "rope_linear_cycle"):
        c = getattr(cfg, name)
        if c and len(c) != P:
            raise ValueError(f"{name} {c!r} must have one entry per "
                             f"attn_windows cycle position ({P})")


def tiny_test_config(**overrides) -> DecoderConfig:
    """A shapes-only config for CPU tests: 2 KV heads for GQA."""
    base = DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
                         n_kv_heads=2, head_dim=16, d_ff=128)
    return replace(base, **overrides)


# ----- initialization ------------------------------------------------------


def init_params(cfg: DecoderConfig, *, seed: int = 0, device=None,
                dtype=torch.float32, place: Optional[Callable] = None) -> Params:
    """Stacked-layer parameters with the JAX package's distributions:
    matrices normal / sqrt(fan_in), norm scales at ones (``rms_norm``
    multiplies by 1 + scale, so a fresh model scales by 2), qkv biases at
    zeros. Drawn from a ``torch.Generator`` seeded with ``seed`` on the
    target device. ``place(path, tensor)``, when given, takes each leaf as
    soon as it is drawn (``path`` dotted, e.g. ``layers.wq``) and returns
    what the tree holds instead, so a caller that cuts the leaf into
    pieces never holds more than one whole leaf."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    place = place or (lambda _path, t: t)

    def dense(path, shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return place(path, w / float(np.sqrt(fan_in)))

    def ones(path, *shape):
        return place(path, torch.ones(shape, device=device, dtype=dtype))

    def zeros(path, *shape):
        return place(path, torch.zeros(shape, device=device, dtype=dtype))

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    layers = {
        "attn_norm": ones("layers.attn_norm", L, d),
        "wq": dense("layers.wq", (L, d, cfg.q_dim), d),
        "wk": dense("layers.wk", (L, d, cfg.kv_dim), d),
        "wv": dense("layers.wv", (L, d, cfg.kv_dim), d),
        "wo": dense("layers.wo", (L, cfg.q_dim, d), cfg.q_dim),
        "mlp_norm": ones("layers.mlp_norm", L, d),
    }
    if cfg.moe:  # expert-major stacks, the router [L, d, E]
        E = cfg.moe_num_experts
        layers.update({
            "router": dense("layers.router", (L, d, E), d),
            "moe_w_gate": dense("layers.moe_w_gate", (L, E, d, f), d),
            "moe_w_in": dense("layers.moe_w_in", (L, E, d, f), d),
            "moe_w_out": dense("layers.moe_w_out", (L, E, f, d), f),
        })
    else:
        layers.update({
            "w_gate": dense("layers.w_gate", (L, d, f), d),
            "w_up": dense("layers.w_up", (L, d, f), d),
            "w_down": dense("layers.w_down", (L, f, d), f),
        })
    if cfg.post_norms:
        layers["post_attn_norm"] = ones("layers.post_attn_norm", L, d)
        layers["post_mlp_norm"] = ones("layers.post_mlp_norm", L, d)
    if cfg.qkv_bias:
        layers["bq"] = zeros("layers.bq", L, cfg.q_dim)
        layers["bk"] = zeros("layers.bk", L, cfg.kv_dim)
        layers["bv"] = zeros("layers.bv", L, cfg.kv_dim)
    if cfg.qk_norm:
        layers["q_norm"] = ones("layers.q_norm", L, cfg.head_dim)
        layers["k_norm"] = ones("layers.k_norm", L, cfg.head_dim)
    params = {
        "embed": dense("embed", (cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones("final_norm", d),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense("unembed", (d, cfg.vocab_size), d)
    return params


def fuse_decoder_params(params: Params) -> Params:
    """Inference layout: ``wqkv [L, d, q+2kv]`` and ``w_gateup [L, d, 2f]``
    replace the separate projections (one matmul each instead of three and
    two), and ``bqkv [L, q+2kv]`` the qkv biases. The separate tensors are
    dropped from the result. An MoE tree (``router``: no dense FFN to fuse)
    comes back unchanged, as in JAX; int8 and LoRA leaves raise."""
    layers = params["layers"]
    if "wqkv" in layers or "router" in layers:
        return params
    if any(isinstance(v, tuple) for v in layers.values()):
        raise ValueError(
            "fuse_decoder_params first: fusing concatenates raw weight "
            "matrices, not int8 QTensors or LoRA adapters — quantize/adapt "
            "after fusing (or merge_lora before)")
    fused = {k: v for k, v in layers.items()
             if k not in ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv")}
    fused["wqkv"] = torch.cat([layers["wq"], layers["wk"], layers["wv"]], dim=2)
    fused["w_gateup"] = torch.cat([layers["w_gate"], layers["w_up"]], dim=2)
    if "bq" in layers:
        fused["bqkv"] = torch.cat([layers["bq"], layers["bk"], layers["bv"]], dim=1)
    out = dict(params)
    out["layers"] = fused
    return out


# ----- building blocks -----------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, times (1 + scale) for every family (Gemma's form)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         llama3_scaling: tuple = (), linear_factor: float = 1.0) -> torch.Tensor:
    """Rotary embedding in fp32 on the half-split layout. x ``[B, S, H, D]``,
    positions ``[B, S]``. ``llama3_scaling`` = (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings) applies the
    Llama-3.1 per-band frequency rescale; ``linear_factor`` > 1 divides
    every angular frequency (Gemma-3's global layers)."""
    d = x.shape[-1]
    exps = torch.arange(0, d // 2, dtype=torch.float32, device=x.device) * (2.0 / d)
    # torch.full, not torch.tensor: a host-to-device copy synchronizes, and
    # the serving decode chunk is captured in a CUDA graph.
    inv_freq = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device),
                         -exps)
    if linear_factor != 1.0:
        inv_freq = inv_freq / linear_factor
    if llama3_scaling:
        factor, low_f, high_f, old_len = (float(v) for v in llama3_scaling)
        wavelen = 2.0 * np.pi / inv_freq
        smooth = (old_len / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > old_len / low_f, inv_freq / factor,
            torch.where(wavelen < old_len / high_f, inv_freq, smoothed),
        )
    angles = positions[..., None].float() * inv_freq  # [B, S, D/2]
    angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gate_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "geglu":
        return F.gelu(x, approximate="tanh")
    if kind == "swiglu":
        return F.silu(x)
    raise ValueError(f"unknown activation {kind!r}")


def embed(params: Params, tokens: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Token embedding; Gemma scales by sqrt(d_model) rounded to the model
    dtype first (bf16 45.25 at d_model 2048). Params over a training mesh
    look up vocab-parallel (:meth:`..guest.tp_serving.ServingMesh.embed`)."""
    mesh = params.get("mesh")
    if getattr(mesh, "train_mesh", None) is not None:
        return mesh.embed(params, tokens, cfg)
    return embed_rows(params["embed"][tokens], cfg)


def embed_rows(rows: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Looked-up embedding rows in the model dtype, scaled as :func:`embed`
    scales them."""
    x = rows.to(cfg.dtype)
    if cfg.scale_embeddings:
        s = torch.full((), float(np.sqrt(np.float32(cfg.d_model))),
                       dtype=torch.float32, device=x.device).to(cfg.dtype)
        x = x * s
    return x


def unembed(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Final norm, then the (tied) unembedding with fp32 logits from
    operands of the model dtype, then the optional final softcap. Params
    over a training mesh project vocab-parallel and gather the logits in
    vocab order (:meth:`..guest.tp_serving.ServingMesh.unembed`)."""
    mesh = params.get("mesh")
    if getattr(mesh, "train_mesh", None) is not None:
        return mesh.unembed(params, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    proj = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    return project_logits(x, proj, cfg)


def project_logits(x: torch.Tensor, proj: torch.Tensor,
                   cfg: DecoderConfig) -> torch.Tensor:
    """fp32 logits of the normed ``x`` against ``proj [d, V']`` (the whole
    unembedding or a vocab shard of it), both taken in the model dtype,
    then the optional final softcap."""
    logits = matmul_f32(x, proj.to(cfg.dtype))
    if cfg.logits_softcap:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits


# ----- forward pass --------------------------------------------------------


def map_leaf(fn, leaf):
    """``fn`` on every tensor of a leaf: a tensor, or a wrapper of tensors
    (an int8 :class:`QTensor`, a LoRA adapter, nested), the wrapper kept."""
    if isinstance(leaf, tuple):
        return type(leaf)(*(map_leaf(fn, t) for t in leaf))
    return fn(leaf)


def _index(leaf, i: int):
    return map_leaf(lambda t: t[i], leaf)


def _unbind(leaf) -> list:
    """Per-layer views of a stacked leaf (a tensor or a wrapper whose every
    tensor carries the leading ``[L]`` axis). One ``unbind`` per tensor:
    its backward stacks the layers' gradients once, where indexing layer
    by layer would add each into a fresh full-size zero tensor."""
    if isinstance(leaf, tuple):
        parts = [_unbind(t) for t in leaf]
        return [type(leaf)(*p) for p in zip(*parts)]
    return list(leaf.unbind(0))


def _cache_write_full(cache, x: torch.Tensor, offset) -> None:
    """Write fresh k/v ``x [B, S, KV, D]`` at sequence ``offset``, quantizing
    on the way into an int8 cache. ``offset`` is an int or a 0-dim tensor;
    a tensor stays on its device (an index copy, no host sync)."""
    S = x.shape[1]
    if torch.is_tensor(offset):
        idx = offset.long().reshape(1) + torch.arange(S, device=x.device)

        def put(dst, src):
            dst.index_copy_(1, idx, src.to(dst.dtype))
    else:
        def put(dst, src):
            dst[:, offset:offset + S] = src.to(dst.dtype)

    if isinstance(cache, QTensor):
        qt = quantize_kv(x)
        put(cache.q, qt.q)
        put(cache.scale, qt.scale)
    else:
        put(cache, x)


def _cache_write_rows(cache, x: torch.Tensor, idx: torch.Tensor,
                      wrap: int = 0) -> None:
    """Ragged write: row b's S vectors land at positions ``idx[b] ..
    idx[b]+S-1``, each clamped to max_len-1 (a lane past its budget
    scribbles on its own last entry, which is never read). ``wrap > 0``:
    a ring of ``wrap`` slots instead, position p landing at slot ``p %
    wrap`` (a span across the wrap scatters in two pieces)."""
    B, S = x.shape[:2]
    max_len = (cache.q if isinstance(cache, QTensor) else cache).shape[1]
    span = idx.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    cols = span % wrap if wrap else torch.clamp(span, max=max_len - 1)
    rows = torch.arange(B, device=x.device)[:, None]
    if isinstance(cache, QTensor):
        qt = quantize_kv(x)
        cache.q[rows, cols] = qt.q
        cache.scale[rows, cols] = qt.scale
    else:
        cache[rows, cols] = x.to(cache.dtype)


# Reserved physical blocks of the paged pool, the layout contract with
# guest.kv_arena.KVPool. Block 0 is ZERO: never written, so unmapped view
# entries read the zeros a fresh dense arena would hold. Block 1 is SCRATCH:
# the block-table filler, absorbing writes that must not land anywhere real
# (dead lanes, overruns); reads remap it to ZERO, so its contents never
# surface.
PAGED_ZERO_BLOCK = 0
PAGED_SCRATCH_BLOCK = 1


def _paged_write_token(cache, x: torch.Tensor, phys: torch.Tensor) -> None:
    """Paged decode write, in place: row b's one fresh k/v vector lands at
    PHYSICAL pool row ``phys[b]``. ``cache`` is a pool slice ``[1, NT, KV,
    D]`` (or int8 QTensor); x ``[B, 1, KV, D]``. Live lanes map distinct
    rows; lanes with no live request all aim at the scratch block, which is
    never read, so the order of their duplicate writes does not matter."""
    if isinstance(cache, QTensor):
        qt = quantize_kv(x)
        cache.q[0, phys] = qt.q[:, 0]
        cache.scale[0, phys] = qt.scale[:, 0]
    else:
        cache[0, phys] = x[:, 0].to(cache.dtype)


def _paged_write_span(cache, x: torch.Tensor, phys: torch.Tensor) -> None:
    """Multi-token sibling of :func:`_paged_write_token`: row b's S fresh
    vectors land at pool rows ``phys[b, j]``. x ``[B, S, KV, D]``."""
    if isinstance(cache, QTensor):
        qt = quantize_kv(x)
        cache.q[0, phys] = qt.q
        cache.scale[0, phys] = qt.scale
    else:
        cache[0, phys] = x.to(cache.dtype)


def _paged_view(cache, idx: torch.Tensor):
    """Gather each row's block-table view out of the pool: ``cache [1, NT,
    ...]`` and physical row indices ``idx [B, Lm]`` give ``[B, Lm, ...]``,
    the dense operand the slotted arena presents to attention."""
    if isinstance(cache, QTensor):
        return QTensor(cache.q[0][idx], cache.scale[0][idx])
    return cache[0][idx]


def _bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x + b.to(x.dtype)


def _qkv_parts(cfg: DecoderConfig, h: torch.Tensor, layer: Params, tp: int):
    """One shard's column-parallel q, k and v features (``[B, S, .]``):
    ``1/tp`` of each, from its slice of the (fused or separate) weights."""
    qd, kd = cfg.q_dim // tp, cfg.kv_dim // tp
    if "wqkv" in layer:
        qkv = weight_matmul(h, layer["wqkv"])
        if "bqkv" in layer:
            qkv = _bias(qkv, layer["bqkv"])
        return qkv[..., :qd], qkv[..., qd: qd + kd], qkv[..., qd + kd:]
    q = weight_matmul(h, layer["wq"])
    k = weight_matmul(h, layer["wk"])
    v = weight_matmul(h, layer["wv"])
    if "bq" in layer:
        q, k, v = (_bias(t, layer[b]) for t, b in
                   ((q, "bq"), (k, "bk"), (v, "bv")))
    return q, k, v


def _gather(parts: list) -> torch.Tensor:
    """The shards' column-parallel pieces side by side (the all-gather)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _per_shard(mesh, fn: AttnFn, q, k, v, **kw) -> list:
    """Attention of each shard's query heads, ``[B, S, H/tp, D]`` each: a
    shard attends with its own KV heads (``mesh.kv_heads``), or, when its
    query heads straddle KV heads, runs every head and keeps its own.
    Without a mesh, the one full attention; a training mesh
    (:class:`..parallel.spmd.LayerShards`) cuts the attention itself."""
    if mesh is None:
        return [fn(q, k, v, **kw)]
    if hasattr(mesh, "attend"):
        return mesh.attend(fn, q, k, v, **kw)
    outs = []
    for s in range(mesh.tp):
        hs, kvs = mesh.q_heads(s), mesh.kv_heads(s)
        if kvs is None:
            outs.append(fn(q, k, v, **kw)[:, :, hs])
        else:
            outs.append(fn(q[:, :, hs].contiguous(), k[:, :, kvs].contiguous(),
                           v[:, :, kvs].contiguous(), **kw))
    return outs


def _row_parallel(mesh, parts: list, shards: list, name: str) -> torch.Tensor:
    """The row-parallel projection: each shard's ``parts[s] @ w_s`` (its
    slice of the input features), summed across shards by ``mesh``."""
    outs = [weight_matmul(p, sh[name]) for p, sh in zip(parts, shards)]
    return outs[0] if mesh is None else mesh.reduce(outs)


def _layer(cfg: DecoderConfig, attn_fn: AttnFn, x: torch.Tensor, layer,
           positions: torch.Tensor, kv_cache=None, cache_offset=None,
           prefill: bool = False, decode_kernel_fn=None, block_tables=None,
           view_tables=None, block_size: int = 0,
           paged_len: int = 0, index: int = 0, mesh=None,
           ring: bool = False, moe_mesh=None) -> torch.Tensor:
    """Decoder block ``index`` (its window and rope come from the config's
    cycles), x ``[B, S, d]``. With a cache: ``prefill=True``
    writes the fresh k/v at 0 and attends over them alone (self-attention,
    flash-kernel eligible). With ``block_tables`` the cache pair is this
    layer's ``[1, NT, KV, D]`` slice of the shared block pool and
    ``cache_offset [B]`` the lanes' positions: writes go through the raw
    table, reads through ``view_tables`` (SCRATCH remapped to ZERO).
    Otherwise a ``[B]`` ``cache_offset`` is ragged decode over a slotted
    cache (a single-token step goes through ``decode_kernel_fn`` when the
    server built one), and a scalar one (an int or a 0-dim tensor) is
    lock-step decode: every row writes and attends at the same position.

    ``ring=True``: the cache pair holds a ring of ``W`` slots (this layer's
    window plus any speculative margin), position p at slot ``p % W``, and
    the attention is the plain version masked by the slots' absolute
    positions (:func:`ring_positions`): the kernels take no slot positions,
    as in the JAX package. ``W`` must cover ``window + S - 1``: a span's
    later writes must not evict a key an earlier query of the span still
    sees. Lock-step (a scalar offset) ring decode is single-token.

    Tensor-parallel (``mesh``, a :class:`..guest.tp_serving.ServingMesh`;
    ``layer`` the list of the shards' layer dicts): q/k/v and gate/up are
    column-parallel, each shard computing its slice; the slices are
    gathered (the all-gather) into the k/v written to the cache, which
    every shard's view reads; each shard attends with its own query heads
    (``decode_kernel_fn`` then returns the shards' outputs as a list);
    ``wo`` and ``w_down`` are row-parallel, each followed by the sum
    across shards; norms are replicated. An MoE layer routes once over all
    the tokens and each shard runs its own experts
    (:func:`..ops.moe.moe_ffn_tp`). Over a caller's training mesh
    (:class:`..guest.tp_serving.ServingMesh` with ``train_mesh``) a fused
    ``wqkv``/``w_gateup`` is cut anywhere along its concatenated out axis,
    so its pieces' products are gathered whole before the parts split.

    A training mesh (:class:`..parallel.spmd.LayerShards`, ``layer`` the
    list of its model shards' layer dicts, each gathered over fsdp) runs
    the same column- and row-parallel products; it calls ``attn_fn`` once
    on the whole q, k and v (the attention cuts its own blocks) and its
    MoE layer keeps its experts split over the shards.

    Returns ``(x, aux)``: ``aux`` is the MoE layer's load-balancing term
    (:func:`..ops.moe.moe_ffn`, over exactly this call's ``B x S`` tokens;
    with ``moe_mesh`` and a token count that divides over it,
    :func:`..ops.moe.moe_ffn_sharded`, as JAX dispatches), None for a dense
    layer."""
    B, S, _ = x.shape
    shards = layer if mesh is not None else [layer]
    tp = len(shards)
    akw = {}
    window = cfg.layer_window(index)
    if window:
        akw["window"] = window
    if cfg.attn_logits_softcap:
        akw["logits_softcap"] = cfg.attn_logits_softcap
    h = rms_norm(x, shards[0]["attn_norm"], cfg.norm_eps)
    fused_cut = getattr(mesh, "train_mesh", None) is not None
    if fused_cut and "wqkv" in shards[0]:
        qkv = _gather([_bias(weight_matmul(h, sh["wqkv"]), sh["bqkv"])
                       if "bqkv" in sh else weight_matmul(h, sh["wqkv"])
                       for sh in shards])
        q, k, v = qkv.split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q, k, v = (_gather(list(p)) for p in zip(
            *(_qkv_parts(cfg, h, sh, tp) for sh in shards)))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in shards[0]:  # per-head QK-norm over head_dim, before rope
        q = rms_norm(q, shards[0]["q_norm"], cfg.norm_eps)
        k = rms_norm(k, shards[0]["k_norm"], cfg.norm_eps)
    theta, linear = cfg.layer_rope(index)
    q = rope(q, positions, theta, cfg.rope_llama3_scaling, linear)
    k = rope(k, positions, theta, cfg.rope_llama3_scaling, linear)

    def attend(kk, vv, **kw):
        return _per_shard(mesh, attn_fn, q, kk, vv, causal=True, **kw, **akw)

    def kernel(*args):
        out = decode_kernel_fn(*args)
        return out if isinstance(out, list) else [out]

    if kv_cache is not None and prefill:
        ck, cv = kv_cache
        _cache_write_full(ck, k, 0)
        _cache_write_full(cv, v, 0)
        outs = attend(k, v, q_offset=None)
    elif kv_cache is not None and ring:
        from ..ops.attention import reference_attention

        ck, cv = kv_cache
        W = (ck.q if isinstance(ck, QTensor) else ck).shape[1]
        if W < window + S - 1:
            raise ValueError(
                f"ring cache has {W} slots but this layer needs window "
                f"{window} + span {S} - 1 — an undersized ring would evict "
                "keys still inside a live window")
        if torch.is_tensor(cache_offset) and cache_offset.ndim == 1:
            # Ragged: row b writes its S vectors at its own slots.
            _cache_write_rows(ck, k, cache_offset, wrap=W)
            _cache_write_rows(cv, v, cache_offset, wrap=W)
            k_pos = ring_positions(cache_offset.long()[:, None] + (S - 1), W)
        else:
            if S != 1:
                raise ValueError("lockstep ring decode is single-token")
            if not torch.is_tensor(cache_offset):
                cache_offset = torch.full((), int(cache_offset),
                                          dtype=torch.int64, device=x.device)
            _cache_write_full(ck, k, cache_offset % W)
            _cache_write_full(cv, v, cache_offset % W)
            k_pos = ring_positions(cache_offset.long(), W)
        outs = _per_shard(mesh, reference_attention, q,
                          dequantize_kv(ck, x.dtype), dequantize_kv(cv, x.dtype),
                          causal=True, q_offset=cache_offset, k_positions=k_pos,
                          window=window,
                          logits_softcap=cfg.attn_logits_softcap)
    elif kv_cache is not None and block_tables is not None:
        # Paged ragged decode. A block index past the table (a finished
        # lane overrunning its budget, a dead lane's stale position) clamps
        # to the last entry, whose filler is SCRATCH.
        ck, cv = kv_cache
        bs = block_size
        off = cache_offset.long()
        rows = torch.arange(B, device=x.device)
        last_blk = block_tables.shape[1] - 1
        if S == 1:
            blk = torch.clamp(off // bs, max=last_blk)
            phys = block_tables[rows, blk].long() * bs + off % bs  # [B]
            _paged_write_token(ck, k, phys)
            _paged_write_token(cv, v, phys)
        else:
            span = off[:, None] + torch.arange(S, device=x.device)[None, :]
            blk = torch.clamp(span // bs, max=last_blk)
            phys = block_tables[rows[:, None], blk].long() * bs + span % bs
            _paged_write_span(ck, k, phys)
            _paged_write_span(cv, v, phys)
        if decode_kernel_fn is not None and (
                S == 1 or getattr(decode_kernel_fn, "multi_query", False)):
            # The paged kernel walks each lane's table in place. A span
            # passes its LAST row's position and all-real query lengths.
            if S == 1:
                outs = kernel(q, ck, cv, view_tables, cache_offset)
            else:
                outs = kernel(
                    q, ck, cv, view_tables, cache_offset + (S - 1),
                    torch.full((B,), S, dtype=torch.int32, device=x.device))
        else:
            view_idx = (
                (view_tables.long() * bs)[:, :, None]
                + torch.arange(bs, device=x.device)[None, None, :]
            ).reshape(B, -1)[:, :paged_len]
            outs = attend(dequantize_kv(_paged_view(ck, view_idx), x.dtype),
                          dequantize_kv(_paged_view(cv, view_idx), x.dtype),
                          q_offset=cache_offset)
    elif (kv_cache is not None and torch.is_tensor(cache_offset)
          and cache_offset.ndim == 1):
        ck, cv = kv_cache
        _cache_write_rows(ck, k, cache_offset)
        _cache_write_rows(cv, v, cache_offset)
        if decode_kernel_fn is not None and S == 1:
            outs = kernel(q, ck, cv, None, cache_offset)
        else:
            outs = attend(dequantize_kv(ck, x.dtype), dequantize_kv(cv, x.dtype),
                          q_offset=cache_offset)
    elif kv_cache is not None:
        # Lock-step decode: one position for every row. On CUDA the default
        # attn_fn sends a bf16 cache to the dense decode kernel when
        # ops.attention.decode_eligible allows it.
        ck, cv = kv_cache
        _cache_write_full(ck, k, cache_offset)
        _cache_write_full(cv, v, cache_offset)
        outs = attend(dequantize_kv(ck, x.dtype), dequantize_kv(cv, x.dtype),
                      q_offset=cache_offset)
    else:
        outs = attend(k, v, q_offset=None)

    attn_proj = _row_parallel(mesh, [o.reshape(B, S, -1) for o in outs],
                              shards, "wo")
    if "post_attn_norm" in shards[0]:  # Gemma-2/3: the sublayer's output normed too
        attn_proj = rms_norm(attn_proj, shards[0]["post_attn_norm"], cfg.norm_eps)
    x = x + attn_proj
    h = rms_norm(x, shards[0]["mlp_norm"], cfg.norm_eps)
    aux = None
    if cfg.moe:
        from ..ops import moe as moe_mod

        moe_params = {"router": shards[0]["router"]}
        for n in ("w_gate", "w_in", "w_out"):
            parts = [sh[f"moe_{n}"] for sh in shards]
            moe_params[n] = parts if tp > 1 else parts[0]
        if moe_mesh is not None and moe_mod.dispatch_shardable(
                h.shape[:2], cfg.moe_num_experts, moe_mesh):
            y, aux = moe_mod.moe_ffn_sharded(moe_params, h, cfg.moe_cfg(),
                                             moe_mesh)
        elif tp > 1:  # each shard's experts on the one global dispatch
            y, aux = moe_mod.moe_ffn_tp(moe_params, h, cfg.moe_cfg())
        else:
            y, aux = moe_mod.moe_ffn(moe_params, h, cfg.moe_cfg())
        mlp_out = y.to(x.dtype)
    elif fused_cut and "w_gateup" in shards[0]:
        gu = _gather([weight_matmul(h, sh["w_gateup"]) for sh in shards])
        f = cfg.d_ff
        act = _gate_act(gu[..., :f], cfg.activation) * gu[..., f:]
        mlp_out = _row_parallel(mesh, list(act.tensor_split(tp, dim=-1)),
                                shards, "w_down")
    else:
        acts = []
        for sh in shards:
            if "w_gateup" in sh:
                gu = weight_matmul(h, sh["w_gateup"])
                f = gu.shape[-1] // 2
                acts.append(_gate_act(gu[..., :f], cfg.activation) * gu[..., f:])
            else:
                acts.append(_gate_act(weight_matmul(h, sh["w_gate"]),
                                      cfg.activation)
                            * weight_matmul(h, sh["w_up"]))
        mlp_out = _row_parallel(mesh, acts, shards, "w_down")
    if "post_mlp_norm" in shards[0]:
        mlp_out = rms_norm(mlp_out, shards[0]["post_mlp_norm"], cfg.norm_eps)
    return x + mlp_out, aux


def _layer_source(params: Params, mesh):
    """``i -> layer i's params`` as :func:`_layer` takes them: the layer's
    dict, or the shards' dicts of tensor-parallel params (over a training
    mesh, each layer's pieces gathered over fsdp as it runs)."""
    if getattr(mesh, "train_mesh", None) is not None:
        return mesh.layer_source(params["layers"])
    trees = params["shards"] if mesh is not None else [params["layers"]]
    per_shard = [{k: _unbind(v) for k, v in t.items()} for t in trees]
    if mesh is None:
        return lambda i: {k: v[i] for k, v in per_shard[0].items()}
    return lambda i: [{k: v[i] for k, v in t.items()} for t in per_shard]


def _hidden(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            attn_fn: Optional[AttnFn], positions, kv_caches, cache_offset,
            prefill: bool, decode_kernel_fn, remat: bool = False,
            block_tables=None, block_size: int = 0,
            paged_len: int = 0, ring: bool = False,
            return_aux: bool = False, moe_mesh=None):
    """The decoder stack up to (not including) the final norm. ``remat``
    (training, no caches) checkpoints each layer: its activations are
    recomputed in the backward instead of kept. Tensor-parallel serving
    params (:func:`tp_serving_params`) run every layer across their
    shards. ``ring``: the windowed layers' caches are rings
    (:func:`_layer`); with a window cycle of P > 1 positions
    ``kv_caches`` is then the cycle arena (:func:`init_cycle_kv_caches`),
    layer i reading entry ``i // P`` of position ``i % P``'s pair.
    ``return_aux``: also the mean over layers of the MoE load-balancing
    terms (fp32 0 for a dense config)."""
    check_supported(cfg)
    if attn_fn is None:
        from ..ops.attention import flash_attention

        attn_fn = flash_attention
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = embed(params, tokens, cfg)
    view_tables = None
    if block_tables is not None:
        if block_size < 1 or paged_len < 1:
            raise ValueError("block_tables need block_size and paged_len")
        view_tables = torch.where(block_tables == PAGED_SCRATCH_BLOCK,
                                  PAGED_ZERO_BLOCK, block_tables)
    mesh = params.get("mesh")
    layer_at = _layer_source(params, mesh)
    P = len(cfg.window_cycle)
    cycle_arena = ring and P > 1
    auxes = []
    for i in range(cfg.n_layers):
        layer = layer_at(i)
        if remat and kv_caches is None:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer, cfg, attn_fn, x, layer, positions, index=i,
                moe_mesh=moe_mesh, use_reentrant=False)
            auxes.append(aux)
            continue
        cache = None
        if cycle_arena:
            pair = kv_caches[i % P]
            cache = (_index(pair[0], i // P), _index(pair[1], i // P))
        elif kv_caches is not None:
            cache = (_index(kv_caches[0], i), _index(kv_caches[1], i))
        x, aux = _layer(cfg, attn_fn, x, layer, positions, cache, cache_offset,
                        prefill=prefill, decode_kernel_fn=decode_kernel_fn,
                        block_tables=block_tables, view_tables=view_tables,
                        block_size=block_size, paged_len=paged_len, index=i,
                        mesh=mesh, ring=ring and cfg.layer_window(i) > 0,
                        moe_mesh=moe_mesh)
        auxes.append(aux)
    if not return_aux:
        return x
    if cfg.moe:
        return x, torch.stack(auxes).mean()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def tp_serving_params(params: Params, cfg: DecoderConfig, mesh) -> Params:
    """Serving params split across ``mesh``'s shards
    (:func:`..parallel.sharding.shard_serving_params`): the replicated
    leaves (embeddings, final norm) as they are, ``"shards"`` the shards'
    layer trees and ``"mesh"`` the mesh. Every function of this module that
    takes params runs them tensor-parallel. Over a caller's training mesh
    (``mesh.train_mesh``) the params are instead its ``PARAM_RULES``
    pieces (:func:`..parallel.sharding.shard_params`; leaves already so
    placed are taken as they are) beside ``"mesh"``."""
    from ..parallel.sharding import shard_params, shard_serving_params

    if mesh.train_mesh is not None:
        out = shard_params(params, mesh.train_mesh, copy=False)
        out["mesh"] = mesh
        return out
    trees = shard_serving_params(params, cfg, mesh.tp)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["shards"] = [t["layers"] for t in trees]
    out["mesh"] = mesh
    return out


def forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            attn_fn: Optional[AttnFn] = None, positions=None, kv_caches=None,
            cache_offset=None, prefill: bool = False, decode_kernel_fn=None,
            remat: bool = False, block_tables=None, block_size: int = 0,
            paged_len: int = 0, ring: bool = False, return_aux: bool = False,
            moe_mesh=None):
    """tokens ``[B, S]`` → fp32 logits ``[B, S, vocab]``; with ``kv_caches``
    also returns the caches (written in place); ``return_aux=True`` appends
    the per-layer mean of the MoE load-balancing terms (0 for a dense
    config), as in JAX. ``block_tables [B, NB]``
    (with ``block_size`` and ``paged_len``) switches the cache branch to
    paged decode: ``kv_caches`` is the shared block pool
    (``guest.kv_arena.KVPool.arena``, leaves ``[L, 1, NT, ...]``) and each
    row reads and writes through its table. ``attn_fn`` defaults to
    :func:`..ops.attention.flash_attention`: the plain version on the CPU,
    the flash kernels (or an error) on CUDA, where a decode step needs
    ``decode_kernel_fn`` or an explicit plain ``attn_fn``. ``remat=True``
    wraps each layer in ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint``); it applies only without caches. ``ring=True``
    decodes over ring caches, or over the cycle arena of a window cycle
    (:func:`_hidden`). ``moe_mesh``: the mesh whose expert axis
    (:func:`..ops.moe.expert_axis_for`) splits the MoE experts, as in
    JAX."""
    out = _hidden(params, tokens, cfg, attn_fn, positions, kv_caches,
                  cache_offset, prefill, decode_kernel_fn, remat,
                  block_tables=block_tables, block_size=block_size,
                  paged_len=paged_len, ring=ring, return_aux=return_aux,
                  moe_mesh=moe_mesh)
    x, aux = out if return_aux else (out, None)
    res = (unembed(params, x, cfg),)
    if kv_caches is not None:
        res += (kv_caches,)
    if return_aux:
        res += (aux,)
    return res[0] if len(res) == 1 else res


# ----- loss / training -----------------------------------------------------


def token_nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of ``targets`` under fp32 ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.sum()


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                    attn_fn: Optional[AttnFn] = None,
                    remat: bool = False, moe_mesh=None) -> torch.Tensor:
    """Mean cross-entropy of predicting ``tokens[:, 1:]`` from
    ``tokens[:, :-1]``, plus ``cfg.moe_aux_weight`` x the MoE
    load-balancing term for an MoE config. As in the JAX package, the
    forward runs on the FULL sequence and the last position's logits are
    dropped (value-identical for dense configs under the causal mask; for
    MoE the last token also competes for expert capacity and counts in the
    aux term, as in JAX), so a flash-length batch stays one."""
    logits, aux = forward(params, tokens, cfg, attn_fn=attn_fn, remat=remat,
                          return_aux=True, moe_mesh=moe_mesh)
    targets = tokens[:, 1:]
    loss = token_nll_sum(logits[:, :-1], targets) / targets.numel()
    if cfg.moe:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


# ----- KV cache / generation ----------------------------------------------


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature, top_k: int, top_p: float = 0.0) -> torch.Tensor:
    """Temperature sampling from ``[B, vocab]`` fp32 logits, optionally cut
    to the ``top_k`` most likely tokens and then to the smallest nucleus
    whose probability mass reaches ``top_p`` (the argmax token is always
    kept). ``temperature`` is a float or a 0-dim tensor on the logits'
    device. The draw is the JAX package's: the argmax of the filtered
    logits plus Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)`` from ``generator``. It runs on the device with no host
    sync, so a CUDA graph can capture it (with ``generator`` registered on
    the graph)."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if 0.0 < top_p < 1.0:  # 1.0 keeps everything: skip the vocabulary sort
        # Descending order as JAX forms it (a stable ascending sort,
        # flipped), so ties at the nucleus edge fall the same way.
        order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        srt = torch.gather(logits, -1, order)
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the tokens whose mass BEFORE them is < top_p: the smallest
        # prefix reaching top_p, never empty. Scattering the sorted mask
        # back keeps EXACTLY that prefix; a threshold on the logit would
        # also keep tokens tied with the edge.
        keep = torch.zeros_like(cum, dtype=torch.bool).scatter_(
            -1, order, (cum - probs) < top_p)
        logits = logits.masked_fill(~keep, NEG_INF)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def _next_token(logits, generator, do_sample: bool, temperature, top_k: int,
                top_p: float = 0.0) -> torch.Tensor:
    """The one sample-or-greedy dispatch of prefill, decode and generate."""
    return (sample_token(logits, generator, temperature, top_k, top_p)
            if do_sample else greedy_token(logits))


def _sampling_args(temperature, top_k: int, generator,
                   top_p: float = 0.0) -> bool:
    """Whether to sample, with the JAX package's checks: sampling needs an
    explicit generator, top-k and top-p need a temperature, top-p lies in
    [0, 1]."""
    do_sample = not (isinstance(temperature, (int, float)) and temperature == 0.0)
    if do_sample and generator is None:
        raise ValueError(
            "temperature > 0 requires an explicit torch.Generator — a silent "
            "default would return the identical 'sample' on every call")
    if not do_sample and (top_k > 0 or top_p > 0.0):
        raise ValueError(
            "top_k/top_p sampling requires temperature > 0 (greedy decoding "
            "would silently ignore them)")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    return do_sample


def _kv_stack(cfg: DecoderConfig, layers: int, batch: int, length: int, *,
              device, dtype=None, quantized: bool = False):
    """One cache pair ``[layers, batch, length, KV, D]``, zeros; int8
    :class:`QTensor` pairs with fp32 scales ``[..., 1]`` when
    ``quantized``."""
    shape = (layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        def one():
            return QTensor(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                       device=device))
        return one(), one()
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_caches(cfg: DecoderConfig, batch: int, max_len: int, *,
                   device, dtype=None, quantized: bool = False):
    """Stacked caches ``[L, B, max_len, KV, D]``; ``quantized=True`` makes
    int8 :class:`QTensor` caches with fp32 scales ``[L, B, max_len, KV, 1]``."""
    return _kv_stack(cfg, cfg.n_layers, batch, max_len, device=device,
                     dtype=dtype, quantized=quantized)


def init_cycle_kv_caches(cfg: DecoderConfig, batch: int, max_len: int, *,
                         device, dtype=None, quantized: bool = False,
                         margin: int = 0) -> tuple:
    """The cycle arena of a window cycle of P positions (Gemma-2's
    alternating local and global layers), zeros: a tuple of P cache pairs,
    pair p ``[L/P, B, len_p, KV, D]`` holding layers ``p, p+P, ...``, where
    ``len_p`` is position p's window plus ``margin`` when it is windowed
    (a ring, :func:`ring_caches_from_prefill`) and ``max_len`` when it is
    global. This is the JAX package's cycle tuple leaf for leaf: its
    ``[L/P, B, len_i, KV, D]`` stacks are these pairs, and layer i of the
    model is entry ``i // P`` of pair ``i % P``, so every layer keeps its
    own length. ``margin`` adds speculative verification's safety slots to
    each ring."""
    P = len(cfg.window_cycle)
    return tuple(
        _kv_stack(cfg, cfg.n_layers // P, batch,
                  w + margin if w > 0 else max_len, device=device,
                  dtype=dtype, quantized=quantized)
        for w in cfg.window_cycle)


def ring_positions(pos: torch.Tensor, window: int) -> torch.Tensor:
    """The absolute position each slot of a ``window``-slot ring holds after
    positions up to ``pos`` were written (slot = position % window): the
    latest position ≡ s (mod window) at or below ``pos``, negative for a
    slot never written. ``pos`` is a 0-dim tensor (``[window]`` out) or
    ``[B, 1]`` (``[B, window]`` out)."""
    s = torch.arange(window, dtype=pos.dtype, device=pos.device)
    return pos - torch.remainder(pos - s, window)


def _map_pair(fn, caches) -> tuple:
    """``fn`` on every tensor of a cache pair, QTensor payload and scale
    alike, the structure kept."""
    return tuple(QTensor(*map(fn, c)) if isinstance(c, QTensor) else fn(c)
                 for c in caches)


def ring_caches_from_prefill(caches, pos, window: int) -> tuple:
    """Fold a prefill's cache pair (leaves ``[L, B, S, ...]``, positions 0
    .. pos-1 written) into a ring of ``window`` slots: slot s takes the
    latest position ≡ s (mod window) below ``pos``, and a slot with no such
    position is zero (its ring position is negative: never attended). A
    gather and a select: bit-exact, int8 payloads with their scales."""
    ref = (caches[0].q if isinstance(caches[0], QTensor) else caches[0])
    # A host position fills a device scalar (no host-to-card copy to wait for).
    pos = (pos.to(device=ref.device, dtype=torch.int64) if torch.is_tensor(pos)
           else torch.full((), int(pos), dtype=torch.int64, device=ref.device))
    src = ring_positions(pos - 1, window)  # [window]
    valid = src >= 0
    idx = src.clamp_min(0)

    def fold(c):
        g = c.index_select(2, idx)
        mask = valid.reshape((1, 1, window) + (1,) * (g.ndim - 3))
        return torch.where(mask, g, torch.zeros_like(g))

    return _map_pair(fold, caches)


def cycle_ring_caches_from_prefill(caches, pos, cfg: DecoderConfig,
                                   max_len: int, margin: int = 0) -> tuple:
    """Split a prefill's cache pair (leaves ``[L, B, S, ...]``) into the
    cycle arena (:func:`init_cycle_kv_caches`): position p's layers
    (``p::P``) fold into a ring of ``w_p + margin`` slots when windowed
    (:func:`ring_caches_from_prefill`) or pad with zeros to ``max_len``
    when global."""
    P = len(cfg.window_cycle)
    arena = []
    for p, w in enumerate(cfg.window_cycle):
        sub = _map_pair(lambda a, p=p: a[p::P], caches)
        if w > 0:
            arena.append(ring_caches_from_prefill(sub, pos, w + margin))
        else:
            def pad(c):
                full = c.new_zeros(c.shape[:2] + (max_len,) + c.shape[3:])
                full[:, :, :c.shape[2]] = c
                return full

            arena.append(_map_pair(pad, sub))
    return tuple(arena)


def fold_prefill(caches, pos, cfg: DecoderConfig, max_len: int,
                 margin: int = 0) -> tuple:
    """A prefill's cache pair folded for ``ring_kv``: the cycle arena
    (:func:`cycle_ring_caches_from_prefill`) for a window cycle, else a
    ring of the window plus ``margin`` slots
    (:func:`ring_caches_from_prefill`)."""
    if len(cfg.window_cycle) > 1:
        return cycle_ring_caches_from_prefill(caches, pos, cfg, max_len, margin)
    return ring_caches_from_prefill(caches, pos, cfg.window_cycle[0] + margin)


def _last_logits(params, x, rows_at, cfg) -> torch.Tensor:
    """fp32 logits of ``x [B, S, d]`` at position ``rows_at[b]`` of each row
    only: the rows are independent, so the other S-1 rows' unembedding (a
    ``[B, S, vocab]`` fp32 tensor at full vocabulary) is never computed."""
    B = x.shape[0]
    picked = x[torch.arange(B, device=x.device), rows_at.long().to(x.device)]
    return unembed(params, picked[:, None, :], cfg)[:, 0, :]


def prefill(params: Params, prompt: torch.Tensor, cfg: DecoderConfig,
            max_len: int, attn_fn: Optional[AttnFn] = None,
            return_logits: bool = False, kv_quantized: bool = False,
            true_len: Optional[int] = None):
    """Prefill ``prompt [B, S]`` into fresh caches of ``max_len``. Returns
    ``(caches, next_token_or_logits, pos)``; ``true_len`` takes the logits of
    a right-padded prompt at ``true_len - 1`` and returns pos = true_len."""
    B, S = prompt.shape
    pos = S if true_len is None else int(true_len)
    caches = init_kv_caches(cfg, B, max_len, device=prompt.device,
                            quantized=kv_quantized)
    x = _hidden(params, prompt, cfg, attn_fn, None, caches, 0, True, None)
    last = _last_logits(params, x, torch.full((B,), pos - 1), cfg)
    if not return_logits:
        last = greedy_token(last)
    return caches, last, pos


def prefill_batch(params: Params, prompts: torch.Tensor, cfg: DecoderConfig,
                  max_len: int, true_lens: torch.Tensor,
                  attn_fn: Optional[AttnFn] = None, return_logits: bool = True,
                  kv_quantized: bool = False):
    """Batched admission: N right-padded prompts ``[N, S]`` with ``[N]`` true
    lengths in one forward. Returns ``(caches, last [N, vocab], pos [N])``;
    each row equals its own single-row prefill."""
    N, _ = prompts.shape
    caches = init_kv_caches(cfg, N, max_len, device=prompts.device,
                            quantized=kv_quantized)
    x = _hidden(params, prompts, cfg, attn_fn, None, caches, 0, True, None)
    pos = true_lens.to(device=prompts.device, dtype=torch.int32)
    last = _last_logits(params, x, pos - 1, cfg)
    if not return_logits:
        last = greedy_token(last)
    return caches, last, pos


def prefill_suffix(params: Params, suffix: torch.Tensor, cfg: DecoderConfig,
                   caches, offset, attn_fn: Optional[AttnFn] = None,
                   return_logits: bool = False, true_len=None):
    """Resume a prefill from caches that already hold rows ``[0, offset)``:
    ``suffix [B, S]`` runs with rope positions ``offset + i`` and writes
    its k/v at ``offset + i`` (in place), each token attending to the
    resident rows and the causal part of the suffix, the window it saw in
    one whole prefill. ``offset`` is an int or a 0-dim tensor. Returns
    ``(caches, next_token_or_logits, pos)`` as :func:`prefill` does.

    ``true_len`` (an int, a 0-dim tensor or a ``[B]`` tensor) marks a
    right-padded suffix: logits are taken at suffix index ``true_len - 1``
    and ``pos`` is ``offset + true_len``; the pad rows land at positions
    decode overwrites before it reads them. Chainable: a call at ``offset
    + true_len`` with the next slice of the prompt resumes where this one
    stopped, and the slices together give one prefill's caches and logits
    (the chunked admission of ``guest.scheduler``).

    The span reads the cache back, so by the JAX rule (no flash kernel
    once ``q_offset`` is set) the default ``attn_fn``,
    :func:`..ops.attention.cache_attention`, takes the plain attention
    over the dequantized cache on every device."""
    if attn_fn is None:
        from ..ops.attention import cache_attention

        attn_fn = cache_attention
    B, S = suffix.shape
    dev = suffix.device
    if torch.is_tensor(offset):
        offset = offset.to(device=dev, dtype=torch.int32).reshape(())
    span = torch.arange(S, dtype=torch.int32, device=dev) + offset
    x = _hidden(params, suffix, cfg, attn_fn, span.expand(B, S), caches,
                offset, False, None)
    if true_len is None:
        true_len = S
    # A host int fills a device scalar: copying it to the card would make
    # the host wait (strict mode's guard), and a fused slice runs inside
    # the guarded decode dispatch.
    tl = (true_len.to(device=dev, dtype=torch.int32) if torch.is_tensor(true_len)
          else torch.full((), int(true_len), dtype=torch.int32, device=dev))
    last = _last_logits(params, x, (tl - 1).expand(B), cfg)
    if not return_logits:
        last = greedy_token(last)
    pos = offset + true_len
    return caches, last, pos


def _decode_scan(params: Params, caches, tok: torch.Tensor, pos,
                 cfg: DecoderConfig, steps: int,
                 attn_fn: Optional[AttnFn] = None, return_state: bool = False,
                 decode_kernel_fn=None, eos_id: Optional[int] = None,
                 budget: Optional[torch.Tensor] = None, block_tables=None,
                 block_size: int = 0, paged_len: int = 0,
                 do_sample: bool = False, top_k: int = 0, temperature=None,
                 generator: Optional[torch.Generator] = None,
                 top_p: float = 0.0, ring: bool = False):
    """Decode of ``steps`` tokens after ``tok [B]`` (a Python loop in place
    of ``lax.scan``), greedy, or sampled from ``generator`` with
    ``do_sample`` (:func:`sample_token`). ``pos`` is a ``[B]`` tensor of per-lane
    positions (ragged decode; with ``block_tables`` over the paged pool) or
    a scalar (an int or a 0-dim tensor): lock-step decode, every row at the
    same position, which stays a device scalar through the loop.
    ``budget [B]`` (ragged only) arms the freeze mask: a lane that has
    emitted its budget (or ``eos_id``) pins its token and position, so
    later steps rewrite the same k/v. ``ring``: the caches are rings or a
    cycle arena (:func:`forward`). Returns ``[B, steps]`` tokens, with
    ``return_state`` also ``(caches, last_token, pos)``."""
    B = tok.shape[0]
    dev = tok.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    ragged = pos.ndim == 1
    if budget is not None and not ragged:
        raise ValueError("budget masking is per lane: it needs a [B] pos")
    rem = None if budget is None else budget.to(device=dev, dtype=torch.int32)
    outs = []
    for _ in range(steps):
        logits, caches = forward(
            params, tok[:, None], cfg, attn_fn=attn_fn,
            positions=pos[:, None] if ragged else pos.expand(B, 1),
            kv_caches=caches, cache_offset=pos,
            decode_kernel_fn=decode_kernel_fn, block_tables=block_tables,
            block_size=block_size, paged_len=paged_len, ring=ring)
        nxt = _next_token(logits[:, -1, :], generator, do_sample, temperature,
                          top_k, top_p)
        if rem is not None:
            alive = rem > 0
            nxt = torch.where(alive, nxt, tok)
            pos = torch.where(alive, pos + 1, pos)
            rem = torch.where(alive, rem - 1, rem)
            if eos_id is not None:
                rem = torch.where(alive & (nxt == eos_id), 0, rem)
        else:
            pos = pos + 1
        tok = nxt
        outs.append(nxt)
    out = torch.stack(outs, dim=1) if outs else torch.zeros(
        (B, 0), dtype=torch.int32, device=dev)
    return (out, caches, tok, pos) if return_state else out


# ----- persistent rounds ---------------------------------------------------


def persistent_state(tok: torch.Tensor, pos: torch.Tensor, budget: torch.Tensor,
                     window_end: torch.Tensor, max_steps: int) -> dict:
    """The carry of a persistent round, fresh tensors on ``tok``'s device:
    ``tok``/``pos``/``rem`` (the budget) per lane, ``alive0`` (the lanes
    alive at entry), ``window`` (each lane's write bound), ``out [B,
    max_steps]`` zeros, and the 0-dim ``delivered`` count and ``stop``
    flag. :func:`_persistent_steps` updates every entry in place."""
    dev = tok.device
    B = tok.shape[0]

    def i32(t):
        return torch.as_tensor(t).to(device=dev, dtype=torch.int32).clone()

    rem = i32(budget)
    return {"tok": i32(tok), "pos": i32(pos), "rem": rem,
            "alive0": rem > 0, "window": i32(window_end),
            "out": torch.zeros((B, max_steps), dtype=torch.int32, device=dev),
            "delivered": torch.zeros((), dtype=torch.int32, device=dev),
            "stop": torch.zeros((), dtype=torch.bool, device=dev)}


def _persistent_go(state: dict, max_steps: int) -> torch.Tensor:
    """The loop condition of JAX's ``_decode_while``, a 0-dim bool on the
    device: fewer than ``max_steps`` delivered, some lane alive, no lane
    alive at entry frozen since (a freeze needs the host), and no live
    lane's next write at or past its window."""
    alive = state["rem"] > 0
    return ((state["delivered"] < max_steps) & alive.any()
            & (~state["alive0"] | alive).all()
            & ~(alive & (state["pos"] >= state["window"])).any())


def _persistent_steps(params: Params, caches, state: dict, cfg: DecoderConfig,
                      steps: int, max_steps: int,
                      attn_fn: Optional[AttnFn] = None, decode_kernel_fn=None,
                      block_tables=None, block_size: int = 0,
                      paged_len: int = 0, eos_id: Optional[int] = None) -> None:
    """``steps`` greedy steps of a persistent round, in place on ``state``
    (:func:`persistent_state`) and the caches, with no host sync, so a
    CUDA graph can hold them. Each step first evaluates the loop condition
    (:func:`_persistent_go`) on the device and folds it into the freeze
    mask: while it holds, the step is :func:`_decode_scan`'s masked step
    and is delivered (its tokens land in ``out[:, delivered]``); once it
    fails, every lane is frozen, so the step rewrites each lane's k/v at
    its pinned position with the value the lane's next real step writes
    there, and changes nothing else. The condition never holds again
    after it fails, so a caller may run steps past the loop's exit. Sets
    ``state["stop"]`` to whether the condition fails after the last
    step."""
    tok, pos, rem, out = state["tok"], state["pos"], state["rem"], state["out"]
    delivered = state["delivered"]
    B = tok.shape[0]
    for _ in range(steps):
        go = _persistent_go(state, max_steps)
        live = (rem > 0) & go
        logits, caches = forward(
            params, tok[:, None], cfg, attn_fn=attn_fn, positions=pos[:, None],
            kv_caches=caches, cache_offset=pos,
            decode_kernel_fn=decode_kernel_fn, block_tables=block_tables,
            block_size=block_size, paged_len=paged_len)
        nxt = torch.where(live, greedy_token(logits[:, -1, :]), tok)
        new_rem = torch.where(live, rem - 1, rem)
        if eos_id is not None:
            new_rem = torch.where(live & (nxt == eos_id), 0, new_rem)
        col = delivered.clamp(max=max_steps - 1).long().reshape(1, 1).expand(B, 1)
        out.scatter_(1, col, torch.where(go, nxt, out.gather(1, col)[:, 0])[:, None])
        pos.copy_(torch.where(live, pos + 1, pos))
        rem.copy_(new_rem)
        tok.copy_(nxt)
        delivered.add_(go.to(torch.int32))
    state["stop"].copy_(~_persistent_go(state, max_steps))


def _decode_while(params: Params, caches, tok: torch.Tensor, pos: torch.Tensor,
                  budget: torch.Tensor, window_end: torch.Tensor,
                  cfg: DecoderConfig, max_steps: int,
                  attn_fn: Optional[AttnFn] = None, block_tables=None,
                  block_size: int = 0, paged_len: int = 0,
                  decode_kernel_fn=None, eos_id: Optional[int] = None,
                  sub_steps: int = 1):
    """A persistent decode round (JAX ``_decode_while``): the masked greedy
    step of :func:`_decode_scan`, run until one of three exits — ``cap``,
    ``max_steps`` delivered; ``done``, a lane alive at entry froze on eos
    or its ``budget``; ``window``, a live lane's next write would reach
    its ``window_end``. Steps run ``sub_steps`` at a time
    (:func:`_persistent_steps`) with the exit flag read on the host after
    each group, so up to ``sub_steps - 1`` steps run past the exit as
    no-ops. Each delivered step equals the fixed-step scan's. Returns
    ``(out [B, max_steps], caches, tok, pos, delivered)``; ``out`` is
    zero past ``delivered``."""
    state = persistent_state(tok, pos, budget, window_end, max_steps)
    state["stop"].copy_(~_persistent_go(state, max_steps))
    while not bool(state["stop"]):
        _persistent_steps(params, caches, state, cfg, sub_steps, max_steps,
                          attn_fn=attn_fn, decode_kernel_fn=decode_kernel_fn,
                          block_tables=block_tables, block_size=block_size,
                          paged_len=paged_len, eos_id=eos_id)
    return state["out"], caches, state["tok"], state["pos"], state["delivered"]


def decode(params: Params, caches, tok: torch.Tensor, pos, cfg: DecoderConfig,
           steps: int, attn_fn: Optional[AttnFn] = None,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
           generator: Optional[torch.Generator] = None,
           return_state: bool = False, ring: bool = False,
           decode_kernel_fn=None):
    """Decode ``steps`` tokens after ``tok [B]`` from ``caches`` (written
    in place). Returns ``[B, steps]``, with ``return_state=True``
    ``(tokens, caches, last_token, pos)`` so that a caller can continue.
    ``pos`` is a scalar (every row at one position, lock-step) or a ``[B]``
    tensor of per-row positions (ragged). Greedy by default;
    ``temperature``/``top_k``/``top_p`` sample from ``generator``.

    ``ring=True``: ``caches`` are rings of the window's slots
    (:func:`ring_caches_from_prefill`), or, with a window cycle, the cycle
    arena (:func:`cycle_ring_caches_from_prefill`); a ring wraps, so no
    length bound applies, and its reads take the plain attention whatever
    ``attn_fn`` is. Without a ring, ``pos + steps`` must fit the caches.
    On CUDA with neither ``attn_fn`` nor ``decode_kernel_fn`` given, a
    config with a sliding window or an attention-logit softcap decodes
    with the plain attention (the JAX rule :func:`generate` follows);
    otherwise the default dispatch takes the dense decode kernel under
    ``KATA_TPU_DECODE_KERNEL=1`` or raises."""
    if not ring:
        c0 = caches[0]
        cache_len = (c0.q if isinstance(c0, QTensor) else c0).shape[2]
        if steps > cache_len:
            raise ValueError(f"steps={steps} exceeds cache max_len={cache_len}")
        if not torch.is_tensor(pos) or pos.ndim == 0:
            start = int(pos)
            if start + steps > cache_len:
                raise ValueError(f"pos={start} + steps={steps} overruns cache "
                                 f"max_len={cache_len}")
    do_sample = _sampling_args(temperature, top_k, generator, top_p)
    dev = tok.device
    if (dev.type == "cuda" and attn_fn is None and decode_kernel_fn is None):
        from ..ops.attention import decode_kernel_conflict, reference_attention

        if decode_kernel_conflict(cfg) is not None:
            attn_fn = reference_attention
    temp = (torch.full((), float(temperature), dtype=torch.float32, device=dev)
            if do_sample else None)
    return _decode_scan(params, caches, tok, pos, cfg, steps, attn_fn,
                        return_state=return_state,
                        decode_kernel_fn=decode_kernel_fn, do_sample=do_sample,
                        top_k=top_k, temperature=temp, generator=generator,
                        top_p=top_p, ring=ring)


def generate(params: Params, prompt, cfg: DecoderConfig, steps: int,
             max_len: int = 0, attn_fn: Optional[AttnFn] = None,
             kv_quantized: bool = False, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device=None, ring_kv: bool = False) -> torch.Tensor:
    """Generation: :func:`prefill` then :func:`_decode_scan`, greedy by
    default; ``temperature``/``top_k``/``top_p`` sample instead, from
    ``generator`` (a ``torch.Generator`` on ``device``; sampling without one
    raises). Returns ``[B, steps]`` int32 tokens on ``device`` (CUDA unless
    the caller says otherwise; the params must already live there).

    On CUDA with the default ``attn_fn`` the kernels run: the prompt is
    right-padded to a multiple of :data:`CUDA_PAD` (a flash-kernel
    length; the pad rows' k/v are overwritten by decode before they are
    attended to) and the caches are allocated to a multiple of it, so
    every decode step takes the paged decode kernel over them, or, under
    ``KATA_TPU_DECODE_KERNEL=1``, the lock-step dense decode kernel (one
    device-scalar position for the whole batch; bf16 caches only). A
    config with a sliding window or an attention-logit softcap decodes
    with the plain attention, which models both (the decode kernels do
    not: the JAX package's rule). Outputs are those of the unpadded run.
    An explicit ``attn_fn`` runs everywhere, kernels or not.

    ``ring_kv=True`` (a config with a sliding window) prefills the prompt
    into caches of its own (padded) length, then folds them into rings of
    the window's slots (:func:`ring_caches_from_prefill`), or, with a
    window cycle, into the cycle arena, whose global layers keep
    ``max_len`` (:func:`cycle_ring_caches_from_prefill`); decode then wraps
    in the rings, so ``max_len`` bounds only global layers."""
    do_sample = _sampling_args(temperature, top_k, generator, top_p)
    device = resolve_device(device)
    if params["embed"].device != device:
        raise ValueError(
            f"params live on {params['embed'].device}, generate runs on {device}"
        )
    if ring_kv and not any(w > 0 for w in cfg.window_cycle):
        raise ValueError(
            "ring_kv needs a sliding-window config (cfg.sliding_window > 0 "
            "or a windowed attn_windows cycle) — a global-attention model "
            "must keep its whole prefix")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    B, S = prompt.shape
    max_len = max_len or S + steps
    if ((not ring_kv or any(w == 0 for w in cfg.window_cycle))
            and S + steps > max_len):
        raise ValueError(f"prompt_len={S} + steps={steps} overruns max_len={max_len}")
    decode_kernel_fn, true_len, lockstep = None, None, False
    decode_attn_fn = attn_fn
    if device.type == "cuda" and attn_fn is None:
        from ..ops.attention import (
            decode_eligible,
            decode_kernel_conflict,
            make_decode_attn_fn,
            reference_attention,
        )

        pad = -(-S // CUDA_PAD) * CUDA_PAD
        max_len = -(-max(max_len, pad) // CUDA_PAD) * CUDA_PAD
        prompt = F.pad(prompt, (0, pad - S))
        true_len = S
        masked = decode_kernel_conflict(cfg) is not None
        lockstep = not masked and decode_eligible(1, max_len, cfg.head_dim, True,
                                                  0, on_cuda=True)
        if lockstep and kv_quantized:
            raise ValueError(
                "the dense decode kernel reads a bf16 cache in place: "
                "KATA_TPU_DECODE_KERNEL=1 does not combine with kv_quantized")
        if masked:
            decode_attn_fn = reference_attention
        elif not lockstep:
            decode_kernel_fn = make_decode_attn_fn(cfg, arena_len=max_len,
                                                   device=device)
    temp = None
    if do_sample:
        temp = torch.full((), float(temperature), dtype=torch.float32,
                          device=device)
    caches, last_logits, pos = prefill(
        params, prompt, cfg, prompt.shape[1] if ring_kv else max_len,
        attn_fn=attn_fn, return_logits=True, kv_quantized=kv_quantized,
        true_len=true_len)
    if ring_kv:
        caches = fold_prefill(caches, pos, cfg, max_len)
    last = _next_token(last_logits, generator, do_sample, temp, top_k, top_p)
    if steps == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=device)
    if not lockstep:
        pos = torch.full((B,), pos, dtype=torch.int32, device=device)
    rest = _decode_scan(params, caches, last, pos, cfg, steps - 1,
                        decode_attn_fn, decode_kernel_fn=decode_kernel_fn,
                        do_sample=do_sample, top_k=top_k, temperature=temp,
                        generator=generator, top_p=top_p, ring=ring_kv)
    return torch.cat([last[:, None], rest], dim=1)
