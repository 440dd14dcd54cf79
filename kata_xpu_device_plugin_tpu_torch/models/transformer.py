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
same tensors they were given.

Families' extra flags that are not ported yet (qkv bias, qk-norm,
post-norms, window and rope cycles, MoE, ring caches, sampling) raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import resolve_device
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
    def window_cycle(self) -> tuple:
        return self.attn_windows or (self.sliding_window,)


_UNPORTED_FLAGS = (
    ("attn_windows", "per-layer window cycles"),
    ("post_norms", "post-sublayer norms"),
    ("qkv_bias", "qkv biases"),
    ("qk_norm", "qk-norm"),
    ("rope_theta_cycle", "rope cycles"),
    ("rope_linear_cycle", "rope cycles"),
    ("moe_num_experts", "MoE"),
)


def check_supported(cfg: DecoderConfig) -> None:
    """Raise on a config flag this slice of the port does not model."""
    for name, what in _UNPORTED_FLAGS:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"{what} ({name}) are not ported yet (ROADMAP Queue 1)"
            )
    if cfg.activation not in ("geglu", "swiglu"):
        raise ValueError(f"unknown activation {cfg.activation!r}")


def tiny_test_config(**overrides) -> DecoderConfig:
    """A shapes-only config for CPU tests: 2 KV heads for GQA."""
    base = DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
                         n_kv_heads=2, head_dim=16, d_ff=128)
    return replace(base, **overrides)


# ----- initialization ------------------------------------------------------


def init_params(cfg: DecoderConfig, *, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Stacked-layer parameters with the JAX package's distributions:
    matrices normal / sqrt(fan_in), norm scales at ones (``rms_norm``
    multiplies by 1 + scale, so a fresh model scales by 2). Drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w / float(np.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    L, d = cfg.n_layers, cfg.d_model
    layers = {
        "attn_norm": ones(L, d),
        "wq": dense((L, d, cfg.q_dim), d),
        "wk": dense((L, d, cfg.kv_dim), d),
        "wv": dense((L, d, cfg.kv_dim), d),
        "wo": dense((L, cfg.q_dim, d), cfg.q_dim),
        "mlp_norm": ones(L, d),
        "w_gate": dense((L, d, cfg.d_ff), d),
        "w_up": dense((L, d, cfg.d_ff), d),
        "w_down": dense((L, cfg.d_ff, d), cfg.d_ff),
    }
    params = {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense((d, cfg.vocab_size), d)
    return params


def fuse_decoder_params(params: Params) -> Params:
    """Inference layout: ``wqkv [L, d, q+2kv]`` and ``w_gateup [L, d, 2f]``
    replace the separate projections (one matmul each instead of three and
    two). The separate tensors are dropped from the result."""
    layers = params["layers"]
    if "wqkv" in layers:
        return params
    if any(isinstance(v, QTensor) for v in layers.values()):
        raise ValueError("fuse before quantizing: fusing concatenates raw matrices")
    fused = {k: v for k, v in layers.items()
             if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
    fused["wqkv"] = torch.cat([layers["wq"], layers["wk"], layers["wv"]], dim=2)
    fused["w_gateup"] = torch.cat([layers["w_gate"], layers["w_up"]], dim=2)
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
         llama3_scaling: tuple = ()) -> torch.Tensor:
    """Rotary embedding in fp32 on the half-split layout. x ``[B, S, H, D]``,
    positions ``[B, S]``. ``llama3_scaling`` = (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings) applies the
    Llama-3.1 per-band frequency rescale."""
    d = x.shape[-1]
    exps = torch.arange(0, d // 2, dtype=torch.float32, device=x.device) * (2.0 / d)
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                         -exps)
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
    dtype first (bf16 45.25 at d_model 2048)."""
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.scale_embeddings:
        s = torch.tensor(float(np.sqrt(np.float32(cfg.d_model))),
                         dtype=torch.float32, device=x.device).to(cfg.dtype)
        x = x * s
    return x


def unembed(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Final norm, then the (tied) unembedding with fp32 logits from
    operands of the model dtype, then the optional final softcap."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    proj = (params["embed"].t() if cfg.tie_embeddings
            else params["unembed"]).to(cfg.dtype)
    logits = matmul_f32(x, proj)
    if cfg.logits_softcap:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits


# ----- forward pass --------------------------------------------------------


def _index(leaf, i: int):
    if isinstance(leaf, QTensor):
        return QTensor(leaf.q[i], leaf.scale[i])
    return leaf[i]


def _unbind(leaf) -> list:
    """Per-layer views of a stacked leaf. One ``unbind`` per leaf: its
    backward stacks the layers' gradients once, where indexing layer by
    layer would add each into a fresh full-size zero tensor."""
    if isinstance(leaf, QTensor):
        return [QTensor(q, s) for q, s in zip(leaf.q.unbind(0), leaf.scale.unbind(0))]
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


def _cache_write_rows(cache, x: torch.Tensor, idx: torch.Tensor) -> None:
    """Ragged write: row b's S vectors land at positions ``idx[b] ..
    idx[b]+S-1``, each clamped to max_len-1 (a lane past its budget
    scribbles on its own last entry, which is never read)."""
    B, S = x.shape[:2]
    max_len = (cache.q if isinstance(cache, QTensor) else cache).shape[1]
    span = idx.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    cols = torch.clamp(span, max=max_len - 1)
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


def _layer(cfg: DecoderConfig, attn_fn: AttnFn, x: torch.Tensor, layer: Params,
           positions: torch.Tensor, kv_cache=None, cache_offset=None,
           prefill: bool = False, decode_kernel_fn=None, block_tables=None,
           view_tables=None, block_size: int = 0,
           paged_len: int = 0) -> torch.Tensor:
    """One decoder block, x ``[B, S, d]``. With a cache: ``prefill=True``
    writes the fresh k/v at 0 and attends over them alone (self-attention,
    flash-kernel eligible). With ``block_tables`` the cache pair is this
    layer's ``[1, NT, KV, D]`` slice of the shared block pool and
    ``cache_offset [B]`` the lanes' positions: writes go through the raw
    table, reads through ``view_tables`` (SCRATCH remapped to ZERO).
    Otherwise a ``[B]`` ``cache_offset`` is ragged decode over a slotted
    cache (a single-token step goes through ``decode_kernel_fn`` when the
    server built one), and a scalar one (an int or a 0-dim tensor) is
    lock-step decode: every row writes and attends at the same position."""
    B, S, _ = x.shape
    akw = {}
    if cfg.sliding_window:
        akw["window"] = cfg.sliding_window
    if cfg.attn_logits_softcap:
        akw["logits_softcap"] = cfg.attn_logits_softcap
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    if "wqkv" in layer:
        qkv = weight_matmul(h, layer["wqkv"])
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim: cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q = weight_matmul(h, layer["wq"])
        k = weight_matmul(h, layer["wk"])
        v = weight_matmul(h, layer["wv"])
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_llama3_scaling)

    if kv_cache is not None and prefill:
        ck, cv = kv_cache
        _cache_write_full(ck, k, 0)
        _cache_write_full(cv, v, 0)
        attn_out = attn_fn(q, k, v, causal=True, q_offset=None, **akw)
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
                attn_out = decode_kernel_fn(q, ck, cv, view_tables,
                                            cache_offset)
            else:
                attn_out = decode_kernel_fn(
                    q, ck, cv, view_tables, cache_offset + (S - 1),
                    torch.full((B,), S, dtype=torch.int32, device=x.device))
        else:
            view_idx = (
                (view_tables.long() * bs)[:, :, None]
                + torch.arange(bs, device=x.device)[None, None, :]
            ).reshape(B, -1)[:, :paged_len]
            attn_out = attn_fn(
                q, dequantize_kv(_paged_view(ck, view_idx), x.dtype),
                dequantize_kv(_paged_view(cv, view_idx), x.dtype),
                causal=True, q_offset=cache_offset, **akw)
    elif (kv_cache is not None and torch.is_tensor(cache_offset)
          and cache_offset.ndim == 1):
        ck, cv = kv_cache
        _cache_write_rows(ck, k, cache_offset)
        _cache_write_rows(cv, v, cache_offset)
        if decode_kernel_fn is not None and S == 1:
            attn_out = decode_kernel_fn(q, ck, cv, None, cache_offset)
        else:
            attn_out = attn_fn(q, dequantize_kv(ck, x.dtype),
                               dequantize_kv(cv, x.dtype), causal=True,
                               q_offset=cache_offset, **akw)
    elif kv_cache is not None:
        # Lock-step decode: one position for every row. On CUDA the default
        # attn_fn sends a bf16 cache to the dense decode kernel when
        # ops.attention.decode_eligible allows it.
        ck, cv = kv_cache
        _cache_write_full(ck, k, cache_offset)
        _cache_write_full(cv, v, cache_offset)
        attn_out = attn_fn(q, dequantize_kv(ck, x.dtype),
                           dequantize_kv(cv, x.dtype), causal=True,
                           q_offset=cache_offset, **akw)
    else:
        attn_out = attn_fn(q, k, v, causal=True, q_offset=None, **akw)

    x = x + weight_matmul(attn_out.reshape(B, S, cfg.q_dim), layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if "w_gateup" in layer:
        gu = weight_matmul(h, layer["w_gateup"])
        act = _gate_act(gu[..., : cfg.d_ff], cfg.activation) * gu[..., cfg.d_ff:]
    else:
        act = (_gate_act(weight_matmul(h, layer["w_gate"]), cfg.activation)
               * weight_matmul(h, layer["w_up"]))
    return x + weight_matmul(act, layer["w_down"])


def _hidden(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            attn_fn: Optional[AttnFn], positions, kv_caches, cache_offset,
            prefill: bool, decode_kernel_fn, remat: bool = False,
            block_tables=None, block_size: int = 0,
            paged_len: int = 0) -> torch.Tensor:
    """The decoder stack up to (not including) the final norm. ``remat``
    (training, no caches) checkpoints each layer: its activations are
    recomputed in the backward instead of kept."""
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
    layers = {k: _unbind(v) for k, v in params["layers"].items()}
    for i in range(cfg.n_layers):
        layer = {k: v[i] for k, v in layers.items()}
        if remat and kv_caches is None:
            x = torch.utils.checkpoint.checkpoint(
                _layer, cfg, attn_fn, x, layer, positions, use_reentrant=False)
            continue
        cache = None
        if kv_caches is not None:
            cache = (_index(kv_caches[0], i), _index(kv_caches[1], i))
        x = _layer(cfg, attn_fn, x, layer, positions, cache, cache_offset,
                   prefill=prefill, decode_kernel_fn=decode_kernel_fn,
                   block_tables=block_tables, view_tables=view_tables,
                   block_size=block_size, paged_len=paged_len)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
            attn_fn: Optional[AttnFn] = None, positions=None, kv_caches=None,
            cache_offset=None, prefill: bool = False, decode_kernel_fn=None,
            remat: bool = False, block_tables=None, block_size: int = 0,
            paged_len: int = 0):
    """tokens ``[B, S]`` → fp32 logits ``[B, S, vocab]``; with ``kv_caches``
    also returns the caches (written in place). ``block_tables [B, NB]``
    (with ``block_size`` and ``paged_len``) switches the cache branch to
    paged decode: ``kv_caches`` is the shared block pool
    (``guest.kv_arena.KVPool.arena``, leaves ``[L, 1, NT, ...]``) and each
    row reads and writes through its table. ``attn_fn`` defaults to
    :func:`..ops.attention.flash_attention`: the plain version on the CPU,
    the flash kernels (or an error) on CUDA, where a decode step needs
    ``decode_kernel_fn`` or an explicit plain ``attn_fn``. ``remat=True``
    wraps each layer in ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint``); it applies only without caches."""
    x = _hidden(params, tokens, cfg, attn_fn, positions, kv_caches,
                cache_offset, prefill, decode_kernel_fn, remat,
                block_tables=block_tables, block_size=block_size,
                paged_len=paged_len)
    logits = unembed(params, x, cfg)
    return (logits, kv_caches) if kv_caches is not None else logits


# ----- loss / training -----------------------------------------------------


def token_nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of ``targets`` under fp32 ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.sum()


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                    attn_fn: Optional[AttnFn] = None,
                    remat: bool = False) -> torch.Tensor:
    """Mean cross-entropy of predicting ``tokens[:, 1:]`` from
    ``tokens[:, :-1]``. As in the JAX package, the forward runs on the FULL
    sequence and the last position's logits are dropped (value-identical
    for dense configs under the causal mask), so a flash-length batch stays
    one. MoE configs are not ported, so there is no auxiliary term."""
    logits = forward(params, tokens, cfg, attn_fn=attn_fn, remat=remat)
    targets = tokens[:, 1:]
    return token_nll_sum(logits[:, :-1], targets) / targets.numel()


# ----- KV cache / generation ----------------------------------------------


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def init_kv_caches(cfg: DecoderConfig, batch: int, max_len: int, *,
                   device, dtype=None, quantized: bool = False):
    """Stacked caches ``[L, B, max_len, KV, D]``; ``quantized=True`` makes
    int8 :class:`QTensor` caches with fp32 scales ``[L, B, max_len, KV, 1]``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        def one():
            return QTensor(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                       device=device))
        return one(), one()
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


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


def _decode_scan(params: Params, caches, tok: torch.Tensor, pos,
                 cfg: DecoderConfig, steps: int,
                 attn_fn: Optional[AttnFn] = None, return_state: bool = False,
                 decode_kernel_fn=None, eos_id: Optional[int] = None,
                 budget: Optional[torch.Tensor] = None, block_tables=None,
                 block_size: int = 0, paged_len: int = 0):
    """Greedy decode of ``steps`` tokens after ``tok [B]`` (a Python loop in
    place of ``lax.scan``). ``pos`` is a ``[B]`` tensor of per-lane
    positions (ragged decode; with ``block_tables`` over the paged pool) or
    a scalar (an int or a 0-dim tensor): lock-step decode, every row at the
    same position, which stays a device scalar through the loop.
    ``budget [B]`` (ragged only) arms the freeze mask: a lane that has
    emitted its budget (or ``eos_id``) pins its token and position, so
    later steps rewrite the same k/v. Returns ``[B, steps]`` tokens, with
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
            block_size=block_size, paged_len=paged_len)
        nxt = greedy_token(logits[:, -1, :])
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


def generate(params: Params, prompt, cfg: DecoderConfig, steps: int,
             max_len: int = 0, attn_fn: Optional[AttnFn] = None,
             kv_quantized: bool = False, temperature: float = 0.0,
             device=None) -> torch.Tensor:
    """Greedy generation: :func:`prefill` then :func:`_decode_scan`.
    Returns ``[B, steps]`` int32 tokens on ``device`` (CUDA unless the
    caller says otherwise; the params must already live there).

    On CUDA with the default ``attn_fn`` the kernels run: the prompt is
    right-padded to a multiple of :data:`CUDA_PAD` (a flash-kernel
    length; the pad rows' k/v are overwritten by decode before they are
    attended to) and the caches are allocated to a multiple of it, so
    every decode step takes the paged decode kernel over them, or, under
    ``KATA_TPU_DECODE_KERNEL=1``, the lock-step dense decode kernel (one
    device-scalar position for the whole batch; bf16 caches only). Outputs
    are those of the unpadded run. An explicit ``attn_fn`` runs
    everywhere, kernels or not."""
    if temperature:
        raise NotImplementedError("sampling is not ported yet (ROADMAP Queue 1)")
    device = resolve_device(device)
    if params["embed"].device != device:
        raise ValueError(
            f"params live on {params['embed'].device}, generate runs on {device}"
        )
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    B, S = prompt.shape
    max_len = max_len or S + steps
    if S + steps > max_len:
        raise ValueError(f"prompt_len={S} + steps={steps} overruns max_len={max_len}")
    decode_kernel_fn, true_len, lockstep = None, None, False
    if device.type == "cuda" and attn_fn is None:
        from ..ops.attention import decode_eligible, make_decode_attn_fn

        pad = -(-S // CUDA_PAD) * CUDA_PAD
        max_len = -(-max(max_len, pad) // CUDA_PAD) * CUDA_PAD
        prompt = F.pad(prompt, (0, pad - S))
        true_len = S
        lockstep = (not cfg.sliding_window and not cfg.attn_logits_softcap
                    and decode_eligible(1, max_len, cfg.head_dim, True, 0,
                                        on_cuda=True))
        if lockstep and kv_quantized:
            raise ValueError(
                "the dense decode kernel reads a bf16 cache in place: "
                "KATA_TPU_DECODE_KERNEL=1 does not combine with kv_quantized")
        if not lockstep:
            decode_kernel_fn = make_decode_attn_fn(cfg, arena_len=max_len,
                                                   device=device)
    caches, last, pos = prefill(params, prompt, cfg, max_len, attn_fn=attn_fn,
                                kv_quantized=kv_quantized, true_len=true_len)
    if steps == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=device)
    if not lockstep:
        pos = torch.full((B,), pos, dtype=torch.int32, device=device)
    rest = _decode_scan(params, caches, last, pos, cfg, steps - 1, attn_fn,
                        decode_kernel_fn=decode_kernel_fn)
    return torch.cat([last[:, None], rest], dim=1)
