"""Speculative decoding: n-gram and draft-model drafts, greedy and sampled
(counterpart of ``kata_xpu_device_plugin_tpu/models/speculative.py``).

A greedy decode step streams every weight once for one token a row;
speculative decoding drafts ``k`` tokens cheaply and verifies them in ONE
forward over ``[B, k+1]``, so a round that accepts ``a`` drafts yields
``a + 1`` tokens from one weight stream. Greedy speculative decoding is
lossless: the tokens are those of greedy :func:`.transformer.generate`
whatever proposes the drafts; only the number of rounds changes.

Draft sources:

- **n-gram lookup**: the tokens that followed the most recent earlier
  occurrence of the current token in the row's own history (host numpy;
  free, and it lands when text repeats).
- **a draft model** (``draft=(draft_params, draft_cfg)``) sharing the
  target's vocabulary, with a cache of its own at the target's per-row
  positions. Each round's draft decode starts by writing the current
  token at the first slot the last round rejected, so the stale entries
  of rejected drafts are overwritten, or lie past the causal frontier,
  before they are read: no rollback. :func:`self_draft` cuts the target
  itself to a draft.

Verification is the decoder's ragged multi-token cache path: a ``[B,
k+1]`` span written at per-row positions, attended by the plain attention
(a span at an offset takes no flash kernel, the JAX rule). Rejected drafts'
entries stay dead until a later span overwrites them. Sampling
(temperature > 0) uses the rejection scheme of Leviathan et al. and Chen
et al.: the emitted tokens are distributed as ancestral samples from the
temperature-scaled target, and every draw comes from an explicit
``torch.Generator``. :func:`sample_accept_device` keeps the ``[B, k+1, V]``
target distribution on the device; only token ids and counts reach the
host.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.attention import NEG_INF, cache_attention
from .transformer import (
    CUDA_PAD,
    AttnFn,
    DecoderConfig,
    Params,
    _decode_scan,
    _next_token,
    forward,
    greedy_token,
    map_leaf,
    prefill,
)


def _span_forward(params, caches, toks, pos, cfg, attn_fn, ring):
    """``toks [B, S]`` at per-row cache offsets ``pos [B]``: fp32 logits
    ``[B, S, V]``, every span's k/v written in place."""
    if attn_fn is None:
        attn_fn = cache_attention
    S = toks.shape[1]
    pos = torch.as_tensor(pos).to(device=toks.device, dtype=torch.int32)
    positions = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=toks.device)[None, :]
    logits, caches = forward(params, toks, cfg, attn_fn=attn_fn,
                             positions=positions, kv_caches=caches,
                             cache_offset=pos, ring=ring)
    return logits, caches


def verify_step(params: Params, caches, toks: torch.Tensor, pos,
                cfg: DecoderConfig, attn_fn: Optional[AttnFn] = None,
                ring: bool = False):
    """Forward ``toks [B, S]`` (the current token and S-1 drafts) at per-row
    cache offsets ``pos [B]``; returns the greedy next tokens ``[B, S]``
    (``[b, j]`` follows ``toks[b, :j+1]``) and the caches, every span's k/v
    written in place (acceptance decides how many join each row's prefix;
    the caller advances ``pos``). ``ring=True``: a ring or cycle arena
    whose rings carry at least S-1 slots beyond their window. ``attn_fn``
    defaults to :func:`..ops.attention.cache_attention`: a span at an
    offset takes the plain attention on every device."""
    logits, caches = _span_forward(params, caches, toks, pos, cfg, attn_fn,
                                   ring)
    # greedy_token, as generate() picks: losslessness needs the same argmax.
    return greedy_token(logits), caches


def verify_logits_step(params: Params, caches, toks: torch.Tensor, pos,
                       cfg: DecoderConfig, attn_fn: Optional[AttnFn] = None,
                       ring: bool = False):
    """:func:`verify_step` returning the fp32 logits ``[B, S, V]`` in place
    of their argmax: speculative sampling needs the target distribution at
    every span position."""
    logits, caches = _span_forward(params, caches, toks, pos, cfg, attn_fn,
                                   ring)
    return logits.float(), caches


def _categorical(logits: torch.Tensor, generator: torch.Generator):
    """One draw a row from ``softmax(logits)``: the argmax of the logits
    plus Gumbel noise, on the device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def draft_sample_propose(draft_params: Params, draft_caches, cur: torch.Tensor,
                         pos, draft_cfg: DecoderConfig, k: int, temperature,
                         generator: torch.Generator,
                         attn_fn: Optional[AttnFn] = None):
    """The sampling counterpart of :func:`draft_propose`: ``k`` drafts a
    row SAMPLED from the draft's temperature-scaled distribution (the
    rejection proof needs proposals drawn from the ``q`` it is told).
    Returns ``(drafts [B, k], q [B, k, V], caches)``, ``q[b, i]`` the
    distribution ``drafts[b, i]`` was drawn from. Runs k+1 steps for
    :func:`draft_propose`'s cache-hole reason; the last draw is dropped."""
    if attn_fn is None:
        attn_fn = cache_attention
    tok = cur.to(torch.int32)
    p = torch.as_tensor(pos).to(device=cur.device, dtype=torch.int32)
    toks, probs = [], []
    for _ in range(k + 1):
        logits, draft_caches = forward(
            draft_params, tok[:, None], draft_cfg, attn_fn=attn_fn,
            positions=p[:, None], kv_caches=draft_caches, cache_offset=p)
        lg = logits[:, -1, :].float() / temperature
        tok = _categorical(lg, generator)
        toks.append(tok)
        probs.append(torch.softmax(lg, dim=-1))
        p = p + 1
    return (torch.stack(toks[:k], dim=1), torch.stack(probs[:k], dim=1),
            draft_caches)


def sample_accept_row(drafts_row: np.ndarray, q_row: np.ndarray,
                      p_row: np.ndarray, rng: np.random.Generator) -> list:
    """Lossless speculative SAMPLING for one row (the rejection scheme):
    accept draft ``x_i`` with probability ``min(1, p_i(x_i) / q_i(x_i))``;
    at the first rejection emit a sample from ``normalize(max(p_i - q_i,
    0))`` and stop; with all ``k`` accepted, emit a bonus sample from
    ``p_k``. The emitted tokens are distributed exactly as ancestral
    sampling from ``p``. ``q_row [k, V]``, ``p_row [k+1, V]``; returns 1 ..
    k+1 tokens (the contract of :func:`accept_drafts`)."""
    k = len(drafts_row)
    out: list[int] = []
    for i in range(k):
        x = int(drafts_row[i])
        q_x = float(q_row[i, x])
        p_x = float(p_row[i, x])
        if q_x > 0.0 and rng.random() < min(1.0, p_x / q_x):
            out.append(x)
            continue
        resid = np.maximum(p_row[i] - q_row[i], 0.0)
        total = resid.sum()
        if total <= 0.0:  # p == q numerically: any sample of p is exact
            resid, total = p_row[i], p_row[i].sum()
        out.append(int(rng.choice(len(resid), p=resid / total)))
        return out
    p_last = p_row[k]
    out.append(int(rng.choice(len(p_last), p=p_last / p_last.sum())))
    return out


def sample_accept_device(drafts: torch.Tensor, q, logits: torch.Tensor,
                         temperature, generator: torch.Generator, k: int,
                         has_q: bool = True):
    """:func:`sample_accept_row` vectorized over the batch on the device,
    so a round moves token ids and counts to the host and never the ``[B,
    k+1, V]`` target distribution. ``logits [B, k+1, V]`` are the verify
    round's fp32 logits, ``q [B, k, V]`` the draft's proposals
    (``has_q=False``: the drafts as a one-hot proposal, the n-gram case;
    ``q`` is ignored). Draws ``B x k`` uniforms, then one categorical a
    row, from ``generator``. Returns ``(tokens [B, k+1], count [B])``: row
    b emits ``tokens[b, :count[b]]``, its accepted drafts, then a draw
    from ``max(p_at - q_at, 0)`` at the first rejection, with ``q``
    zero-padded at position k (the bonus draw from ``p_k`` when all are
    accepted)."""
    B = drafts.shape[0]
    V = logits.shape[-1]
    dev = logits.device
    p = torch.softmax(logits.float() / temperature, dim=-1)
    dl = drafts.long()
    if not has_q:
        q = F.one_hot(dl, V).float()
    u = torch.rand((B, k), generator=generator, device=dev, dtype=torch.float32)
    p_x = torch.gather(p[:, :k], -1, dl[..., None])[..., 0]
    q_x = torch.gather(q, -1, dl[..., None])[..., 0]
    accept = (q_x > 0.0) & (u * q_x < p_x)  # u < p/q without the divide
    idx = torch.arange(k, device=dev)[None, :].expand(B, k)
    first = torch.where(~accept, idx, k).min(dim=1).values  # [B]
    rows = torch.arange(B, device=dev)
    p_at = p[rows, first]
    q_pad = torch.cat([q, torch.zeros((B, 1, V), dtype=torch.float32,
                                      device=dev)], dim=1)
    q_at = q_pad[rows, first]
    resid = (p_at - q_at).clamp_min(0.0)
    degenerate = resid.sum(-1, keepdim=True) <= 0.0  # p == q numerically
    resid = torch.where(degenerate, p_at, resid)
    resid_logits = torch.where(resid > 0.0, torch.log(resid),
                               torch.full_like(resid, NEG_INF))
    correction = _categorical(resid_logits, generator)
    tokens = torch.cat([drafts.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                       dim=1)
    tokens[rows, first] = correction
    return tokens, (first + 1).to(torch.int32)


def self_draft(params: Params, cfg: DecoderConfig,
               n_layers: int) -> tuple[Params, DecoderConfig]:
    """A draft with no training: the target's FIRST ``n_layers`` layers
    with its embedding, final norm and unembedding. It shares the
    vocabulary by construction and costs ``n_layers / L`` of a target step.
    The layer leaves are views of the target's (``[L, ...]`` sliced), so it
    adds no weight memory. The depth must be a multiple of the window
    cycle, so that the cycle stays aligned."""
    if not 0 < n_layers < cfg.n_layers:
        raise ValueError(
            f"self-draft depth {n_layers} must be in (0, {cfg.n_layers})")
    cycle = len(cfg.window_cycle)
    if n_layers % cycle:
        raise ValueError(
            f"self-draft depth {n_layers} must be a multiple of the "
            f"attn_windows cycle length {cycle}")

    draft_params = dict(params)
    draft_params["layers"] = {k: map_leaf(lambda t: t[:n_layers], v)
                              for k, v in params["layers"].items()}
    return draft_params, replace(cfg, n_layers=n_layers)


def draft_propose(draft_params: Params, draft_caches, cur: torch.Tensor, pos,
                  draft_cfg: DecoderConfig, k: int,
                  attn_fn: Optional[AttnFn] = None):
    """``k`` greedy drafts a row from the draft model at per-row positions
    ``pos [B]``: ``(drafts [B, k], draft caches)``.

    The decode runs ``k+1`` steps and keeps k, so that the entries ``pos ..
    pos+k`` are ALL written: a k-step decode never writes its last token's
    k/v, which would leave a hole at ``pos+k`` for good whenever a round
    accepts every draft (the next round resumes at ``pos+k+1``). Rejected
    drafts' entries heal themselves: the next round starts by overwriting
    the first rejected slot, and later ones lie past the causal frontier
    until overwritten."""
    pos = torch.as_tensor(pos).to(device=cur.device, dtype=torch.int32)
    drafts, caches, _last, _pos = _decode_scan(
        draft_params, draft_caches, cur.to(torch.int32), pos, draft_cfg, k + 1,
        attn_fn if attn_fn is not None else cache_attention,
        return_state=True)
    return drafts[:, :k], caches


def ngram_propose(history: np.ndarray, cur: int, k: int) -> np.ndarray:
    """``k`` drafts for one row: the tokens that followed the most recent
    earlier occurrence of ``cur`` in ``history`` (which ends with the token
    before ``cur``), padded by repeating ``cur`` where the match is near
    the end or absent (a bad draft only costs its rejection)."""
    matches = np.flatnonzero(history == cur)
    out = np.full(k, cur, np.int32)
    if len(matches):
        start = matches[-1] + 1
        tail = history[start: start + k]
        out[: len(tail)] = tail
    return out


def accept_drafts(drafts_row: np.ndarray, greedy_row: np.ndarray,
                  k: int) -> list:
    """The lossless acceptance rule, shared by :func:`generate_speculative`
    and the server: the longest draft prefix the model's own greedy choices
    reproduce, then the model's correction token. Returns 1 .. k+1 tokens;
    the caller advances its position by their number."""
    a = 0
    while a < k and drafts_row[a] == greedy_row[a]:
        a += 1
    return [int(t) for t in drafts_row[:a]] + [int(greedy_row[a])]


def generate_speculative(params: Params, prompt, cfg: DecoderConfig,
                         steps: int, k: int = 4, max_len: int = 0,
                         attn_fn: Optional[AttnFn] = None,
                         draft: Optional[tuple] = None,
                         temperature: float = 0.0, seed: int = 0,
                         device=None) -> np.ndarray:
    """Speculative generation, ``k`` drafts a verify round. At
    ``temperature=0`` the tokens equal greedy
    :func:`.transformer.generate`'s; at ``temperature > 0`` it is lossless
    speculative SAMPLING (:func:`sample_accept_device`): distributed as
    ancestral sampling from the temperature-scaled target, though not the
    stream ``generate`` draws; every draw comes from a ``torch.Generator``
    on ``device`` seeded with ``seed``. Returns ``[B, steps]`` int32
    (numpy). ``draft=(draft_params, draft_cfg)`` drafts with a draft model,
    which prefills the prompt into a cache of its own; otherwise n-gram
    drafts (a one-hot proposal when sampling).

    Runs on ``device`` (CUDA unless the caller says otherwise; the params
    must live there). There each prefill is padded to a multiple of
    :data:`.transformer.CUDA_PAD` and runs the flash kernel (the pad rows
    lie past the causal frontier until a span overwrites them); verify
    spans and the draft's decode take the plain attention, the JAX rule
    for a span at an offset."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = resolve_device(device)
    if params["embed"].device != device:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"generate_speculative runs on {device}")
    sampling = temperature > 0.0
    prompt = np.asarray(prompt, np.int32)
    B, S = prompt.shape
    # A verify round may write k rows past the accepted prefix: the cache
    # needs headroom for the last round's rejected tail.
    need = S + steps + k
    if max_len == 0:
        max_len = need
    elif max_len < need:
        raise ValueError(
            f"max_len={max_len} < prompt+steps+k={need} (speculative "
            "verification needs k entries of cache headroom)")
    if draft is not None and draft[1].vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft[1].vocab_size} != target vocab "
            f"{cfg.vocab_size} — draft tokens would be meaningless")
    tokens = torch.from_numpy(prompt).to(device=device, dtype=torch.int64)
    true_len = None
    if device.type == "cuda":
        pad = -(-S // CUDA_PAD) * CUDA_PAD
        max_len = -(-max(max_len, pad) // CUDA_PAD) * CUDA_PAD
        tokens = F.pad(tokens, (0, pad - S))
        true_len = S
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    temp = torch.full((), float(temperature), dtype=torch.float32,
                      device=device)
    caches, last, pos0 = prefill(params, tokens, cfg, max_len,
                                 return_logits=sampling, true_len=true_len)
    if sampling:
        last = _next_token(last, gen, True, temp, 0)
    last = last.cpu().numpy()
    if draft is not None:
        draft_params, draft_cfg = draft
        draft_caches, _d_last, _d_pos = prefill(
            draft_params, tokens, draft_cfg, max_len, true_len=true_len)

    history = [list(prompt[b]) for b in range(B)]
    out: list[list[int]] = [[int(last[b])] for b in range(B)]
    pos = np.full(B, int(pos0), np.int32)

    def dev(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    while min(len(o) for o in out) < steps:
        cur = np.array([o[-1] for o in out], np.int32)
        q_dev = None
        if draft is not None and sampling:
            drafts_dev, q_dev, draft_caches = draft_sample_propose(
                draft_params, draft_caches, dev(cur), dev(pos), draft_cfg, k,
                temp, gen, attn_fn=attn_fn)
            drafts = drafts_dev.cpu().numpy()
        elif draft is not None:
            drafts_dev, draft_caches = draft_propose(
                draft_params, draft_caches, dev(cur), dev(pos), draft_cfg, k,
                attn_fn=attn_fn)
            drafts = drafts_dev.cpu().numpy()
        else:
            drafts = np.stack([
                ngram_propose(np.asarray(history[b], np.int32), int(cur[b]), k)
                for b in range(B)])
        toks = np.concatenate([cur[:, None], drafts], axis=1)  # [B, k+1]
        if sampling:
            logits, caches = verify_logits_step(
                params, caches, dev(toks, torch.int64), dev(pos), cfg,
                attn_fn=attn_fn)
            tok_acc, counts = sample_accept_device(
                dev(drafts), q_dev, logits, temp, gen, k,
                has_q=q_dev is not None)
            tok_acc, counts = tok_acc.cpu().numpy(), counts.cpu().numpy()
        else:
            greedy, caches = verify_step(params, caches, dev(toks, torch.int64),
                                         dev(pos), cfg, attn_fn=attn_fn)
            greedy = greedy.cpu().numpy()
        for b in range(B):
            if len(out[b]) >= steps:
                # Done: its span was padding; its state does not advance
                # (the next round rewrites the same span).
                continue
            if sampling:
                accepted = tok_acc[b, : counts[b]].tolist()
            else:
                accepted = accept_drafts(drafts[b], greedy[b], k)
            history[b].extend([int(cur[b])] + accepted[:-1])
            out[b].extend(accepted)
            pos[b] += len(accepted)  # cur and the accepted drafts are cached
    return np.array([o[:steps] for o in out], np.int32)
