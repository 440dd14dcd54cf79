"""PyTorch port, decode attention: the paged wrapper's multi-query form and
the lock-step dense wrapper, each against its JAX Pallas counterpart in
interpret mode on the same numpy inputs (fp32, the CPU, where the port's
wrappers take their plain versions), and the dispatch contracts around
them. Kernel-versus-plain checks on the card are in ``test_torch_cuda.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.ops import decode_attn as jdec
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch import constants
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt
from kata_xpu_device_plugin_tpu_torch.ops import decode_attn as tdec
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

from .torch_parity import CONFIGS

# Same fp32 math on both sides; only the summation order differs.
TOL = dict(atol=1e-5, rtol=1e-5)
ZERO, SCRATCH = 0, 1


def _span_case(seed, bs, SQ, B=4, H=8, KV=2, D=16, NB=6):
    """A pool behind permuted tables whose entries past each lane's frontier
    are unmapped (ZERO), ragged positions (a block edge, the shortest span
    that fits, a partial last block), ragged query lengths with ``q_len =
    1`` beside full-width lanes, and lane 3 dead with a stale position far
    past the view."""
    rng = np.random.default_rng(seed)
    paged_len = NB * bs - 2
    NT = (2 + B * NB) * bs
    q = rng.standard_normal((B, SQ, H, D), np.float32)
    pk = rng.standard_normal((1, NT, KV, D), np.float32)
    pv = rng.standard_normal((1, NT, KV, D), np.float32)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0
    pos = np.array([bs * 3 - 1, SQ - 1, paged_len - 1, 10_000], np.int32)
    q_lens = np.array([SQ, SQ, 1, 1], np.int32)
    tables = rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2
    for b in range(3):
        tables[b, int(pos[b]) // bs + 1:] = ZERO
    real = np.arange(SQ)[None, :] >= SQ - q_lens[:, None]
    real[3] = False  # a dead lane's rows are garbage on both sides
    return q, pk, pv, tables, pos, q_lens, paged_len, real


@pytest.mark.parametrize("SQ", [1, 3, 4])
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32-pool", "int8-pool"])
def test_paged_multi_query_plain_matches_jax_interpret(bs, int8, SQ):
    q, pk, pv, tables, pos, q_lens, plen, real = _span_case(bs + SQ, bs, SQ)
    kj, vj = jnp.asarray(pk), jnp.asarray(pv)
    kt, vt = torch.from_numpy(pk), torch.from_numpy(pv)
    if int8:
        kj, vj = jquant.quantize_kv(kj), jquant.quantize_kv(vj)
        kt, vt = tquant.quantize_kv(kt), tquant.quantize_kv(vt)
    out_j = np.asarray(jdec.pallas_paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(q_lens), block_size=bs, paged_len=plen, interpret=True))
    out_t = tdec.paged_decode_attention(
        torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
        torch.from_numpy(pos), torch.from_numpy(q_lens), block_size=bs,
        paged_len=plen).numpy()
    assert out_t.shape == q.shape and np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t[real], out_j[real], **TOL)
    # Padding rows: a mean of V on both sides (over different key sets),
    # finite and no larger than the largest V entry.
    v_max = float(tquant.dequantize_kv(vt, torch.float32).abs().max())
    assert np.abs(out_t[~real]).max() <= v_max


def test_paged_q_lens_none_means_every_row_is_real():
    q, pk, pv, tables, pos, _q_lens, plen, _real = _span_case(3, 4, 3)
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(tables), torch.from_numpy(pos))
    kw = dict(block_size=4, paged_len=plen)
    full = torch.full((4,), 3, dtype=torch.int32)
    np.testing.assert_array_equal(
        tdec.paged_decode_attention(*args, **kw).numpy(),
        tdec.paged_decode_attention(*args, full, **kw).numpy())
    # A span's row j is the single-token call at the row's own position.
    for j in range(3):
        one = tdec.paged_decode_attention(
            args[0][:, j:j + 1], *args[1:4], args[4] - 2 + j, **kw)
        np.testing.assert_allclose(
            tdec.paged_decode_attention(*args, **kw)[:3, j].numpy(),
            one[:3, 0].numpy(), **TOL)


@pytest.mark.parametrize("pos", [0, 127, 128, 200, 255])
def test_dense_decode_plain_matches_jax_interpret(pos):
    rng = np.random.default_rng(pos)
    B, S, H, KV, D = 2, 256, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    out_j = np.asarray(jdec.pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        interpret=True))
    for p in (torch.tensor(pos, dtype=torch.int32),
              torch.tensor([pos], dtype=torch.int32)):
        out_t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), p).numpy()
        np.testing.assert_allclose(out_t, out_j, **TOL)


def test_decode_gates_match_jax():
    for sq, sk, d in [(1, 128, 128), (1, 2048, 256), (1, 256, 64), (2, 256, 128),
                      (1, 200, 128), (1, 64, 128), (1, 256, 96), (1, 0, 128)]:
        assert tdec.supports_decode(sq, sk, d) == jdec.supports_decode(sq, sk, d)


def test_decode_eligible_contract(monkeypatch):
    """Off unless KATA_TPU_DECODE_KERNEL=1; then only a causal single token
    at ONE scalar offset into a supported cache length, on a CUDA tensor."""
    assert constants.ENV_DECODE_KERNEL == "KATA_TPU_DECODE_KERNEL"
    scalar = torch.tensor(5, dtype=torch.int32)
    monkeypatch.delenv(constants.ENV_DECODE_KERNEL, raising=False)
    assert not tatt.decode_eligible(1, 256, 128, True, scalar, on_cuda=True)
    monkeypatch.setenv(constants.ENV_DECODE_KERNEL, "0")
    assert not tatt.decode_eligible(1, 256, 128, True, scalar, on_cuda=True)
    monkeypatch.setenv(constants.ENV_DECODE_KERNEL, "1")
    assert tatt.decode_eligible(1, 256, 128, True, scalar, on_cuda=True)
    assert tatt.decode_eligible(1, 256, 128, True, 5, on_cuda=True)
    assert not tatt.decode_eligible(1, 256, 128, True, scalar, on_cuda=False)
    assert not tatt.decode_eligible(1, 256, 128, True, scalar)
    assert not tatt.decode_eligible(1, 256, 128, False, scalar, on_cuda=True)
    assert not tatt.decode_eligible(1, 256, 128, True, None, on_cuda=True)
    assert not tatt.decode_eligible(1, 256, 128, True, torch.tensor([5, 5]),
                                    on_cuda=True)
    assert not tatt.decode_eligible(2, 256, 128, True, scalar, on_cuda=True)
    assert not tatt.decode_eligible(1, 200, 128, True, scalar, on_cuda=True)
    # On the CPU the dispatch is the plain version whatever the knob says.
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 128, 2, 16), np.float32))
    np.testing.assert_array_equal(
        tatt.flash_attention(q, k, k, q_offset=scalar).numpy(),
        tatt.reference_attention(q, k, k, q_offset=scalar).numpy())


def _tcfg(**overrides):
    return bridge.config_from_fields(
        {**dataclasses.asdict(CONFIGS["tiny"]()), **overrides})


@pytest.mark.parametrize("flag", ["sliding_window", "attn_logits_softcap"])
def test_paged_decode_attn_fn_refuses_what_the_kernel_cannot_model(flag):
    with pytest.raises(ValueError):
        tatt.make_decode_attn_fn(_tcfg(**{flag: 8}), paged=True, block_size=4,
                                 paged_len=24, device="cpu")


def test_paged_decode_attn_fn_passes_tables_and_query_lengths_through():
    q, pk, pv, tables, pos, q_lens, plen, _real = _span_case(9, 4, 3)
    args = tuple(map(torch.from_numpy, (q, pk, pv, tables, pos, q_lens)))
    fn = tatt.make_decode_attn_fn(_tcfg(), paged=True, block_size=4,
                                  paged_len=plen, device="cpu")
    assert fn.multi_query is True
    np.testing.assert_array_equal(
        fn(*args).numpy(),
        tdec.paged_decode_attention(*args, block_size=4, paged_len=plen).numpy())
    np.testing.assert_array_equal(
        fn(*args[:5]).numpy(),
        tdec.paged_decode_attention(*args[:5], block_size=4,
                                    paged_len=plen).numpy())
    assert tatt.make_decode_attn_fn(_tcfg(), arena_len=64,
                                    device="cpu").multi_query is True
    with pytest.raises(ValueError, match="block_size and"):
        tatt.make_decode_attn_fn(_tcfg(), paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged decode kernel"):
        tatt.make_decode_attn_fn(_tcfg(head_dim=128), paged=True, block_size=12,
                                 paged_len=48, device="cuda")
