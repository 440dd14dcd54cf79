"""PyTorch port, ops: attention, the two kernels' plain versions, and int8
quantization, each against its JAX counterpart on the same numpy inputs
(fp32, the CPU). The JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them. Kernel-versus-plain checks on the card are in
``test_torch_cuda.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.ops import attention as jatt
from kata_xpu_device_plugin_tpu.ops import decode_attn as jdec
from kata_xpu_device_plugin_tpu.ops import flash as jflash
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt
from kata_xpu_device_plugin_tpu_torch.ops import decode_attn as tdec
from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

from kata_xpu_device_plugin_tpu_torch.models import bridge

from .torch_parity import CONFIGS

# Same fp32 math on both sides; only the summation order differs.
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KV, D), np.float32),
            rng.standard_normal((B, Sk, KV, D), np.float32))


def _both(fn_j, fn_t, arrays, **kw):
    out_j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    return out_j, out_t


# ----- reference attention ---------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(H=8, KV=2, causal=True),
    dict(H=4, KV=4, causal=False),
    dict(H=8, KV=1, causal=True, window=5),
    dict(H=8, KV=2, causal=True, logits_softcap=3.0),
    dict(H=8, KV=2, causal=True, window=4, logits_softcap=2.0),
], ids=["gqa", "mha-full", "mqa-window", "softcap", "window-softcap"])
def test_reference_attention_matches_jax(case):
    case = dict(case)
    H, KV = case.pop("H"), case.pop("KV")
    arrays = _qkv(0, 2, 12, 12, H, KV, 16)
    out_j, out_t = _both(jatt.reference_attention, tatt.reference_attention,
                         arrays, **case)
    np.testing.assert_allclose(out_t, out_j, **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "per-row"])
def test_reference_attention_q_offset_matches_jax(ragged):
    q, k, v = _qkv(1, 3, 2, 20, 8, 2, 16)
    off = np.array([3, 11, 18], np.int32) if ragged else 7
    out_j = jatt.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), q_offset=jnp.asarray(off))
    out_t = tatt.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.from_numpy(off) if ragged else off)
    assert out_t.shape == (3, 2, 8, 16)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


# ----- flash ------------------------------------------------------------------


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 20.0),
                                            (32, 20.0)])
def test_flash_plain_matches_jax_interpret(S, window, softcap):
    q, k, v = _qkv(S + window, 1, S, S, 4, 2, 64)
    out_j = jflash.pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, window=window, softcap=softcap)
    out_t = tflash.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window,
                                 softcap=softcap)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("sq,sk,d", [(128, 128, 64), (160, 160, 128),
                                     (96, 96, 64), (256, 256, 48),
                                     (1024, 2048, 256), (130, 130, 128)])
def test_flash_gate_matches_jax(sq, sk, d):
    assert tflash.supports(sq, sk, d) == jflash.supports(sq, sk, d)
    for n in (sq, sk):
        assert tflash.pick_block(n, 1024) == jflash.pick_block(n, 1024)


def test_flash_dispatch_takes_plain_version_off_cuda():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 128, 128, 4, 2, 64))
    before = tflash.flash_forward.launches
    out = tatt.flash_attention(q, k, v)
    np.testing.assert_array_equal(out.numpy(),
                                  tatt.reference_attention(q, k, v).numpy())
    assert not tatt.flash_eligible(128, 128, 64, on_cuda=False)
    assert tatt.flash_eligible(128, 128, 64, on_cuda=True)
    assert not tatt.flash_eligible(64, 64, 64, on_cuda=True)
    assert tflash.flash_forward.launches == before


def test_flash_rejects_shapes_without_a_block():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 100, 100, 4, 2, 64))
    with pytest.raises(ValueError, match="no valid flash block"):
        tflash.flash_forward(q, k, v)


# ----- paged decode -----------------------------------------------------------

ZERO, SCRATCH = 0, 1


def _pool_case(seed, bs, B=4, H=8, KV=2, D=16, NB=6):
    """A pool whose tables hold ZERO and SCRATCH entries past each lane's
    frontier, ragged positions (a block edge, 0, a partial last block) and
    lane 3 dead with a stale position far past the view."""
    rng = np.random.default_rng(seed)
    paged_len = NB * bs - 2
    NT = (2 + B * NB) * bs
    q = rng.standard_normal((B, 1, H, D), np.float32)
    pk = rng.standard_normal((1, NT, KV, D), np.float32)
    pv = rng.standard_normal((1, NT, KV, D), np.float32)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0
    pos = np.array([bs * 3 - 1, 0, paged_len - 1, 10_000], np.int32)
    tables = rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2
    for b in range(3):
        tail = int(pos[b]) // bs + 1
        tables[b, tail:] = rng.choice([ZERO, SCRATCH], NB - tail)
    return q, pk, pv, tables, pos, paged_len


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32-pool", "int8-pool"])
def test_paged_decode_plain_matches_jax_interpret(bs, int8):
    q, pk, pv, tables, pos, plen = _pool_case(bs, bs)
    kj, vj = jnp.asarray(pk), jnp.asarray(pv)
    kt, vt = torch.from_numpy(pk), torch.from_numpy(pv)
    if int8:
        kj, vj = jquant.quantize_kv(kj), jquant.quantize_kv(vj)
        kt, vt = tquant.quantize_kv(kt), tquant.quantize_kv(vt)
    out_j = jdec.pallas_paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(pos),
        block_size=bs, paged_len=plen, interpret=True)
    out_t = tdec.paged_decode_attention(
        torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
        torch.from_numpy(pos), block_size=bs, paged_len=plen)
    assert np.isfinite(out_t.numpy()).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_paged_decode_gate_matches_jax():
    for d, bs in [(16, 4), (128, 16), (64, 8), (16, 16), (128, 12), (128, 4),
                  (256, 128)]:
        assert tdec.supports_paged_decode(d, bs) == jdec.supports_paged_decode(d, bs)
        group_ok = d in tdec.KERNEL_HEAD_DIMS
        if jdec.supports_paged_decode(d, bs) and group_ok:
            tdec.check_kernel_shapes(d, 8, bs)
        else:
            with pytest.raises(ValueError, match="paged decode kernel"):
                tdec.check_kernel_shapes(d, 8, bs)


def test_kernel_tolerance_takes_rounding_and_refuses_a_dropped_split():
    """The bound the card's kernel checks use: it takes the other order of
    bf16 rounding the kernels use (p at the row maximum's scale, then one
    division), and refuses a decode that skips a long lane's last 128-key
    split."""
    rng = np.random.default_rng(11)
    B, H, D, bs, nb = 4, 8, 256, 128, 16

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()

    q, pk, pv = bf16((B, 1, H, D)), bf16((1, B * nb * bs, 1, D)), bf16(
        (1, B * nb * bs, 1, D))
    tables = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    pos = torch.tensor([31, 700, 2005, 1500], dtype=torch.int32)
    kw = dict(block_size=bs, paged_len=nb * bs)
    ref = tdec.paged_decode_reference(q, pk, pv, tables, pos, **kw)
    mag = tdec.paged_decode_reference(q.float(), pk.float(), pv.abs().float(),
                                      tables, pos, **kw)
    # The kernels' order: bf16(exp(s - max)) · v summed in fp32, one divide.
    keys = torch.arange(nb * bs)
    s = torch.einsum("bhd,bkd->bhk", q[:, 0].float(),
                     pk[0, :, 0].float().reshape(B, nb * bs, D)) / D ** 0.5
    s = torch.where(keys <= pos[:, None, None], s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhk,bkd->bhd", p.bfloat16().float(),
                       pv[0, :, 0].float().reshape(B, nb * bs, D))
    other = (acc / p.sum(-1, keepdim=True))[:, None].bfloat16()
    assert tatt.kernel_tolerance(other, ref, mag)["ok"]
    assert not tatt.kernel_tolerance(
        other, ref, mag)["max_abs_err"] == 0.0  # the orders really differ
    short = tdec.paged_decode_reference(
        q, pk, pv, tables, torch.tensor([31, 700, 1919, 1500], dtype=torch.int32),
        **kw)
    res = tatt.kernel_tolerance(short, ref, mag)
    assert not res["ok"] and res["max_err_over_bound"] > 1.0


def test_dense_decode_tile_matches_jax():
    for n in (2048, 512, 96, 40, 24, 12, 7):
        assert tatt.dense_decode_tile(n) == jatt.dense_decode_tile(n)


@pytest.mark.parametrize("flag", ["sliding_window", "attn_logits_softcap"])
def test_decode_attn_fn_refuses_what_the_kernel_cannot_model(flag):
    tcfg = bridge.config_from_fields(
        {**dataclasses.asdict(CONFIGS["tiny"]()), flag: 8})
    with pytest.raises(ValueError):
        tatt.make_decode_attn_fn(tcfg, arena_len=64, device="cpu")


def test_slotted_decode_fn_matches_plain_attention_over_the_arena():
    """The zero-copy pool re-view of a slotted ``[B, S, KV, D]`` arena gives
    what ragged attention over the whole arena gives."""
    tcfg = bridge.config_from_fields(dataclasses.asdict(CONFIGS["tiny"]()))
    rng = np.random.default_rng(5)
    B, S = 3, 48
    q = torch.from_numpy(rng.standard_normal((B, 1, 8, 16), np.float32))
    ck = tquant.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, 2, 16), np.float32)))
    cv = tquant.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, 2, 16), np.float32)))
    pos = torch.tensor([0, 17, 47], dtype=torch.int32)
    fn = tatt.make_decode_attn_fn(tcfg, arena_len=S, device="cpu")
    out = fn(q, ck, cv, None, pos)
    ref = tatt.reference_attention(q, tquant.dequantize_kv(ck, q.dtype),
                                   tquant.dequantize_kv(cv, q.dtype),
                                   q_offset=pos)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


# ----- quantization -----------------------------------------------------------


def test_quantize_kv_payloads_equal_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)
    x[0, 0] = 0.0  # amax 0: scale 1
    x[1, 1, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # exact halves: round to even
    qj = jquant.quantize_kv(jnp.asarray(x))
    qt = tquant.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(qj.q))
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale), rtol=1e-6)
    np.testing.assert_allclose(
        tquant.dequantize_kv(qt, torch.float32).numpy(),
        np.asarray(jquant.dequantize_kv(qj, jnp.float32)), rtol=1e-6)


def test_weight_matmul_int8_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((2, 32, 24)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    wj = jquant.quantize(jnp.asarray(w))
    wt = tquant.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(wt.q.numpy(), np.asarray(wj.q))
    for layer in range(2):
        yj = jquant.weight_matmul(jnp.asarray(x[layer]),
                                  jquant.QTensor(wj.q[layer], wj.scale[layer]))
        yt = tquant.weight_matmul(torch.from_numpy(x[layer]),
                                  tquant.QTensor(wt.q[layer], wt.scale[layer]))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    plain = tquant.weight_matmul(torch.from_numpy(x[0]), torch.from_numpy(w[0]))
    np.testing.assert_allclose(plain.numpy(), x[0] @ w[0], **TOL)
