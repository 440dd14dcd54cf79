"""PyTorch port, flash backward: the plain forward-with-logsumexp, the plain
backward and the autograd path against the JAX package's Pallas kernels
run in interpret mode (fp32, the CPU), as its own tests run them.

Tolerance rtol 2e-3, atol 2e-4: the one the JAX package's flash-backward
test uses (tests/test_ops.py) for the blockwise recompute against a dense
softmax — the kernels rebuild p from the logsumexp tile by tile, so p, dp
and the gradients sum in another order than a dense fp32 einsum, and the
cancellation in ``dp - delta`` magnifies that order's rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.ops import flash as jflash
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt
from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash

TOL = dict(rtol=2e-3, atol=2e-4)
B, S, D, BLOCK = 1, 256, 64, 128

CASES = [  # (H, KV, causal, window, softcap)
    (4, 1, True, 0, 0.0), (4, 2, True, 0, 0.0), (4, 1, False, 0, 0.0),
    (4, 2, False, 0, 0.0), (4, 2, True, 96, 4.0),
]
IDS = ["mqa-causal", "gqa-causal", "mqa-full", "gqa-full", "gqa-window-softcap"]


def _inputs(seed, H, KV):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, H, D), np.float32))


def _t(a):
    """[B, S, H, D] numpy -> the JAX kernels' [B, H, S, D] layout."""
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def _jax_forward(q, k, v, H, KV, causal, window, softcap):
    out_t, lse = jflash._fwd_call(
        _t(q), _t(k), _t(v), causal, BLOCK, BLOCK, H // KV, True,
        1.0 / D ** 0.5, need_lse=True, window=window, softcap=softcap)
    return out_t, lse


@pytest.mark.parametrize("H,KV,causal,window,softcap", CASES, ids=IDS)
def test_plain_forward_with_lse_matches_jax_interpret(H, KV, causal, window,
                                                      softcap):
    q, k, v, _ = _inputs(1, H, KV)
    out_t, lse = _jax_forward(q, k, v, H, KV, causal, window, softcap)
    out, tlse = tflash.flash_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window, softcap,
        return_lse=True)
    assert tlse.shape == (B, H, S) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0], **TOL)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(out_t.transpose(0, 2, 1, 3)), **TOL)


@pytest.mark.parametrize("H,KV,causal,window,softcap", CASES, ids=IDS)
def test_plain_backward_matches_jax_interpret(H, KV, causal, window, softcap):
    """The same q, k, v, out, lse and dout into both: the port's plain
    backward against ``_bwd_call``'s two kernels and ``_group_kv_grads``."""
    q, k, v, do = _inputs(2, H, KV)
    out_t, lse = _jax_forward(q, k, v, H, KV, causal, window, softcap)
    dq, dk_h, dv_h = jflash._bwd_call(
        _t(q), _t(k), _t(v), out_t, lse, _t(do), causal, BLOCK, BLOCK,
        H // KV, True, 1.0 / D ** 0.5, window=window, softcap=softcap)
    dk, dv = jflash._group_kv_grads(dk_h, dv_h, KV, H // KV)
    out = torch.from_numpy(np.array(out_t.transpose(0, 2, 1, 3)))
    got = tflash.flash_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), out,
        torch.from_numpy(np.asarray(lse)[..., 0].copy()), torch.from_numpy(do),
        causal, window, softcap)
    for name, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.transpose(0, 2, 1, 3)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("H,KV,causal,window,softcap", CASES, ids=IDS)
def test_autograd_matches_jax_grad_through_pallas(H, KV, causal, window,
                                                  softcap):
    """``torch.autograd.grad`` through the port's ``flash_attention`` (on
    the CPU: the plain version under PyTorch's autograd) and through the
    autograd function :class:`flash.FlashAttention` (plain forward with
    lse and plain backward) against ``jax.grad`` through
    ``pallas_flash_attention``'s custom VJP."""
    q, k, v, do = _inputs(3, H, KV)

    def f(q, k, v):
        out = jflash.pallas_flash_attention(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
            interpret=True, window=window, softcap=softcap)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for how in ("flash_attention", "FlashAttention"):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if how == "flash_attention":
            out = tatt.flash_attention(*xs, causal=causal, window=window,
                                       logits_softcap=softcap)
        else:
            out = tflash.FlashAttention.apply(*xs, causal, window, softcap)
        got = torch.autograd.grad(out, xs, torch.from_numpy(do))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"{how} d{name}", **TOL)


def test_backward_magnitudes_cover_the_single_key_row():
    """Row 0 of a causal mask attends to key 0 alone, so its exact dq is 0
    and each side's value is the fp32 rounding of ``dp - delta``; the
    bound must cover that rounding (it is what a first version without the
    ``e_d`` term refused on the card), yet stay a rounding-sized bound."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(4, 4, 2))
    out, lse = tflash.flash_reference(q, k, v)
    w_dq, w_dk, w_dv = tflash.backward_magnitudes(q, k, v, out, lse, do)
    assert (w_dq[:, 0] > 0).all()
    # The worst-case fp32 term is generous, yet under 5% of other rows'.
    assert float(w_dq[:, 0].median()) < 0.05 * float(w_dq[:, 1:].median())
    dq, dk, dv = tflash.flash_backward_reference(q, k, v, out, lse, do)
    for g, w in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert (w >= g.float().abs() * (1 - 2.0 ** -7)).all()
