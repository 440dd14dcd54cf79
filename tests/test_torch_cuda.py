"""PyTorch port, on the card: each CUDA kernel against its plain version on
the same bf16 inputs. Marked ``cuda``; they skip without an NVIDIA GPU.

This file imports neither JAX nor the test helpers, so it runs where JAX
is not installed. From the repository root on a machine with the card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import gemma_2b, init_params
from kata_xpu_device_plugin_tpu_torch.models import transformer
from kata_xpu_device_plugin_tpu_torch.ops import attention, decode_attn, flash, quant



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,window,softcap", [
    (8, 1, 256, 0, 0.0), (8, 2, 128, 64, 30.0), (4, 4, 64, 0, 0.0),
])
def test_flash_kernel_matches_plain(cuda_device, H, KV, D, window, softcap):
    """q/k/v are slices of one fused ``[B, S, (H + 2 KV) D]`` projection,
    the strided layout the transformer hands the kernel."""
    rng = np.random.default_rng(D + window)
    B, S = 2, 256
    qkv = _randn(rng, (B, S, (H + 2 * KV) * D), cuda_device)
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    before = flash.flash_forward.launches
    out = flash.flash_forward(q, k, v, window=window, softcap=softcap)
    ref = attention.reference_attention(q, k, v, window=window,
                                        logits_softcap=softcap)
    mag = attention.reference_attention(q.float(), k.float(), v.abs().float(),
                                        window=window, logits_softcap=softcap)
    torch.cuda.synchronize()
    assert flash.flash_forward.launches == before + 1
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_kernel_matches_plain(cuda_device, int8, bs):
    rng = np.random.default_rng(bs + int8)
    B, H, KV, D, NB = 4, 8, 1, 256, 4
    NT = (2 + B * NB) * bs
    q = _randn(rng, (B, 1, H, D), cuda_device)
    k = _randn(rng, (1, NT, KV, D), cuda_device)
    v = _randn(rng, (1, NT, KV, D), cuda_device)
    if int8:
        k, v = quant.quantize_kv(k), quant.quantize_kv(v)
    tables = torch.from_numpy(
        rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2).to(cuda_device)
    pos = torch.tensor([0, bs - 1, NB * bs - 1, 10_000], dtype=torch.int32,
                       device=cuda_device)  # the last lane is dead, stale pos
    kw = dict(block_size=bs, paged_len=NB * bs)
    before = decode_attn.paged_decode_attention.launches
    out = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
    ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
    v_abs = (quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs())
    mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables, pos,
                                             **kw)
    torch.cuda.synchronize()
    assert decode_attn.paged_decode_attention.launches == before + 1
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res


def _qkv_do(rng, dev, B, S, H, KV, D):
    """q/k/v as strided slices of one fused projection (the inference
    layout); dout contiguous."""
    qkv = _randn(rng, (B, S, (H + 2 * KV) * D), dev)
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D: (H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    return q, k, v, _randn(rng, (B, S, H, D), dev)


BWD_CASES = [  # (H, KV, D, causal, window, softcap)
    (8, 2, 128, True, 0, 0.0), (4, 1, 64, True, 64, 30.0),
    (4, 4, 64, False, 0, 0.0), (8, 1, 256, True, 0, 0.0),
    (4, 2, 256, True, 96, 30.0), (4, 4, 256, False, 0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,causal,window,softcap", BWD_CASES)
def test_flash_lse_matches_plain(cuda_device, H, KV, D, causal, window, softcap):
    """The logsumexp in fp32: both sides form it from fp32 logits of the
    same bf16 inputs and differ only in summation order (~1e-6 relative);
    1e-4 + 1e-5 |lse| is far above that and far below any masking or
    scaling fault (which moves lse by O(1))."""
    q, k, v, _ = _qkv_do(np.random.default_rng(D + H), cuda_device, 2, 256, H, KV, D)
    before = flash.flash_forward.launches
    out, lse = flash.flash_forward(q, k, v, causal, window, softcap,
                                   return_lse=True)
    ref, ref_lse = flash.flash_reference(q, k, v, causal, window, softcap)
    torch.cuda.synchronize()
    assert flash.flash_forward.launches == before + 1
    assert lse.shape == (2, H, 256) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    mag = attention.reference_attention(q.float(), k.float(), v.abs().float(),
                                        causal=causal, window=window,
                                        logits_softcap=softcap)
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res


FWD_EDGE_CASES = [  # (B, S, H, KV, D, causal, window, softcap)
    (2, 256, 8, 2, 128, False, 0, 0.0),   # full attention
    (2, 256, 8, 2, 64, True, 0, 0.0),     # D = 64
    (1, 320, 4, 1, 256, True, 96, 30.0),  # a window edge inside the tiles, cap
    (2, 160, 8, 2, 128, True, 0, 0.0),    # S = 160: a part q tile and key tile
    (1, 320, 8, 1, 256, True, 0, 0.0),    # S = 320, MQA
    (1, 128, 8, 1, 256, True, 0, 0.0),    # B = 1, S = 128: one q tile a head
    (2, 256, 16, 4, 128, True, 0, 0.0),   # GQA 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,softcap", FWD_EDGE_CASES)
def test_flash_forward_tile_edges_match_plain(cuda_device, B, S, H, KV, D,
                                              causal, window, softcap):
    """Where the forward's tiles meet the masks and the sequence's end: both
    instantiations (without and with the lse) within kernel_tolerance of
    the plain version, the lse within its fp32 bound, on q/k/v sliced from
    one fused projection; a second launch of each gives the same bits."""
    q, k, v, _ = _qkv_do(np.random.default_rng(S + D + H), cuda_device, B, S,
                         H, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash.flash_forward.launches
    runs = [(flash.flash_forward(q, k, v, **kw),
             *flash.flash_forward(q, k, v, return_lse=True, **kw))
            for _ in range(2)]
    ref, ref_lse = flash.flash_reference(q, k, v, **kw)
    mag = attention.reference_attention(q.float(), k.float(), v.abs().float(),
                                        causal=causal, window=window,
                                        logits_softcap=softcap)
    torch.cuda.synchronize()
    assert flash.flash_forward.launches == before + 4
    out, out_lse, lse = runs[0]
    for o in (out, out_lse):
        assert o.shape == (B, S, H, D) and o.dtype == torch.bfloat16
        res = attention.kernel_tolerance(o, ref, mag)
        assert res["ok"], res
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,causal,window,softcap", BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda_device, H, KV, D, causal,
                                            window, softcap):
    """dq and dk/dv against the plain backward on the same bf16 inputs,
    out and lse, within the bound ``flash.backward_magnitudes`` derives."""
    q, k, v, do = _qkv_do(np.random.default_rng(D + 7), cuda_device, 2, 256,
                          H, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash.flash_forward(q, k, v, return_lse=True, **kw)
    n_dq, n_dkv = flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches
    got = flash.flash_backward(q, k, v, out, lse, do, **kw)
    want = flash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash.flash_bwd_dq.launches == n_dq + 1
    assert flash.flash_bwd_dkv.launches == n_dkv + 1
    for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        res = attention.kernel_tolerance(a, b, m)
        assert res["ok"], (name, res)


@pytest.mark.cuda
def test_flash_attention_trains_through_the_kernels(cuda_device):
    """With grad mode on, ``flash_attention`` on the card is the autograd
    function: one forward (with lse) and one launch of each backward
    kernel, giving exactly what the wrappers give called by hand; under
    ``no_grad`` it is the plain forward launch."""
    q, k, v, do = _qkv_do(np.random.default_rng(11), cuda_device, 1, 128, 8, 2, 128)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    f0, d0 = flash.flash_forward.launches, flash.flash_bwd_dq.launches
    out = attention.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert flash.flash_forward.launches == f0 + 1
    assert flash.flash_bwd_dq.launches == d0 + 1
    o2, lse = flash.flash_forward(q.detach(), k.detach(), v.detach(),
                                  return_lse=True)
    want = flash.flash_backward(q.detach(), k.detach(), v.detach(), o2, lse, do)
    torch.testing.assert_close(out.detach(), o2, atol=0, rtol=0)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with torch.no_grad():
        assert not attention.flash_attention(q, k, v).requires_grad
    assert flash.flash_forward.launches == f0 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_runs_the_flash_kernels(cuda_device, remat):
    """One AdamW step of a two-layer model at Llama-3 head widths (D=128,
    GQA 2) on the card: every layer's attention runs the forward kernel
    (twice with remat: once more in the recompute) and each backward
    kernel once; the loss is finite and the parameters move."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.models import llama3_8b
    from kata_xpu_device_plugin_tpu_torch.parallel import make_train_step

    cfg = replace(llama3_8b(), n_layers=2, vocab_size=512, d_model=256,
                  n_heads=4, n_kv_heads=2, d_ff=512)
    init_state, step = make_train_step(cfg, remat=remat)
    state = init_state(0)
    before = state["params"]["layers"]["wq"].clone()
    toks = np.random.default_rng(0).integers(0, 512, (2, 128))
    counts = [f.launches for f in (flash.flash_forward, flash.flash_bwd_dq,
                                   flash.flash_bwd_dkv)]
    state, loss = step(state, toks)
    torch.cuda.synchronize()
    after = [f.launches for f in (flash.flash_forward, flash.flash_bwd_dq,
                                  flash.flash_bwd_dkv)]
    assert [a - b for a, b in zip(after, counts)] == [2 * (1 + remat), 2, 2]
    assert torch.isfinite(loss) and state["step"] == 1
    assert not torch.equal(state["params"]["layers"]["wq"], before)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 128, 4, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_forward(q, q, q)
    q32 = torch.zeros(1, 128, 4, 64, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        flash.flash_forward(q32, q32, q32)
    q96 = torch.zeros(1, 128, 4, 96, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_bwd_dq(q96, q96, q96, q96, lse, lse)


@pytest.mark.cuda
def test_cuda_entry_points_run_both_kernels(cuda_device):
    """generate() on the card pads to kernel lengths and runs both kernels
    (a bf16 two-layer Gemma); with a plain ``attn_fn`` it runs neither."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=3, device=cuda_device, dtype=torch.bfloat16)
    prompt = np.random.default_rng(4).integers(0, 512, (2, 50))
    f0 = flash.flash_forward.launches
    d0 = decode_attn.paged_decode_attention.launches
    got = transformer.generate(params, prompt, cfg, 6)
    assert flash.flash_forward.launches - f0 == cfg.n_layers
    assert decode_attn.paged_decode_attention.launches - d0 == 5 * cfg.n_layers
    assert got.shape == (2, 6) and ((got >= 0) & (got < 512)).all()
    f0 = flash.flash_forward.launches
    want = transformer.generate(params, prompt, cfg, 6,
                                attn_fn=attention.reference_attention)
    assert want.shape == (2, 6) and flash.flash_forward.launches == f0


@pytest.mark.cuda
def test_cuda_server_refuses_what_the_kernels_do_not_take(cuda_device):
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=1, vocab_size=256)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="prefill_buckets"):
        GenerationServer(params, cfg, max_len=256)
    with pytest.raises(ValueError, match="sliding_window"):
        GenerationServer(params, replace(cfg, sliding_window=64), max_len=256,
                         prefill_buckets=(128,), decode_attn="cuda_paged")
    srv = GenerationServer(params, cfg, max_len=512, prefill_buckets=(128,))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        srv.submit(np.zeros(200, np.int32), 4)
    assert GenerationServer(params, replace(cfg, sliding_window=64), max_len=256,
                            prefill_buckets=(128,), decode_attn="reference"
                            ).stats()["decode_backend"] == "reference"
    # By default a window (or the attention softcap) rules the kernel out,
    # as in the JAX server: the plain attention, with the reason.
    for flag, reason in ((dict(sliding_window=64), "sliding_window"),
                         (dict(attn_logits_softcap=50.0), "logits_softcap")):
        stats = GenerationServer(params, replace(cfg, **flag), max_len=256,
                                 prefill_buckets=(128,)).stats()
        assert (stats["decode_backend"], stats["decode_backend_reason"]) == (
            "reference", reason)


def _paged_pool(rng, dev, B, NB, bs, KV, D, int8, pos):
    """A pool with permuted, non-contiguous tables whose entries past each
    lane's frontier are unmapped (the ZERO block, as the transformer's view
    tables hold them); block 0 is all zeros."""
    NT = (2 + B * NB) * bs
    k = _randn(rng, (1, NT, KV, D), dev)
    v = _randn(rng, (1, NT, KV, D), dev)
    k[0, :bs] = 0.0
    v[0, :bs] = 0.0
    tables = rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2
    for b, p in enumerate(pos):
        tables[b, min(int(p), NB * bs - 1) // bs + 1:] = 0
    if int8:
        k, v = quant.quantize_kv(k), quant.quantize_kv(v)
    return k, v, torch.from_numpy(tables).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("SQ", [4, 8])
def test_paged_decode_multi_query_matches_plain(cuda_device, int8, bs, SQ):
    """Spans of SQ rows with ragged query lengths (``q_len = 1`` lanes beside
    a full-width one) through real tables: real rows within the derived
    bound of the plain version and bit-equal to a single-query launch at
    the row's own position; padding rows finite and within max|V|."""
    rng = np.random.default_rng(bs + SQ + int8)
    B, H, KV, D, NB = 4, 8, 1, 256, 4
    pos_l = [SQ - 1, 2 * bs, NB * bs - 1, 10_000]  # the last lane is dead
    q_lens_l = [SQ, 1, SQ // 2, 1]
    k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
    q = _randn(rng, (B, SQ, H, D), cuda_device)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
    q_lens = torch.tensor(q_lens_l, dtype=torch.int32, device=cuda_device)
    kw = dict(block_size=bs, paged_len=NB * bs)
    before = decode_attn.paged_decode_attention.launches
    out = decode_attn.paged_decode_attention(q, k, v, tables, pos, q_lens, **kw)
    torch.cuda.synchronize()
    assert decode_attn.paged_decode_attention.launches == before + 1
    ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, q_lens, **kw)
    v_abs = (quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs())
    mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables, pos,
                                             q_lens, **kw)
    real = (torch.arange(SQ, device=cuda_device)[None, :]
            >= SQ - q_lens[:, None])
    real[3] = False  # the dead lane's rows are garbage on both sides
    res = attention.kernel_tolerance(out[real], ref[real], mag[real])
    assert res["ok"], res
    v_max = float(quant.dequantize_kv(v, torch.bfloat16).float().abs().max())
    assert torch.isfinite(out.float()).all()
    assert float(out.float().abs().max()) <= v_max
    for j in range(SQ):
        one = decode_attn.paged_decode_attention(
            q[:, j:j + 1].contiguous(), k, v, tables, pos - (SQ - 1) + j, **kw)
        rows = real[:, j]
        assert torch.equal(out[rows, j], one[rows, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(8, 1, 256), (32, 8, 128), (4, 4, 64)])
@pytest.mark.parametrize("pos", [0, 127, 128, 300, 511])
def test_dense_decode_kernel_matches_plain(cuda_device, H, KV, D, pos):
    rng = np.random.default_rng(H + D + pos)
    B, S = 3, 512
    q = _randn(rng, (B, 1, H, D), cuda_device)
    k = _randn(rng, (B, S, KV, D), cuda_device)
    v = _randn(rng, (B, S, KV, D), cuda_device)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, k, v, p)
    ref = decode_attn.decode_attention_reference(q, k, v, p)
    mag = decode_attn.decode_attention_reference(q.float(), k.float(),
                                                 v.abs().float(), p)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res


@pytest.mark.cuda
def test_dense_decode_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(2, 1, 8, 128, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(2, 256, 2, 128, device=cuda_device, dtype=torch.bfloat16)
    p = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 128"):
        decode_attn.decode_attention(q, k[:, :200].contiguous(),
                                     k[:, :200].contiguous(), p)
    with pytest.raises(TypeError, match="bf16"):
        decode_attn.decode_attention(q, k.float(), k.float(), p)
    with pytest.raises(ValueError, match="on the\\s+device"):
        decode_attn.decode_attention(q, k, k, p.cpu())
    with pytest.raises(ValueError, match="query rows"):
        decode_attn.paged_decode_attention(
            torch.zeros(1, 0, 8, 128, device=cuda_device, dtype=torch.bfloat16),
            k.reshape(1, 512, 2, 128), k.reshape(1, 512, 2, 128),
            torch.zeros(1, 4, dtype=torch.int32, device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device),
            block_size=128, paged_len=512)


@pytest.mark.cuda
def test_generate_lockstep_runs_the_dense_kernel(cuda_device, monkeypatch):
    """Under KATA_TPU_DECODE_KERNEL=1 generate() decodes in lock-step through
    the dense kernel (one launch a layer a step, none of the paged kernel);
    without it, through the paged kernel and never the dense one. An int8
    cache with the opt-in raises."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=3, device=cuda_device, dtype=torch.bfloat16)
    prompt = np.random.default_rng(4).integers(0, 512, (2, 50))
    monkeypatch.delenv("KATA_TPU_DECODE_KERNEL", raising=False)
    n0 = decode_attn.decode_attention.launches
    want = transformer.generate(params, prompt, cfg, 6)
    assert decode_attn.decode_attention.launches == n0
    monkeypatch.setenv("KATA_TPU_DECODE_KERNEL", "1")
    p0 = decode_attn.paged_decode_attention.launches
    got = transformer.generate(params, prompt, cfg, 6)
    assert decode_attn.decode_attention.launches - n0 == 5 * cfg.n_layers
    assert decode_attn.paged_decode_attention.launches == p0
    assert got.shape == (2, 6) and ((got >= 0) & (got < 512)).all()
    assert float((got == want).float().mean()) >= 0.5  # near-ties may differ
    with pytest.raises(ValueError, match="kv_quantized"):
        transformer.generate(params, prompt, cfg, 6, kv_quantized=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
def test_paged_server_on_the_card(cuda_device, kv_quant):
    """A two-layer model at Gemma-2B head widths over a pool small enough to
    preempt: every request returns its budget, every decode step goes
    through the paged kernel, the pool ends empty, and a block size the
    kernel does not take raises at construction."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=6, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_quant=kv_quant)
    with pytest.raises(ValueError, match="KV tile"):
        GenerationServer(params, cfg, kv_pool_tokens=2048, kv_block_size=12, **kw)
    srv = GenerationServer(params, cfg, kv_pool_tokens=768, kv_block_size=16, **kw)
    rng = np.random.default_rng(1)
    lens = rng.integers(100, 129, 8)  # one bucket: growth must find blocks
    budgets = rng.integers(40, 81, 8)
    rids = [srv.submit(rng.integers(0, 512, n), int(b))
            for n, b in zip(lens, budgets)]
    d0 = decode_attn.paged_decode_attention.launches
    out = srv.run()
    stats = srv.stats()
    assert [len(out[r]) for r in rids] == [int(b) for b in budgets]
    assert stats["preemptions"] >= 1
    assert stats["kv_blocks_in_use"] == 0 and stats["preempted_waiting"] == 0
    assert (decode_attn.paged_decode_attention.launches - d0
            == stats["rounds"] * 4 * cfg.n_layers)


@pytest.mark.cuda
def test_paged_server_equals_slotted_at_the_same_tile(cuda_device):
    """A paged server with the slotted server's lane count and KV tile (128)
    and a pool that never presses does the slotted server's arithmetic, only
    through scattered block tables: greedy tokens are equal bit for bit."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_quant=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n) for n in rng.integers(20, 250, 10)]
    budgets = [int(b) for b in rng.integers(8, 60, 10)]

    def serve(**extra):
        srv = GenerationServer(params, cfg, **kw, **extra)
        rids = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
        out = srv.run()
        return [out[r] for r in rids], srv.stats()

    want, _ = serve()
    got, stats = serve(kv_pool_tokens=4 * 512 + 256, kv_block_size=128)
    assert stats["preemptions"] == 0 and stats["kv_blocks_total"] == 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged-int8", "paged-bf16-span", "dense"])
def test_decode_kernels_are_bit_deterministic(cuda_device, kernel):
    """The split-K passes merge a row's chunks in a fixed order with no
    atomics: two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(21)
    if kernel == "dense":
        q = _randn(rng, (8, 1, 8, 256), cuda_device)
        k = _randn(rng, (8, 2048, 1, 256), cuda_device)
        v = _randn(rng, (8, 2048, 1, 256), cuda_device)
        p = torch.tensor(2047, dtype=torch.int32, device=cuda_device)
        outs = [decode_attn.decode_attention(q, k, v, p) for _ in range(2)]
    else:
        SQ, bs, NB = (4, 16, 64) if kernel.endswith("span") else (1, 16, 128)
        pos_l = [SQ + 5, 700, NB * bs - 1, 10_000]
        k, v, tables = _paged_pool(rng, cuda_device, 4, NB, bs, 1, 256,
                                   kernel == "paged-int8", pos_l)
        q = _randn(rng, (4, SQ, 8, 256), cuda_device)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
        q_lens = torch.tensor([SQ, 1, SQ, SQ], dtype=torch.int32, device=cuda_device)
        outs = [decode_attn.paged_decode_attention(
            q, k, v, tables, pos, q_lens, block_size=bs, paged_len=NB * bs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,causal,window,softcap", BWD_CASES)
def test_flash_backward_kernels_are_bit_deterministic(cuda_device, H, KV, D,
                                                      causal, window, softcap):
    """Each dq, dk and dv element is summed by the one block that owns it,
    in a fixed order, with no atomics: relaunches give the same bits. S=320
    leaves a part tile at the end."""
    q, k, v, do = _qkv_do(np.random.default_rng(D + 31), cuda_device, 2, 320,
                          H, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash.flash_forward(q, k, v, return_lse=True, **kw)
    runs = [flash.flash_backward(q, k, v, out, lse, do, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_gemma_flag_train_step_runs_the_flash_kernels(cuda_device):
    """One AdamW step of a two-layer model with Gemma-2B's training flags
    (MQA, head_dim 256, GeGLU, scaled and tied embeddings) on the card:
    each layer runs the forward kernel and each backward kernel once; the
    loss is finite and the tied embedding moves."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.parallel import make_train_step

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512, d_model=512,
                  d_ff=1024)
    init_state, step = make_train_step(cfg)
    state = init_state(0)
    before = state["params"]["embed"].clone()
    toks = np.random.default_rng(1).integers(0, 512, (2, 256))
    kernels = (flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    counts = [f.launches for f in kernels]
    state, loss = step(state, toks)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(kernels, counts)] == [2, 2, 2]
    assert torch.isfinite(loss) and state["step"] == 1
    assert not torch.equal(state["params"]["embed"], before)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs", [1024, 2048])
def test_paged_decode_tile_past_one_piece_matches_plain(cuda_device, int8, bs):
    """A tile of more keys than the split pass holds logits for at once
    (``PIECE`` in decode_split.cuh) is walked in pieces with the online
    rescale: real rows stay within the derived bound and equal, bit for bit,
    single-query launches at their positions."""
    rng = np.random.default_rng(bs + int8)
    B, H, KV, D, NB, SQ = 4, 8, 1, 256, 4, 4
    pos_l = [SQ + 2, bs + 700, NB * bs - 1, 10_000]  # the last lane is dead
    k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
    q = _randn(rng, (B, SQ, H, D), cuda_device)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
    q_lens = torch.tensor([SQ, 1, SQ, 1], dtype=torch.int32, device=cuda_device)
    kw = dict(block_size=bs, paged_len=NB * bs)
    out = decode_attn.paged_decode_attention(q, k, v, tables, pos, q_lens, **kw)
    ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, q_lens, **kw)
    v_abs = (quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs())
    mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables, pos,
                                             q_lens, **kw)
    torch.cuda.synchronize()
    real = (torch.arange(SQ, device=cuda_device)[None, :]
            >= SQ - q_lens[:, None])
    real[3] = False
    res = attention.kernel_tolerance(out[real], ref[real], mag[real])
    assert res["ok"], res
    for j in range(SQ):
        one = decode_attn.paged_decode_attention(
            q[:, j:j + 1].contiguous(), k, v, tables, pos - (SQ - 1) + j, **kw)
        rows = real[:, j]
        assert torch.equal(out[rows, j], one[rows, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_decode_kernels_at_a_working_set_past_l2(cuda_device, kernel):
    """The two bandwidth cases ``chip_smoke.py`` times, within the derived
    bound: paged int8 at Gemma-2B heads over 64 lanes at position 4095
    (tile 16, permuted tables, ~136 MB of KV) and dense bf16 over 32 rows
    at position 4095 (~134 MB)."""
    rng = np.random.default_rng(5)
    if kernel == "dense":
        B, S = 32, 4096
        q = _randn(rng, (B, 1, 8, 256), cuda_device)
        k = _randn(rng, (B, S, 1, 256), cuda_device)
        v = _randn(rng, (B, S, 1, 256), cuda_device)
        p = torch.tensor(S - 1, dtype=torch.int32, device=cuda_device)
        out = decode_attn.decode_attention(q, k, v, p)
        ref = decode_attn.decode_attention_reference(q, k, v, p)
        mag = decode_attn.decode_attention_reference(q.float(), k.float(),
                                                     v.abs().float(), p)
    else:
        B, bs, NB = 64, 16, 256
        pos_l = [NB * bs - 1] * B
        k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, 1, 256, True,
                                   pos_l)
        q = _randn(rng, (B, 1, 8, 256), cuda_device)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
        kw = dict(block_size=bs, paged_len=NB * bs)
        out = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
        ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
        mag = decode_attn.paged_decode_reference(
            q.float(), k, quant.QTensor(v.q.abs(), v.scale), tables, pos, **kw)
    torch.cuda.synchronize()
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_decode_kernels_take_any_order_of_shapes(cuda_device, kernel):
    """Every instantiation of one head size shares its combine kernel: a
    long view, then a short view through another instantiation (bf16 after
    int8, or another group size), then the long view again all launch and
    stay within the derived bound. D = 64 with G = 2 is used by no other
    card test, so the second instantiation launches here first."""
    rng = np.random.default_rng(31)
    D = 64
    if kernel == "dense":
        def call(H, KV, S):
            q = _randn(rng, (2, 1, H, D), cuda_device)
            k = _randn(rng, (2, S, KV, D), cuda_device)
            v = _randn(rng, (2, S, KV, D), cuda_device)
            p = torch.tensor(S - 1, dtype=torch.int32, device=cuda_device)
            out = decode_attn.decode_attention(q, k, v, p)
            ref = decode_attn.decode_attention_reference(q, k, v, p)
            mag = decode_attn.decode_attention_reference(q.float(), k.float(),
                                                         v.abs().float(), p)
            return out, ref, mag

        steps = [(8, 1, 4096), (4, 2, 256), (8, 1, 4096)]
    else:
        def call(int8, NB):
            bs, pos_l = 16, [NB * 16 - 1, NB * 8]
            k, v, tables = _paged_pool(rng, cuda_device, 2, NB, bs, 2, D, int8,
                                       pos_l)
            q = _randn(rng, (2, 1, 4, D), cuda_device)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
            kw = dict(block_size=bs, paged_len=NB * bs)
            v_abs = quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs()
            out = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
            ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
            mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables,
                                                     pos, **kw)
            return out, ref, mag

        steps = [(True, 256), (False, 16), (True, 256)]
    for args in steps:
        out, ref, mag = call(*args)
        torch.cuda.synchronize()
        res = attention.kernel_tolerance(out, ref, mag)
        assert res["ok"], (args, res)


def _bits(t):
    """A tensor's bytes as integers, so that equality is bit equality."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _leaves(arena):
    return [t for c in arena
            for t in (c if isinstance(c, quant.QTensor) else (c,))]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_paged", "reference"])
@pytest.mark.parametrize("decode_steps", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_decode_graph_replay_is_bit_equal_to_eager(cuda_device, paged, kv_quant,
                                                   decode_steps, backend):
    """The server's second decode chunk (capture, then the first replay)
    against the same chunk run eagerly on a clone of the arena from the
    same inputs: tokens, last, pos and every arena byte equal; the paged
    kernel's launches are counted once per replayed layer step (none with
    the plain decode attention, which the graph captures as well)."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_quant=kv_quant, overlap=False, decode_steps=decode_steps,
              decode_attn=backend)
    if paged:
        kw.update(kv_pool_tokens=4096, kv_block_size=16)
    srv = GenerationServer(params, cfg, **kw)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 40)
    srv.step()  # admission, then the warm-up chunk
    exe = srv._decode
    assert (exe.captures, exe.replays) == (0, 0)
    per_chunk = exe.steps * cfg.n_layers if backend == "cuda_paged" else 0
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if paged else srv.arena
    clone = [t.clone() for t in _leaves(arena)]
    eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2]) for i in range(2)
                        ) if kv_quant else tuple(clone)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    extra = {}
    if decode_steps > 1:
        extra["budget"] = dev(srv._decode_budget())
    if paged:
        extra["block_tables"] = dev(srv._bt_host)
    tok, pos = dev(srv._last), dev(srv._pos)
    want = serve_decode(params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, **extra, **exe._kw)
    d0 = decode_attn.paged_decode_attention.launches
    got = exe(tok, pos, **extra)
    torch.cuda.synchronize()
    assert (exe.captures, exe.replays) == (1, 1)
    assert exe.capture_s > 0 and exe.pool_bytes > 0
    assert decode_attn.paged_decode_attention.launches - d0 == per_chunk
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(_leaves(arena), clone):
        assert torch.equal(_bits(a), _bits(c))
    # The rest of the run (which decodes the compared chunk again from the
    # host's state): every chunk a replay, counted.
    d0 = decode_attn.paged_decode_attention.launches
    rounds = srv.stats()["rounds"]
    srv.run()
    stats = srv.stats()
    assert stats["decode_graph_replays"] == 1 + stats["rounds"] - rounds
    assert (decode_attn.paged_decode_attention.launches - d0
            == (stats["rounds"] - rounds) * per_chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("decode_steps", [1, 4], ids=["K1", "K4"])
def test_overlapped_server_replays_every_chunk_after_the_first(cuda_device,
                                                              decode_steps):
    """The default server (overlapped rounds) over a pool that preempts:
    every budget returned, the pool empty at the end, one capture, every
    chunk after the warm-up a replay, and the paged kernel's launches
    counted through the replays."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    srv = GenerationServer(params, cfg, max_batch=6, max_len=512,
                           prefill_buckets=(128, 256), chunk=4,
                           kv_pool_tokens=768, kv_block_size=16,
                           decode_steps=decode_steps)
    rng = np.random.default_rng(1)
    budgets = [int(b) for b in rng.integers(40, 81, 8)]
    rids = [srv.submit(rng.integers(0, 512, n), b)
            for n, b in zip(rng.integers(100, 129, 8), budgets)]
    d0 = decode_attn.paged_decode_attention.launches
    out = srv.run()
    stats = srv.stats()
    assert srv.overlap and stats["decode_steps"] == decode_steps
    assert [len(out[r]) for r in rids] == budgets
    assert stats["preemptions"] >= 1 and stats["kv_blocks_in_use"] == 0
    assert stats["decode_graph_captures"] == 1
    assert stats["decode_graph_replays"] == stats["rounds"] - 1
    assert (decode_attn.paged_decode_attention.launches - d0
            == stats["rounds"] * 4 * decode_steps * cfg.n_layers)


@pytest.mark.cuda
def test_fences_keep_their_own_pinned_buffers(cuda_device):
    """A fence's copy lands in pinned buffers of its own: a tensor changed
    and fenced again after the first fence leaves the first fence's values
    as they were when it was made, read or unread."""
    from kata_xpu_device_plugin_tpu_torch.obs.trace import DeviceFence

    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda_device)
    first = DeviceFence(x=x)
    x.add_(7)
    second = DeviceFence(x=x)
    x.add_(7)
    assert all(b.is_pinned() for b in (first._bufs["x"], second._bufs["x"]))
    want = np.arange(1 << 20, dtype=np.int32)
    np.testing.assert_array_equal(second.wait()["x"], want + 7)
    np.testing.assert_array_equal(first.wait()["x"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("group", range(1, 9))
@pytest.mark.parametrize("kernel", ["paged-int8", "paged-bf16", "dense"])
def test_decode_kernels_take_every_group(cuda_device, kernel, group):
    """Every GQA group 1-8 (Qwen2-7B's is 7) within the derived bound of
    the plain version, and a second launch gives the same bits."""
    rng = np.random.default_rng(group)
    B, KV, D, bs, NB = 3, 2, 128, 16, 8
    H = group * KV
    q = _randn(rng, (B, 1, H, D), cuda_device)
    if kernel == "dense":
        k = _randn(rng, (B, NB * bs, KV, D), cuda_device)
        v = _randn(rng, (B, NB * bs, KV, D), cuda_device)
        p = torch.tensor(NB * bs - 30, dtype=torch.int32, device=cuda_device)
        run = lambda: decode_attn.decode_attention(q, k, v, p)  # noqa: E731
        ref = decode_attn.decode_attention_reference(q, k, v, p)
        mag = decode_attn.decode_attention_reference(
            q.float(), k.float(), v.abs().float(), p)
    else:
        int8 = kernel == "paged-int8"
        pos_l = [0, 3 * bs - 1, NB * bs - 1]
        k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
        kw = dict(block_size=bs, paged_len=NB * bs)
        run = lambda: decode_attn.paged_decode_attention(  # noqa: E731
            q, k, v, tables, pos, **kw)
        ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
        v_abs = quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs()
        mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables,
                                                 pos, **kw)
    out = run()
    torch.cuda.synchronize()
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res
    assert torch.equal(out, run())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_sampled_decode_graph_replays_the_eager_draws(cuda_device, paged):
    """A sampled chunk by capture and replay against the same chunk eager,
    from the same generator state (restored with get_state/set_state):
    tokens, last, pos and every arena byte equal. A replay without the
    restore draws fresh numbers."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    # Every lane live: no dead lane writes the scratch block (whose
    # duplicate writes land in no fixed order once lanes sample). This
    # narrow random model's next-token distribution is nearly one-hot at
    # temperature 1 (a draw would repeat itself), so it samples hot.
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              overlap=False, temperature=1000.0, top_k=100, top_p=0.99,
              seed=7)
    if paged:
        kw.update(kv_pool_tokens=4096, kv_block_size=16)
    srv = GenerationServer(params, cfg, **kw)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 40)
    srv.step()
    srv._ensure_blocks()
    exe = srv._decode
    arena = srv.kv_pool.arena if paged else srv.arena
    clone = [t.clone() for t in _leaves(arena)]
    eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2]) for i in range(2))

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    extra = {"block_tables": dev(srv._bt_host)} if paged else {}
    tok, pos = dev(srv._last), dev(srv._pos)
    state = srv.generator.get_state()
    want = serve_decode(params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, **extra, **exe._kw)
    srv.generator.set_state(state)
    got = [t.clone() for t in exe(tok, pos, **extra)]
    torch.cuda.synchronize()
    assert (exe.captures, exe.replays) == (1, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(_leaves(arena), clone):
        assert torch.equal(_bits(a), _bits(c))
    again = exe(tok, pos, **extra)
    assert not torch.equal(again[0], got[0])


@pytest.mark.cuda
def test_family_flags_serve_on_the_card(cuda_device):
    """Narrow Qwen2 (group 7, biases) through the paged kernel, and Gemma-2
    and Gemma-3 flags (window cycles, post-norms, QK-norm, rope cycles,
    softcaps) on the plain decode path by the config's rule, sampled and
    greedy: every budget returned in vocabulary, and a sampled run repeats
    under its seed."""
    from kata_xpu_device_plugin_tpu_torch import models

    cfgs = {
        "qwen2": models.qwen2_7b(n_layers=2, vocab_size=512, d_model=896,
                                 d_ff=1024, n_heads=7, n_kv_heads=1),
        "gemma2": models.gemma2_2b(n_layers=2, vocab_size=512, d_model=512,
                                   d_ff=1024, attn_windows=(96, 0)),
        "gemma3": models.gemma3_4b(n_layers=6, vocab_size=512, d_model=512,
                                   d_ff=1024, attn_windows=(96,) * 5 + (0,),
                                   rope_theta_cycle=(1e4,) * 5 + (1e6,),
                                   rope_linear_cycle=(1.0,) * 5 + (8.0,)),
    }
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n) for n in (100, 130, 200, 60)]
    for name, cfg in cfgs.items():
        params = transformer.fuse_decoder_params(init_params(
            cfg, seed=0, device=cuda_device, dtype=torch.bfloat16))
        kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256),
                  kv_pool_tokens=4096, kv_block_size=16)
        runs = []
        for sample in ({}, dict(temperature=0.7, top_k=50, top_p=0.9, seed=0),
                       dict(temperature=0.7, top_k=50, top_p=0.9, seed=0)):
            srv = GenerationServer(params, cfg, **kw, **sample)
            rids = [srv.submit(p, 40) for p in prompts]
            out = srv.run()
            runs.append([out[r] for r in rids])
            stats = srv.stats()
            want = ("cuda_paged", "") if name == "qwen2" else (
                "reference", "sliding_window")
            assert (stats["decode_backend"], stats["decode_backend_reason"]) == want
            assert stats["decode_graph_replays"] == stats["rounds"] - 1
        for run in runs:
            assert all(len(t) == 40 and ((t >= 0) & (t < 512)).all() for t in run)
        assert all(np.array_equal(a, b) for a, b in zip(runs[1], runs[2]))
        # generate(): the windowed configs decode with the plain attention
        # (no decode kernel launch); sampled runs repeat under one seed.
        prompt = rng.integers(0, 512, (2, 150))
        p0 = decode_attn.paged_decode_attention.launches
        toks = [transformer.generate(
            params, prompt, cfg, 12, temperature=0.7, top_k=50,
            generator=torch.Generator(device=cuda_device).manual_seed(3))
            for _ in range(2)]
        assert torch.equal(toks[0], toks[1]) and toks[0].shape == (2, 12)
        launched = decode_attn.paged_decode_attention.launches - p0
        assert launched == (22 * cfg.n_layers if name == "qwen2" else 0)


def _persistent_server(cuda_device, paged, **extra):
    """A 2-layer Gemma-2B-head server holding 4 admitted requests (no
    round run yet), its tables grown for a persistent round."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              overlap=False, **extra)
    if paged:
        kw.update(kv_pool_tokens=4096, kv_block_size=16)
    srv = GenerationServer(params, cfg, **kw)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 300)
    srv._admit()
    srv._ensure_blocks()
    return srv, params, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("sub_steps", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_persistent_graph_is_bit_equal_to_eager_at_each_exit(cuda_device, paged,
                                                             sub_steps):
    """A persistent round by CUDA graph (after one eager warm-up round)
    against the same round eager (``_decode_while``) on a clone of the
    arena, from the same inputs, at each exit: the cap, a lane done on its
    budget, a lane at its window edge. Tokens, ``delivered``, ``tok``,
    ``pos`` and every arena byte equal; the paged kernel's launches are
    the steps the graph ran x layers; fewer than ``sub_steps`` of them
    past the exit."""
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import PersistentRound
    from kata_xpu_device_plugin_tpu_torch.models.transformer import _decode_while

    srv, params, cfg = _persistent_server(cuda_device, paged, persistent=True)
    old = srv._round
    rnd = PersistentRound(params, old.arena, cfg, batch=4, cap=old.cap,
                          device=cuda_device, sub_steps=sub_steps,
                          decode_kernel_fn=old.decode_kernel_fn,
                          table_width=0 if old._tables is None
                          else old._tables.shape[1], **old._kw)
    arena = srv.kv_pool.arena if paged else srv.arena
    leaves = _leaves(arena)
    snap = [t.clone() for t in leaves]

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    tok, pos = dev(srv._last), dev(srv._pos)
    window0 = srv._persistent_window()
    tables = dev(srv._bt_host) if paged else None
    edge = window0.copy()
    edge[1] = srv._pos[1] + 6
    cases = {"cap": ([300] * 4, window0, old.cap),
             "done": ([5, 300, 300, 300], window0, 5),
             "window": ([300] * 4, edge, 6)}
    rnd(tok, pos, dev([5, 300, 300, 300]), dev(window0), tables)  # warm-up
    assert (rnd.captures, rnd.replays) == (0, 0)
    for name, (budget, window, want_d) in cases.items():
        for t, c in zip(leaves, snap):
            t.copy_(c)
        clone = [t.clone() for t in snap]
        eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2])
                            for i in range(2))
        w_out, _, w_tok, w_pos, w_d = _decode_while(
            params, eager_arena, tok, pos, dev(budget), dev(window), cfg,
            rnd.cap, attn_fn=attention.reference_attention,
            block_tables=tables, decode_kernel_fn=rnd.decode_kernel_fn,
            sub_steps=sub_steps, **rnd._kw)
        d0 = decode_attn.paged_decode_attention.launches
        out, g_tok, g_pos, delivered = rnd(tok, pos, dev(budget), dev(window),
                                           tables)
        torch.cuda.synchronize()
        assert rnd.captures == 1, name
        assert delivered == int(w_d) == want_d, name
        assert torch.equal(out[:, :delivered], w_out[:, :delivered]), name
        assert torch.equal(g_tok, w_tok) and torch.equal(g_pos, w_pos), name
        for a, c in zip(leaves, clone):
            assert torch.equal(_bits(a), _bits(c)), name
        assert (decode_attn.paged_decode_attention.launches - d0
                == rnd.executed * cfg.n_layers), name
        assert 0 <= rnd.executed - delivered < sub_steps, name


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_fused_dispatch_is_bit_equal_to_the_sequential_pair(cuda_device, paged):
    """One decode chunk by graph replay with an admission slice beside it
    on a side stream (``DecodeGraph.fused``) against the same replay and
    the same slice run one after the other on the current stream, from
    the same arena and slice caches: the chunk's tokens, ``last``,
    ``pos``, the slice's logits, every arena byte and every byte of the
    slice's caches equal."""
    srv, params, cfg = _persistent_server(cuda_device, paged)
    srv.step()  # the eager warm-up chunk
    srv.step()  # the capture, then a replay
    srv._ensure_blocks()
    exe = srv._decode
    assert exe.captures == 1
    rng = np.random.default_rng(9)
    p_caches = transformer.init_kv_caches(cfg, 1, 512, device=cuda_device,
                                          quantized=True)
    first = torch.from_numpy(rng.integers(0, 512, (1, 128))).to(cuda_device)
    transformer.prefill_suffix(params, first, cfg, p_caches, 0, true_len=100)
    sfx = torch.from_numpy(rng.integers(0, 512, (1, 128))).to(cuda_device)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    kw = {"block_tables": dev(srv._bt_host)} if paged else {}
    tok, pos = dev(srv._last), dev(srv._pos)
    leaves = _leaves(srv.kv_pool.arena if paged else srv.arena) + _leaves(p_caches)
    snap = [t.clone() for t in leaves]

    def slice_fn():
        return transformer.prefill_suffix(params, sfx, cfg, p_caches, 100,
                                          return_logits=True, true_len=90)[1]

    out, logits = exe.fused(slice_fn, tok, pos, **kw)
    torch.cuda.synchronize()
    fused = [t.clone() for t in (*out, logits)]
    fused_leaves = [t.clone() for t in leaves]
    for t, c in zip(leaves, snap):
        t.copy_(c)
    out2 = exe(tok, pos, **kw)
    seq = [t.clone() for t in (*out2, slice_fn())]
    torch.cuda.synchronize()
    assert exe.replays >= 3
    for f, q in zip(fused, seq):
        assert torch.equal(_bits(f), _bits(q))
    for f, t in zip(fused_leaves, leaves):
        assert torch.equal(_bits(f), _bits(t))


@pytest.mark.cuda
def test_persistent_and_chunked_servers_on_the_card(cuda_device):
    """Persistent rounds over a pool that preempts, and chunked fused
    admission, against the lock-step server on the same requests: equal
    tokens; exits partition the rounds; the paged kernel's launches are
    the steps the rounds ran x layers; chunks rode decode dispatches."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=6, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_pool_tokens=1024, kv_block_size=16)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n), int(b))
            for n, b in zip(rng.integers(100, 250, 10), rng.integers(20, 61, 10))]

    def serve(**extra):
        srv = GenerationServer(params, cfg, **kw, **extra)
        rids = [srv.submit(p, b) for p, b in reqs]
        d0 = decode_attn.paged_decode_attention.launches
        out = srv.run()
        return ([out[r] for r in rids], srv.stats(),
                decode_attn.paged_decode_attention.launches - d0)

    base, _, _ = serve(overlap=False)
    got, st, launched = serve(persistent=True)
    assert all(np.array_equal(a, b) for a, b in zip(got, base))
    assert sum(st["persistent_exits"].values()) == st["persistent_rounds"] > 0
    assert st["preemptions"] >= 1 and st["kv_blocks_in_use"] == 0
    assert launched == st["persistent_steps_executed"] * cfg.n_layers
    assert st["persistent_graph_captures"] == 1
    got, st, _ = serve(sched_policy="slo_chunked", itl_slo_ms=0.0,
                       prefill_chunk=128)
    assert all(np.array_equal(a, b) for a, b in zip(got, base))
    assert st["sched_chunks"] > 0 and st["fused_admissions"] > 0
