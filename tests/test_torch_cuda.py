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
    (4, 4, 64, False, 0, 0.0),
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
    q256 = torch.zeros(1, 128, 4, 256, device=cuda_device, dtype=torch.bfloat16)
    out, lse = flash.flash_forward(q256, q256, q256, return_lse=True)
    with pytest.raises(NotImplementedError, match="256"):
        flash.flash_backward(q256, q256, q256, out, lse, out)


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
    with pytest.raises(ValueError, match="sliding-window"):
        GenerationServer(params, replace(cfg, sliding_window=64), max_len=256,
                         prefill_buckets=(128,))
    srv = GenerationServer(params, cfg, max_len=512, prefill_buckets=(128,))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        srv.submit(np.zeros(200, np.int32), 4)
    assert GenerationServer(params, replace(cfg, sliding_window=64), max_len=256,
                            prefill_buckets=(128,), decode_attn="reference"
                            ).stats()["decode_backend"] == "reference"


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
