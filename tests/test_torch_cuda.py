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
from kata_xpu_device_plugin_tpu_torch.guest.tp_serving import ServingMesh
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


def _prefix_server(cuda_device, **extra):
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=6, max_len=512, prefill_buckets=(128, 256, 512),
              chunk=4, **extra)
    return GenerationServer(params, cfg, **kw), params, cfg


@pytest.mark.cuda
def test_staged_resume_upload_is_bit_equal_beside_a_replay(cuda_device):
    """Over a pool that preempts, with a host tier: each resume upload
    staged on the side stream right after a dispatch, while that chunk's
    graph replays, lands the same bits as a plain upload of the spill on
    the main stream; the run's tokens equal the tier-less server's and
    every resume consumed a staged upload."""
    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import rows_to_device

    pool = dict(kv_pool_tokens=768, kv_block_size=16)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n), int(b))
            for n, b in zip(rng.integers(100, 129, 8), rng.integers(40, 81, 8))]

    def serve(srv):
        rids = [srv.submit(p, b) for p, b in reqs]
        out = srv.run()
        return [out[r] for r in rids]

    base_srv, params, cfg = _prefix_server(cuda_device, **pool)
    base = serve(base_srv)
    srv = GenerationServer(params, cfg, max_batch=6, max_len=512,
                           prefill_buckets=(128, 256, 512), chunk=4,
                           kv_host_tokens=2048, **pool)
    stage, checks = srv._stage_resume_prefetch, []

    def checking():
        before = srv._stage
        stage()
        st = srv._stage
        if st is None or st is before:
            return
        replaying = srv._inflight is not None and srv._decode.replays > 0
        spill = srv._preempted[0].kv
        assert all(t.is_pinned() for t in _leaves(spill))
        plain = rows_to_device(spill, cuda_device)
        torch.cuda.current_stream().wait_event(st.done)
        checks.append((replaying, all(
            torch.equal(_bits(a), _bits(b))
            for a, b in zip(_leaves(st.rows), _leaves(plain)))))

    srv._stage_resume_prefetch = checking
    got = serve(srv)
    stats = srv.stats()
    assert all(np.array_equal(a, b) for a, b in zip(got, base))
    assert stats["preemptions"] >= 1
    assert stats["kv_resume_staged"] == stats["preemptions"]
    assert checks and all(eq for _, eq in checks)
    assert any(replaying for replaying, _ in checks)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 48], ids=["aligned", "cow"])
def test_masked_commit_leaves_shared_blocks_untouched(cuda_device, bs):
    """A 256-token head cached in the tier, then hits admitted in one
    batched scatter and alone: every byte of the tier's blocks (int8
    payload and scales) is what it was before the hits; at a tile of 48
    the boundary block is copied on write instead."""
    srv, _params, _cfg = _prefix_server(cuda_device, kv_pool_tokens=4096,
                                        kv_block_size=bs, prefix_cache_tokens=1)
    rng = np.random.default_rng(4)
    head = rng.integers(0, 512, 256)
    srv.submit(np.concatenate([head, rng.integers(0, 512, 20)]), 8)
    srv.run()
    (seg,) = srv.prefix_store._segments
    pool = srv.kv_pool

    def rows():
        return [torch.cat([_bits(t[:, 0, blk * bs:(blk + 1) * bs]).clone()
                           for blk in seg.blocks], dim=1)
                for t in _leaves(pool.arena)]

    before = rows()
    for n in (10, 40, 70, 100, 30):
        srv.submit(np.concatenate([head, rng.integers(0, 512, n)]), 12)
    srv.run()
    srv.submit(np.concatenate([head, rng.integers(0, 512, 50)]), 12)
    srv.run()
    stats = srv.stats()
    assert stats["prefix_hits"] == 6 and stats["prefill_batches"] >= 1
    assert (stats["cow_copies"] > 0) == (bs == 48)
    for a, b in zip(rows(), before):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_decode_graph_replay_over_shared_and_cow_blocks_is_bit_equal(cuda_device):
    """Lanes whose tables share tier blocks and hold copy-on-write
    boundary blocks (tile 48, a 256-token match): the server's chunk by
    graph replay against the same chunk run eagerly on a clone of the
    pool, tokens, last, pos and every pool byte equal."""
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode

    bs = 48
    srv, params, cfg = _prefix_server(cuda_device, kv_pool_tokens=4096,
                                      kv_block_size=bs, prefix_cache_tokens=1,
                                      overlap=False)
    rng = np.random.default_rng(5)
    head = rng.integers(0, 512, 256)
    srv.submit(np.concatenate([head, rng.integers(0, 512, 20)]), 16)
    srv.run()  # the eager warm-up chunk and the capture
    for n in (10, 40, 70, 100):
        srv.submit(np.concatenate([head, rng.integers(0, 512, n)]), 40)
    srv.step()
    exe = srv._decode
    assert exe.captures == 1 and srv.stats()["cow_copies"] == 4
    held = [blk for t in srv._lane_blocks for blk in t]
    assert any(held.count(blk) == 4 for blk in srv.prefix_store._segments[0].blocks)
    srv._ensure_blocks()
    arena = srv.kv_pool.arena
    clone = [t.clone() for t in _leaves(arena)]
    eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2]) for i in range(2))

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    tables = dev(srv._bt_host)
    tok, pos = dev(srv._last), dev(srv._pos)
    want = serve_decode(params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, block_tables=tables, **exe._kw)
    got = exe(tok, pos, block_tables=tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(_leaves(arena), clone):
        assert torch.equal(_bits(a), _bits(c))


def _sharded_pool(rng, dev, tp, bs, KV, D, int8, B=4, keys=512):
    """A block-sharded pool of ``tp`` sub-pools and four lanes over it:
    lane 0's blocks all on shard 0, lane 1's all on the last shard (its
    table ZERO past its position), lane 2's alternating between shards,
    lane 3 dead (a stale position) over random blocks of every shard."""
    NB = keys // bs
    nbl = 2 * NB + 2
    NT = tp * nbl * bs
    k = _randn(rng, (1, NT, KV, D), dev)
    v = _randn(rng, (1, NT, KV, D), dev)
    k[0, :bs] = 0.0
    v[0, :bs] = 0.0
    last = (tp - 1) * nbl
    pos = [keys - 1, keys // 2 + 44, keys - 1, 10_000][:B]
    tables = np.stack([
        np.arange(2, 2 + NB),
        last + np.arange(NB),
        np.array([(j % tp) * nbl + 2 + j for j in range(NB)]),
        rng.integers(2, tp * nbl, NB),
    ]).astype(np.int32)[:B]
    tables[1, pos[1] // bs + 1:] = 0
    if int8:
        k, v = quant.quantize_kv(k), quant.quantize_kv(v)
    return (k, v, torch.from_numpy(tables).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), nbl)


def _shard(c, s, rows):
    if isinstance(c, quant.QTensor):
        return quant.QTensor(c.q[:, s * rows:(s + 1) * rows],
                             c.scale[:, s * rows:(s + 1) * rows])
    return c[:, s * rows:(s + 1) * rows]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(8, 1, 256), (28, 4, 128)],
                         ids=["gemma2b", "qwen2_7b"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_shard_local_paged_decode_matches_plain(cuda_device, H, KV, D, tp, bs,
                                                int8):
    """The shard-local form (K2): each shard's ``(acc, m, l)`` against the
    plain shard-local version within the derived statistics bound (its
    normalised output within the kernels' bound), exact zeros where a
    shard holds none of a row's tiles; the merged output bit-equal to the
    unsharded kernel for the lanes whose blocks lie on one shard and
    within the kernels' bound of the plain version for every live lane;
    a relaunch gives the same bits."""
    rng = np.random.default_rng(bs + tp + KV + int8)
    k, v, tables, pos, nbl = _sharded_pool(rng, cuda_device, tp, bs, KV, D,
                                           int8)
    q = _randn(rng, (4, 1, H, D), cuda_device)
    kw = dict(block_size=bs, paged_len=512)
    v_abs = quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs()
    parts = []
    before = decode_attn.paged_decode_shard_stats.launches
    for s in range(tp):
        ks, vs = _shard(k, s, nbl * bs), _shard(v, s, nbl * bs)
        shard = dict(shard_lo=s * nbl, shard_blocks=nbl)
        got = decode_attn.paged_decode_shard_stats(q, ks, vs, tables, pos, **kw,
                                                   **shard)
        again = decode_attn.paged_decode_shard_stats(q, ks, vs, tables, pos,
                                                     **kw, **shard)
        want = decode_attn.paged_decode_split_reference(
            q, ks, vs, tables, pos, **kw, **shard, return_stats=True)
        mag = decode_attn.paged_decode_split_reference(
            q.float(), ks, _shard(v_abs, s, nbl * bs), tables, pos, **kw, **shard,
            return_stats=True)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(_bits(a), _bits(b))
        live = want[1][:3] > attention.NEG_INF / 2  # dead lane 3 left out
        res = decode_attn.shard_stats_tolerance(
            [t[:3] for t in got], [t[:3] for t in want], q, ks)
        assert res["ok"], (s, res)
        rows = decode_attn.from_stat_rows(live, 1)
        norm = [t[0][:3][rows] / decode_attn.from_stat_rows(t[2][:3], 1)[rows][
            ..., None] for t in (got, want, mag)]
        res = attention.kernel_tolerance(norm[0].to(torch.bfloat16), norm[1],
                                         norm[2])
        assert res["ok"], (s, res)
        parts.append(got)
    assert decode_attn.paged_decode_shard_stats.launches == before + 2 * tp
    merged = attention.merge_shard_stats(parts, q.dtype)
    whole = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(merged[:2]), _bits(whole[:2]))
    ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables, pos,
                                             **kw)
    res = attention.kernel_tolerance(merged[:3], ref[:3], mag[:3])
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["heads", "blocks"])
def test_tp_server_graph_chunk_is_bit_equal_to_eager(cuda_device, layout):
    """A ``tp=2`` paged server's decode chunk (capture, then the first
    replay) against the same chunk run eagerly on a clone of the pool:
    tokens and every pool byte equal; each replayed layer step counts one
    kernel launch a shard; the run ends with the pool empty."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_quant=True, overlap=False, kv_pool_tokens=4096,
              kv_block_size=16, tp=2, kv_layout=layout)
    srv = GenerationServer(params, cfg, **kw)
    assert srv.stats()["tp_degree"] == 2
    assert srv.stats()["kv_pool_shards"] == (2 if layout == "blocks" else 1)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 40)
    srv.step()  # admission, then the warm-up chunk
    exe = srv._decode
    per_chunk = exe.steps * cfg.n_layers * 2
    srv._ensure_blocks()
    arena = srv.kv_pool.arena
    clone = [t.clone() for t in _leaves(arena)]
    eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2]) for i in range(2))

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    tok, pos, bt = dev(srv._last), dev(srv._pos), dev(srv._bt_host)
    want = serve_decode(srv.params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, block_tables=bt, **exe._kw)
    counter = (decode_attn.paged_decode_shard_stats if layout == "blocks"
               else decode_attn.paged_decode_attention)
    d0 = counter.launches
    got = exe(tok, pos, block_tables=bt)
    torch.cuda.synchronize()
    assert (exe.captures, exe.replays) == (1, 1)
    assert counter.launches - d0 == per_chunk
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(_leaves(arena), clone):
        assert torch.equal(_bits(a), _bits(c))
    srv.run()
    assert srv.kv_pool.blocks_in_use == 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_decode_reads_a_head_view_in_place(cuda_device, int8, tp):
    """A head-sharded pool's shard is a view of some KV heads of the pool
    (row stride KV heads, not the view's): the kernel reads it in place,
    and a shard's output is bit-equal to the same query heads of the whole
    kernel's (each KV head's rows are independent), over the slotted
    arena's re-view too."""
    rng = np.random.default_rng(tp + int8)
    B, H, KV, D, bs, NB = 4, 32, 8, 128, 16, 8
    pos_l = [0, bs * NB - 1, 40, 10_000]
    k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
    q = _randn(rng, (B, 1, H, D), cuda_device)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
    kw = dict(block_size=bs, paged_len=NB * bs)
    whole = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
    n, g = KV // tp, H // tp
    for s in range(tp):
        def heads(c):
            return (quant.QTensor(c.q[:, :, s * n:(s + 1) * n],
                                  c.scale[:, :, s * n:(s + 1) * n])
                    if int8 else c[:, :, s * n:(s + 1) * n])

        assert not (heads(k).q if int8 else heads(k)).is_contiguous()
        part = decode_attn.paged_decode_attention(
            q[:, :, s * g:(s + 1) * g].contiguous(), heads(k), heads(v), tables,
            pos, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(part), _bits(whole[:, :, s * g:(s + 1) * g]))
    fn = attention.make_decode_attn_fn(
        replace_cfg(H, KV, D), arena_len=NB * bs, device=cuda_device)
    arena = [_randn(rng, (B, NB * bs, KV, D), cuda_device) for _ in range(2)]
    full = fn(q, *arena, None, pos.clamp(max=NB * bs - 1))
    for s in range(tp):
        part = fn(q[:, :, s * g:(s + 1) * g].contiguous(),
                  *(a[:, :, s * n:(s + 1) * n] for a in arena), None,
                  pos.clamp(max=NB * bs - 1))
        assert torch.equal(_bits(part), _bits(full[:, :, s * g:(s + 1) * g]))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_heads_form_shards_share_one_kv_head(cuda_device, int8, tp):
    """Gemma-2B's one KV head under the heads layout: each shard's kernel
    call takes its own H/tp query heads over that head (a group of
    H/tp), and the shards' outputs are bit-equal to the same query heads
    of the whole kernel's (each query head's rows are independent)."""
    rng = np.random.default_rng(10 * tp + int8)
    B, H, KV, D, bs, NB = 4, 8, 1, 256, 16, 8
    pos_l = [0, bs * NB - 1, 40, 10_000]
    k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
    q = _randn(rng, (B, 1, H, D), cuda_device)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
    cfg = replace_cfg(H, KV, D)
    kw = dict(paged=True, block_size=bs, paged_len=NB * bs, device=cuda_device)
    whole = attention.make_decode_attn_fn(cfg, **kw)(q, k, v, tables, pos)
    mesh = ServingMesh.for_config(cfg, tp, cuda_device)
    before = decode_attn.paged_decode_attention.launches
    outs = attention.make_decode_attn_fn(cfg, mesh=mesh, **kw)(
        q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert decode_attn.paged_decode_attention.launches == before + tp
    assert [o.shape[2] for o in outs] == [H // tp] * tp
    assert torch.equal(_bits(torch.cat(outs, dim=2)), _bits(whole))


def replace_cfg(H, KV, D):
    from dataclasses import replace

    return replace(gemma_2b(), n_heads=H, n_kv_heads=KV, head_dim=D)


# ----- the ring block API (K1) and the ring ------------------------------------

BLOCK_CASES = [  # (S, H, KV, D, q_off, k_off, window, softcap)
    (256, 8, 2, 128, 512, 512, 0, 0.0),       # diagonal
    (256, 8, 2, 128, 768, 0, 0, 0.0),         # wholly below the diagonal
    (256, 4, 1, 256, 512, 0, 300, 50.0),      # window with dead rows, cap
    (320, 4, 2, 64, 640, 320, 200, 0.0),      # part tiles, window across
    (256, 8, 1, 256, 256, 256, 100, 30.0),    # windowed diagonal, MQA
    (256, 4, 4, 128, 0, 256, 0, 0.0),         # wholly above: no live pair
]


def _block_inputs(rng, dev, S, H, KV, D):
    q, k, v, do = _qkv_do(rng, dev, 1, S, H, KV, D)
    dlse = torch.from_numpy(rng.standard_normal((1, H, S), np.float32)).to(dev)
    return q, k, v, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,D,q_off,k_off,window,softcap", BLOCK_CASES)
def test_block_kernels_match_plain(cuda_device, S, H, KV, D, q_off, k_off,
                                   window, softcap):
    """K1 at global offsets: the forward's out on the live rows within
    ``kernel_tolerance`` of the plain version, its lse within the fp32
    bound; a row with no live key finite with lse <= NEG_INF / 2; the
    backward under a nonzero random ``dlse`` within the bound
    ``backward_magnitudes`` derives (with the dlse term); a relaunch of
    each gives the same bits; launches counted apart from self-attention's,
    one count for each of the three kernels."""
    q, k, v, do, dlse = _block_inputs(np.random.default_rng(S + q_off + D),
                                      cuda_device, S, H, KV, D)
    kw = dict(causal=True, window=window, softcap=softcap)
    counters = (flash.flash_block_forward, flash.flash_block_bwd_dq,
                flash.flash_block_bwd_dkv)
    n_block = [fn.launches for fn in counters]
    n_self = flash.flash_forward.launches, flash.flash_bwd_dq.launches
    out, lse = flash.flash_block_forward(q, k, v, q_off, k_off, **kw)
    got = flash.flash_block_backward(q, k, v, out, lse, do, dlse, q_off, k_off, **kw)
    again = (*flash.flash_block_forward(q, k, v, q_off, k_off, **kw),
             *flash.flash_block_backward(q, k, v, out, lse, do, dlse, q_off,
                                         k_off, **kw))
    ref, ref_lse = flash.flash_reference(q, k, v, q_off=q_off, k_off=k_off, **kw)
    mag, _ = flash.flash_reference(q.float(), k.float(), v.abs().float(),
                                   q_off=q_off, k_off=k_off, **kw)
    want = flash.flash_backward_reference(q, k, v, out, lse, do, q_off=q_off,
                                          k_off=k_off, dlse=dlse, **kw)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do, q_off=q_off,
                                     k_off=k_off, dlse=dlse, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [n + 2 for n in n_block]
    assert (flash.flash_forward.launches, flash.flash_bwd_dq.launches) == n_self
    live = flash.live_rows(S, S, True, window, q_off, k_off).to(cuda_device)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (lse[:, :, ~live] <= attention.NEG_INF / 2).all()
    if live.any():
        res = attention.kernel_tolerance(out[:, live], ref[:, live], mag[:, live])
        assert res["ok"], res
        torch.testing.assert_close(lse[:, :, live], ref_lse[:, :, live],
                                   atol=1e-4, rtol=1e-5)
    else:  # no tile visited: the TPU kernel's finalize gives 0
        assert not out.any()
    for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
        assert torch.isfinite(a.float()).all()
        res = attention.kernel_tolerance(a, b, m)
        assert res["ok"], (name, res)
    for a, b in zip((out, lse, *got), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_block_kernels_at_random_offsets(cuda_device):
    """K1 at offsets that fall anywhere in a tile (seeded draws of the
    offsets, the window and the cap, at each head width): the forward's
    live rows and lse, the dead rows' rule and the backward with a random
    ``dlse``, each within its bound."""
    rng = np.random.default_rng(12)
    for i in range(9):
        D = (64, 128, 256)[i % 3]
        q_off, k_off = (int(x) for x in rng.integers(0, 1024, 2))
        window = int(rng.integers(1, 600)) if i % 2 else 0
        softcap = 30.0 if i % 4 == 1 else 0.0
        kw = dict(causal=True, window=window, softcap=softcap)
        off = dict(q_off=q_off, k_off=k_off)
        q, k, v, do, dlse = _block_inputs(rng, cuda_device, 256, 4, 2, D)
        out, lse = flash.flash_block_forward(q, k, v, q_off, k_off, **kw)
        got = flash.flash_block_backward(q, k, v, out, lse, do, dlse, q_off,
                                         k_off, **kw)
        ref, ref_lse = flash.flash_reference(q, k, v, **off, **kw)
        mag, _ = flash.flash_reference(q.float(), k.float(), v.abs().float(),
                                       **off, **kw)
        want = flash.flash_backward_reference(q, k, v, out, lse, do, dlse=dlse,
                                              **off, **kw)
        mags = flash.backward_magnitudes(q, k, v, out, lse, do, dlse=dlse,
                                         **off, **kw)
        torch.cuda.synchronize()
        case = (D, q_off, k_off, window, softcap)
        live = flash.live_rows(256, 256, True, window, q_off, k_off).to(cuda_device)
        assert torch.isfinite(out.float()).all(), case
        assert (lse[:, :, ~live] <= attention.NEG_INF / 2).all(), case
        if live.any():
            res = attention.kernel_tolerance(out[:, live], ref[:, live],
                                             mag[:, live])
            assert res["ok"], (case, res)
            torch.testing.assert_close(lse[:, :, live], ref_lse[:, :, live],
                                       atol=1e-4, rtol=1e-5)
        for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
            res = attention.kernel_tolerance(a, b, m)
            assert res["ok"], (case, name, res)


def _plain_ring(n, q, k, v, **kw):
    from kata_xpu_device_plugin_tpu_torch.parallel import ring, seq_mesh

    mesh = seq_mesh(n, devices=[q.device])
    return ring.make_ring_attention(mesh, use_flash=False)(q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,KV,D,window,softcap", [
    (4, 8, 2, 128, 0, 0.0), (4, 4, 2, 256, 300, 50.0), (2, 8, 1, 64, 0, 0.0),
])
def test_ring_with_k1_matches_the_plain_ring(cuda_device, monkeypatch, n, H,
                                             KV, D, window, softcap):
    """The ring through the K1 kernels (``use_flash=None`` engages them on
    the card) against the plain einsum ring on the same bf16 inputs: the
    merged output within ``ring_tolerance``; every block's backward call,
    under the cotangents the merge hands it, within its derived bound; one
    forward and one backward launch a live pair."""
    from kata_xpu_device_plugin_tpu_torch.parallel import ring, seq_mesh

    S = 256 * n
    q, k, v, do = _qkv_do(np.random.default_rng(n + H + D), cuda_device, 1, S,
                          H, KV, D)
    checks, real = [], flash.flash_block_backward

    def checked(q_, k_, v_, out, lse, dout, dlse, q_off, k_off, causal,
                window, softcap):
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = real(q_, k_, v_, out, lse, dout, dlse, q_off, k_off, **kw)
        want = flash.flash_backward_reference(q_, k_, v_, out, lse, dout,
                                              q_off=q_off, k_off=k_off,
                                              dlse=dlse, **kw)
        mags = flash.backward_magnitudes(q_, k_, v_, out, lse, dout,
                                         q_off=q_off, k_off=k_off, dlse=dlse,
                                         **kw)
        checks.extend(attention.kernel_tolerance(a, b, m)
                      for a, b, m in zip(got, want, mags))
        return got

    monkeypatch.setattr(flash, "flash_block_backward", checked)
    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    counters = (flash.flash_block_forward, flash.flash_block_bwd_dq,
                flash.flash_block_bwd_dkv)
    n_block = [fn.launches for fn in counters]
    kw = dict(window=window, logits_softcap=softcap)
    out = ring.make_ring_attention(seq_mesh(n, devices=[cuda_device]))(*xs, **kw)
    torch.autograd.grad(out, xs, do)
    pairs = sum(min(i, ring._ring_hops(n, 256, window)) + 1
                for i in range(n))
    assert [fn.launches for fn in counters] == [n + pairs for n in n_block]
    assert len(checks) == 3 * pairs
    assert all(c["ok"] for c in checks), [c for c in checks if not c["ok"]]
    with torch.no_grad():
        ref = _plain_ring(n, q, k, v, **kw)
        mag = _plain_ring(n, q.float(), k.float(), v.abs().float(), **kw)
    res = attention.ring_tolerance(out.detach(), ref, mag)
    assert res["ok"], res


@pytest.mark.cuda
def test_ring_on_the_card_raises_without_a_block_kernel(cuda_device):
    """``use_flash=None`` on a CUDA tensor runs the K1 kernels or fails: a
    shard length with no flash block raises instead of running the einsum
    ring on the card; ``use_flash=False`` still takes the plain ring."""
    from kata_xpu_device_plugin_tpu_torch.parallel import ring, seq_mesh

    q, k, v, _ = _qkv_do(np.random.default_rng(3), cuda_device, 1, 400, 4, 2, 64)
    mesh = seq_mesh(4, devices=[cuda_device])
    n_f = flash.flash_block_forward.launches
    with pytest.raises(ValueError, match="no flash block kernel"):
        ring.make_ring_attention(mesh)(q, k, v)
    out = ring.make_ring_attention(mesh, use_flash=False)(q, k, v)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert flash.flash_block_forward.launches == n_f


# ----- telemetry on the card -------------------------------------------------


@pytest.mark.cuda
def test_span_fence_waits_for_a_long_kernel(cuda_device):
    """A span fenced on a CUDA tensor ends after the work that produces it:
    its duration covers a long chain of matmuls queued on the stream, where
    the unfenced span measures only their launch."""
    from kata_xpu_device_plugin_tpu_torch import obs

    a = torch.randn(4096, 4096, device=cuda_device)
    (a @ a).sum()  # the first matmul sets cuBLAS up on the host
    torch.cuda.synchronize()
    with obs.span("unfenced") as loose:
        b = a
        for _ in range(40):
            b = b @ a
    with obs.span("fenced") as tight:
        c = a
        for _ in range(40):
            c = c @ a
        tight.fence(c)
    queued = torch.cuda.Event()
    queued.record()
    assert queued.query(), "the fenced span returned before its work finished"
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(40):
        c = c @ a
    t1.record()
    t1.synchronize()
    device_s = t0.elapsed_time(t1) / 1e3
    assert tight.duration_s >= 0.5 * device_s > loose.duration_s


@pytest.mark.cuda
def test_strict_mode_raises_on_a_sync_in_the_round(cuda_device):
    """``strict=True`` guards the overlapped round: a clean server runs, a
    host read of the card injected into the round raises and leaves the
    guard off; the sanctioned regions (admission, the fence's retire, the
    graph capture) pass."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.compat import torchapi

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_pool_tokens=1024, kv_block_size=16, strict=True)
    prompts = [np.arange(1, n, dtype=np.int32) for n in (40, 90, 130)]
    srv = GenerationServer(params, cfg, **kw)
    for p in prompts:
        srv.submit(p, 24)
    out = srv.run()
    assert [len(v) for v in out.values()] == [24] * 3
    assert srv.stats()["decode_graph_captures"] == 1
    bad = GenerationServer(params, cfg, **kw)
    real = bad._dispatch_decode

    def with_sync(tok, pos):
        torch.ones(1, device=cuda_device).sum().item()
        return real(tok, pos)

    bad._dispatch_decode = with_sync
    bad.submit(prompts[0], 8)
    with pytest.raises(RuntimeError, match="synchroniz"):
        bad.run()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert torchapi.strict_depth() == 0


@pytest.mark.cuda
def test_hbm_fields_follow_the_allocator(cuda_device):
    """The ledger's ``hbm_*`` fields on the card: used and peak are the
    allocator's, the limit the card's, the headroom at most the limit, and
    the server's components (params, pool) attributed at their bytes."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    srv = GenerationServer(params, cfg, max_batch=4, max_len=512,
                           prefill_buckets=(128, 256), chunk=4,
                           kv_pool_tokens=1024, kv_block_size=16,
                           heartbeat_rounds=2)
    srv.submit(np.arange(1, 100, dtype=np.int32), 16)
    srv.run()
    fields = srv._devledger.poll_memory()
    free, total = torch.cuda.mem_get_info()
    assert fields["hbm_used_bytes"] == torch.cuda.memory_allocated()
    assert fields["hbm_peak_bytes"] >= torch.cuda.max_memory_allocated() - 1
    assert fields["hbm_limit_bytes"] == total
    assert 0 < fields["hbm_headroom_bytes"] <= total
    arena = sum(t.numel() * t.element_size() for c in srv.kv_pool.arena
                for t in (c if isinstance(c, tuple) else (c,)))
    assert fields["hbm_kv_arena_bytes"] == arena
    assert fields["hbm_params_bytes"] >= sum(
        t.numel() * t.element_size() for t in
        [params["embed"], params["final_norm"], *params["layers"].values()])
    assert fields["hbm_attributed_bytes"] == sum(
        v for k, v in fields.items()
        if k.startswith("hbm_") and k[4:-6] in srv._hbm_components())
    st = srv.stats()
    assert st["devledger"]["hbm_stats_available"] == 1
    assert 0 < st["mfu"] <= 1 and 0 < st["device_busy_frac"] <= 1


@pytest.mark.cuda
def test_real_oom_classifies_transient(cuda_device):
    """An allocation past the card's memory raises ``torch.cuda.
    OutOfMemoryError``, which the supervisor's triage calls TRANSIENT (the
    JAX server's ``RESOURCE_EXHAUSTED``)."""
    from kata_xpu_device_plugin_tpu_torch.guest import resilience

    free, total = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)
    assert resilience.classify(err.value) == resilience.TRANSIENT
    assert resilience.recoverable(err.value)


@pytest.mark.cuda
def test_graph_pools_are_released_across_rebuilds(cuda_device):
    """Ten cycles of requests: in the first a shrink (tp=4 -> 2, an
    injected chip loss) rebuilds the decode graph, in the last eight a
    forced rebuild does, and each cycle's requests capture the new graph:
    after ``empty_cache()`` the card's reserved bytes do not grow from one
    cycle to the next (each dropped graph's pool is freed), and every cycle
    after the shrink gives the same tokens."""
    import gc
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.guest.resilience import (
        FaultInjector,
        FaultSpec,
    )

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    srv = GenerationServer(
        params, cfg, max_batch=4, max_len=512, prefill_buckets=(128, 256),
        chunk=4, kv_pool_tokens=4096, kv_block_size=16, tp=4,
        kv_layout="blocks", recovery_backoff_s=0.0,
        fault_injector=FaultInjector([FaultSpec("decode_dispatch", 1,
                                                "chip_loss", 1)]))
    prompts = [np.arange(1, n, dtype=np.int32) for n in (40, 90, 130)]
    reserved, outs = [], []
    for cycle in range(10):
        if cycle > 1:
            srv._build_decode()  # what a shrink does to the graphs
        rids = [srv.submit(p, 24) for p in prompts]
        res = srv.run()
        outs.append([res[r].tolist() for r in rids])
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    st = srv.stats()
    assert st["tp_degree"] == 2 and st["tp_shrinks"] == 1
    assert st["decode_graph_captures"] == 9
    assert all(o == outs[1] for o in outs[1:])
    assert max(reserved[2:]) <= reserved[1], reserved


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8-kv", "bf16-kv"])
@pytest.mark.parametrize("cycle", [False, True], ids=["ring", "cycle"])
def test_ring_decode_graph_replay_is_bit_equal_to_eager(cuda_device, cycle,
                                                        kv_quant):
    """A ``ring_kv`` server's second decode chunk (capture, then the first
    replay) over a ring of 64 slots (``cycle``: the cycle arena of a (64,
    0) window cycle, a ring and a 512-slot global arena) against the same
    chunk run eagerly on a clone of the arena: tokens, last, pos and every
    arena byte equal. The lanes sit past the window, so the chunk's writes
    wrap; the slots and their positions come from the captured ``pos`` on
    the card. Then every later chunk a replay."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode
    from kata_xpu_device_plugin_tpu_torch.guest.kv_arena import map_rows
    from kata_xpu_device_plugin_tpu_torch.guest.prefix_cache import cache_leaves

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512,
                  sliding_window=0 if cycle else 64,
                  attn_windows=(64, 0) if cycle else ())
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    srv = GenerationServer(params, cfg, max_batch=4, max_len=512,
                           prefill_buckets=(128, 256), chunk=4,
                           kv_quant=kv_quant, overlap=False, ring_kv=True)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 40)
    srv.step()  # admission, then the warm-up chunk
    exe = srv._decode
    assert (exe.captures, exe.replays) == (0, 0)
    assert srv.stats()["decode_backend_reason"] == "ring_kv"
    clone = map_rows(srv.arena, torch.clone)

    def dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(cuda_device)

    tok, pos = dev(srv._last), dev(srv._pos)
    want = serve_decode(params, clone, tok, pos, cfg, exe.steps, None,
                        **exe._kw)
    got = exe(tok, pos)
    torch.cuda.synchronize()
    assert (exe.captures, exe.replays) == (1, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(cache_leaves(srv.arena), cache_leaves(clone)):
        assert torch.equal(_bits(a), _bits(c))
    rounds = srv.stats()["rounds"]
    srv.run()
    stats = srv.stats()
    assert stats["decode_graph_replays"] == 1 + stats["rounds"] - rounds


# Where a speculative server's tokens part from the plain server's on the
# card, the plain path's logit gap between the two tokens there must be
# within the serving decode bound (chip_smoke.py LOGIT_BOUND["decode"],
# 0.35 x the logit RMS): an argmax flip between two bf16 summation orders,
# not a wrong token.
FLIP_BOUND_X_RMS = 0.35


@pytest.mark.cuda
def test_speculative_server_tokens_against_plain(cuda_device):
    """bf16 on the card: a ``[B, k+1]`` verify product and k+1 one-token
    products sum in different orders, so tokens may part on an argmax
    flip. The speculative server (n-gram, then the target as its own
    draft) against the plain lock-step server on the same requests: equal
    tokens, or, for every request that parts, a first parting where the
    plain logits put the plain server's token at most
    :data:`FLIP_BOUND_X_RMS` x the logit RMS above the speculative
    server's; the perfect draft accepts
    at least 0.9 of its drafts."""
    from dataclasses import replace

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 512, 16).astype(np.int32)
    prompts = [np.tile(seg, 8), np.tile(seg, 6),
               rng.integers(0, 512, 100).astype(np.int32),
               rng.integers(0, 512, 140).astype(np.int32)]
    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              kv_quant=False, overlap=False)

    def serve(**extra):
        srv = GenerationServer(params, cfg, **kw, **extra)
        rids = [srv.submit(p, 32) for p in prompts]
        res = srv.run()
        return [res[r] for r in rids], srv.stats()

    plain, _ = serve()
    for extra in (dict(speculative_k=3, spec_opt_in=True),
                  dict(speculative_k=3, spec_opt_in=True, draft=(params, cfg))):
        outs, st = serve(**extra)
        assert st["decode_backend_reason"] == "speculative"
        if extra.get("draft") is not None:
            assert st["draft_acceptance"] >= 0.9, st["draft_acceptance"]
        for i, (a, b) in enumerate(zip(outs, plain)):
            diff = np.flatnonzero(a != b)
            if not len(diff):
                continue
            j = int(diff[0])
            ctx = np.concatenate([prompts[i], b[:j]]).astype(np.int64)
            toks = torch.from_numpy(ctx)[None].to(cuda_device)
            _c, logits, _p = transformer.prefill(
                params, toks, cfg, len(ctx),
                attn_fn=attention.reference_attention, return_logits=True)
            lg = logits[0].float()
            gap = float(lg[int(b[j])] - lg[int(a[j])])
            rms = float(lg.square().mean().sqrt())
            assert gap <= FLIP_BOUND_X_RMS * rms, (i, j, gap, rms)


# ----- mixture of experts, LoRA, W8A8 ----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [2, 4])
def test_moe_dispatch_in_a_graph_is_bit_equal_to_eager(cuda_device, top_k):
    """``moe_ffn`` (routing, the sort dispatch, the counts by scatter, the
    expert MLPs and the ordered combine) captured in a CUDA graph: no host
    sync breaks the capture, and two replays give the eager output and aux
    bit for bit, at K = 2 and at K = 4 (where an atomic combine would
    not)."""
    from kata_xpu_device_plugin_tpu_torch.ops import moe

    cfg = moe.MoEConfig(d_model=512, d_ff=1024, num_experts=8, top_k=top_k,
                        capacity_factor=1.0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = moe.init_moe_params(cfg, gen, dtype=torch.bfloat16)
    x = torch.randn(2, 24, 512, device=cuda_device, generator=gen).to(torch.bfloat16)
    want, aux = moe.moe_ffn(p, x, cfg)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_ffn(p, x, cfg)  # warm on the side stream before capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, got_aux = moe.moe_ffn(p, x, cfg)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got_aux), _bits(aux))


def _small_mixtral():
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.models import mixtral_8x7b

    return replace(mixtral_8x7b(), n_layers=2, d_model=1024, n_heads=8,
                   n_kv_heads=2, d_ff=512, vocab_size=512)


def _chunk_replay_equals_eager(params, cfg, dev, paged: bool, **server_kw):
    """The server's second decode chunk by capture and first replay against
    the same chunk eager on a clone of the arena: tokens, last, pos and
    every arena byte equal; the paged kernel launched once a layer step
    and shard. ``server_kw`` (``tp``, ``mesh``) goes to the server."""
    from kata_xpu_device_plugin_tpu_torch.guest.decode_graph import serve_decode

    kw = dict(max_batch=4, max_len=512, prefill_buckets=(128, 256), chunk=4,
              overlap=False, **server_kw)
    if paged:
        kw.update(kv_pool_tokens=4096, kv_block_size=16)
    srv = GenerationServer(params, cfg, **kw)
    rng = np.random.default_rng(3)
    for n in (100, 130, 200, 60):
        srv.submit(rng.integers(0, 512, n), 40)
    srv.step()
    exe = srv._decode
    srv._ensure_blocks()
    arena = srv.kv_pool.arena if paged else srv.arena
    clone = [t.clone() for t in _leaves(arena)]
    eager_arena = tuple(quant.QTensor(*clone[2 * i: 2 * i + 2]) for i in range(2))

    def to_dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    extra = {"block_tables": to_dev(srv._bt_host)} if paged else {}
    tok, pos = to_dev(srv._last), to_dev(srv._pos)
    want = serve_decode(srv.params, eager_arena, tok, pos, cfg, exe.steps,
                        exe.decode_kernel_fn, **extra, **exe._kw)
    d0 = decode_attn.paged_decode_attention.launches
    got = exe(tok, pos, **extra)
    torch.cuda.synchronize()
    assert (exe.captures, exe.replays) == (1, 1)
    assert (decode_attn.paged_decode_attention.launches - d0
            == exe.steps * cfg.n_layers * srv.stats()["tp_degree"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, c in zip(_leaves(arena), clone):
        assert torch.equal(_bits(a), _bits(c))
    srv.run()
    return srv.stats()


@pytest.mark.cuda
@pytest.mark.parametrize("int8_experts", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_moe_decode_graph_replay_is_bit_equal_to_eager(cuda_device, paged,
                                                       int8_experts):
    """A Mixtral-shaped server (head_dim 128, 8 experts, top-2): its decode
    chunk's graph holds the MoE dispatch, and replay equals eager."""
    cfg = _small_mixtral()
    params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    if int8_experts:
        params = quant.quantize_decoder_params(params)
    stats = _chunk_replay_equals_eager(params, cfg, cuda_device, paged)
    assert stats["decode_graph_captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh-gemma-fused", "mesh-mixtral",
                                  "tp2-mixtral-int8"])
def test_mesh_and_moe_tp_decode_graph_replay_is_bit_equal_to_eager(cuda_device,
                                                                    case):
    """The two serving paths of a caller's mesh and of MoE under tp: a
    fused Gemma-shaped tree and a Mixtral-shaped one over fsdp 2 x model 2
    (each layer's fsdp gathers inside the graph), and the Mixtral-shaped
    tree with int8 experts at ``tp=2``: replay equals eager, the paged
    kernel once a shard a layer step."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.parallel.mesh import build_mesh

    if case == "mesh-gemma-fused":
        cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
        params = transformer.fuse_decoder_params(
            init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16))
    else:
        cfg = _small_mixtral()
        params = init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16)
    if case == "tp2-mixtral-int8":
        params = quant.quantize_decoder_params(params)
        kw = {"tp": 2}
    else:
        kw = {"mesh": build_mesh({"fsdp": 2, "model": 2})}
    for paged in (False, True):
        stats = _chunk_replay_equals_eager(params, cfg, cuda_device, paged, **kw)
        assert stats["tp_degree"] == 2 and stats["decode_graph_captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("qlora", [False, True], ids=["lora", "qlora"])
def test_lora_decode_graph_replay_is_bit_equal_to_eager(cuda_device, qlora):
    """A fused Gemma-shaped tree with adapters on ``wqkv`` and ``wo`` (their
    ``b`` drawn non-zero), plain and over an int8 base: replay equals
    eager."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.ops import lora

    cfg = replace(gemma_2b(), n_layers=2, vocab_size=512)
    params = transformer.fuse_decoder_params(
        init_params(cfg, seed=0, device=cuda_device, dtype=torch.bfloat16))
    if qlora:
        params = quant.quantize_decoder_params(params)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params = lora.apply_lora(params, gen, targets=("wqkv", "wo"))
    for k in ("wqkv", "wo"):
        params["layers"][k].b.normal_(0.0, 0.05, generator=gen)
    _chunk_replay_equals_eager(params, cfg, cuda_device, paged=True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 24, 40])
def test_int_mm_with_padded_rows_equals_the_cpu_dot(cuda_device, rows):
    """``quant.int8_matmul`` on the card (``torch._int_mm``, rows padded to
    its minimum and sliced back) against the exact int32 dot on the CPU,
    at the Gemma-2B ``wqkv`` and ``w_down`` shapes."""
    rng = np.random.default_rng(rows)
    for k, n in ((2048, 2560), (16384, 2048)):
        a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        got = quant.int8_matmul(a.to(cuda_device), b.to(cuda_device))
        assert got.dtype == torch.int32 and got.shape == (rows, n)
        assert torch.equal(got.cpu(), quant.int8_matmul(a, b))


# ----- training at scale: sharded steps, the pipeline, experts over a mesh -----

def _small_llama(**kw):
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.models import llama3_8b

    return replace(llama3_8b(), n_layers=2, vocab_size=512, d_model=256,
                   n_heads=4, n_kv_heads=2, d_ff=512, **kw)


def _flash_counts():
    return [f.launches for f in (flash.flash_forward, flash.flash_bwd_dq,
                                 flash.flash_bwd_dkv)]


@pytest.mark.cuda
def test_sharded_attention_blocks_match_the_whole_kernel(cuda_device):
    """``make_sharded_attention`` over data 2 x fsdp 2 x model 2 launches the
    forward kernel once a local block, each block a strided view of the
    whole tensor (no operand copied), and gives the whole launch's bits:
    the kernel computes each (row, head) alone. The gradients through the
    backward kernels lie within the derived bound of the plain version."""
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        build_mesh,
        make_sharded_attention,
    )

    mesh = build_mesh({"data": 2, "fsdp": 2, "model": 2})
    attn = make_sharded_attention(mesh, head_axis="model", kv_head_axis="model")
    q, k, v, do = _qkv_do(np.random.default_rng(3), cuda_device, 4, 256, 8, 4, 128)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    before, copies = _flash_counts(), flash._kernel_operand.copies
    out = attn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_flash_counts(), before)] == [8, 8, 8]
    assert flash._kernel_operand.copies == copies
    whole = flash.flash_forward(q.detach(), k.detach(), v.detach())
    torch.testing.assert_close(out.detach(), whole, atol=0, rtol=0)
    o, lse = flash.flash_forward(q.detach(), k.detach(), v.detach(),
                                 return_lse=True)
    want = flash.flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                          o, lse, do)
    mags = flash.backward_magnitudes(q.detach(), k.detach(), v.detach(), o,
                                     lse, do)
    for got, ref, mag in zip(grads, want, mags):
        assert attention.kernel_tolerance(got, ref, mag)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [{"fsdp": 2, "model": 2},
                                   {"data": 2, "fsdp": 2, "model": 2},
                                   {"fsdp": 2, "model": 2, "seq": 2}],
                         ids=["fsdp2-model2", "data2-fsdp2-model2", "seq2"])
def test_sharded_train_step_launches_per_local_block(cuda_device, shape):
    """A step over the mesh on the card: each layer launches each kernel
    once a local block (batch over data x fsdp, heads over model), or the
    K1 kernels once a live pair of each block's ring over seq; no operand
    is copied; the loss is finite and within 2e-2 of the unsharded step's
    first loss (bf16 products, partial sums rounded per model shard)."""
    from kata_xpu_device_plugin_tpu_torch.parallel import build_mesh, make_train_step

    cfg = _small_llama()
    toks = np.random.default_rng(0).integers(0, 512, (4, 256))
    _, ref_step = make_train_step(cfg)
    init_state, step = make_train_step(cfg, mesh=build_mesh(shape))
    _, ref_loss = ref_step(make_train_step(cfg)[0](0), toks)
    blocks = shape.get("data", 1) * shape.get("fsdp", 1) * shape.get("model", 1)
    kernels = (flash.flash_block_forward, flash.flash_block_bwd_dq,
               flash.flash_block_bwd_dkv) if "seq" in shape else (
        flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)
    before = [f.launches for f in kernels]
    copies = flash._kernel_operand.copies
    state, loss = step(init_state(0), toks)
    torch.cuda.synchronize()
    per = 3 if "seq" in shape else 1  # live pairs of a ring of 2
    assert [f.launches - b for f, b in zip(kernels, before)] == [
        cfg.n_layers * blocks * per] * 3
    assert flash._kernel_operand.copies == copies
    assert torch.isfinite(loss) and state["step"] == 1
    assert abs(float(loss) - float(ref_loss)) < 2e-2 * float(ref_loss)


@pytest.mark.cuda
def test_composed_step_runs_the_kernels_per_stage_block(cuda_device):
    """The composed pp x fsdp x tp step on (2, 2, 2) with 4 microbatches:
    M x layers x (fsdp x model) launches of each kernel a step, the
    bubbles skipped; its first loss close to the flat step's on the same
    model and batch."""
    from kata_xpu_device_plugin_tpu_torch.parallel import (
        build_mesh,
        composed_mesh,
        make_pp_train_step,
        make_train_step,
    )

    cfg = _small_llama()
    toks = np.random.default_rng(1).integers(0, 512, (4, 2, 256))
    init, step = make_pp_train_step(cfg, composed_mesh(2, 2, 2), 2, 4)
    before = _flash_counts()
    _, loss = step(init(0), toks)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_flash_counts(), before)] == [4 * 2 * 4] * 3
    flat_init, flat_step = make_train_step(
        cfg, mesh=build_mesh({"fsdp": 4, "model": 2}))
    _, flat_loss = flat_step(flat_init(0), toks.reshape(8, 256))
    assert abs(float(loss) - float(flat_loss)) < 1e-2 * float(flat_loss)


@pytest.mark.cuda
def test_moe_and_lora_steps_over_a_mesh_run_on_the_card(cuda_device):
    """A Mixtral-style step with experts over the model axis
    (``moe_ffn_sharded``) and a LoRA step over fsdp 2 x model 2 on the
    card: the kernels a local block, finite losses, the LoRA base
    unchanged."""
    from dataclasses import replace

    from kata_xpu_device_plugin_tpu_torch.models import mixtral_8x7b
    from kata_xpu_device_plugin_tpu_torch.ops import lora
    from kata_xpu_device_plugin_tpu_torch.parallel import build_mesh, make_train_step
    from kata_xpu_device_plugin_tpu_torch.parallel.sharding import local

    mesh = build_mesh({"fsdp": 2, "model": 2})
    cfg = replace(mixtral_8x7b(), n_layers=1, vocab_size=512, d_model=256,
                  n_heads=4, n_kv_heads=2, d_ff=256, moe_num_experts=4)
    init, step = make_train_step(cfg, mesh=mesh)
    before = _flash_counts()
    _, loss = step(init(0), np.random.default_rng(2).integers(0, 512, (4, 128)))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_flash_counts(), before)] == [4] * 3
    assert torch.isfinite(loss)
    lcfg = _small_llama()
    base = init_params(lcfg, seed=0, device="cuda")
    adapted = lora.apply_lora(base, torch.Generator(device="cuda").manual_seed(0))
    init_l, step_l = lora.make_lora_train_step(lcfg, lr=1e-3, mesh=mesh)
    state = init_l(adapted)
    before = _flash_counts()
    state, loss = step_l(state, np.random.default_rng(3).integers(0, 512, (2, 128)))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_flash_counts(), before)] == [2 * 4] * 3
    assert torch.isfinite(loss)
    assert torch.equal(local(state["params"]["layers"]["wq"].base),
                       base["layers"]["wq"])


@pytest.mark.cuda
def test_flash_kernels_at_the_bench_train_shape(cuda_device):
    """The three flash kernels at ``llama3_train_bench``'s train shape,
    head_dim 64 (``[16, 1024, 16/8, 64]``): the forward with its lse and
    both backward kernels within the derived bounds of the plain
    versions."""
    B, S, H, KV, D = 16, 1024, 16, 8, 64
    rng = np.random.default_rng(64)
    q, k, v, do = (_randn(rng, (B, S, n, D), cuda_device) for n in (H, KV, KV, H))
    out, lse = flash.flash_forward(q, k, v, return_lse=True)
    ref, ref_lse = flash.flash_reference(q, k, v)
    mag = attention.reference_attention(q.float(), k.float(), v.abs().float())
    torch.cuda.synchronize()
    res = attention.kernel_tolerance(out, ref, mag)
    assert res["ok"], res
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    del ref, ref_lse, mag
    got = flash.flash_backward(q, k, v, out, lse, do)
    want = flash.flash_backward_reference(q, k, v, out, lse, do)
    mags = flash.backward_magnitudes(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
        res = attention.kernel_tolerance(a, b, m)
        assert res["ok"], (name, res)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bs,NB", [(128, 1), (16, 8)])
def test_paged_decode_kernel_at_the_bench_width(cuda_device, int8, bs, NB):
    """The paged decode kernel at ``llama3_train_bench``'s heads (16/8,
    head_dim 64): one 128-row block a lane (the tile ``generate`` takes for
    the quality ladder's 96 positions) and 16-row blocks through permuted
    tables, within the derived bound of the plain version; the last lane
    is dead."""
    rng = np.random.default_rng(64 + bs + int8)
    B, H, KV, D = 4, 16, 8, 64
    pos_l = [0, NB * bs // 2, NB * bs - 1, 10_000]
    k, v, tables = _paged_pool(rng, cuda_device, B, NB, bs, KV, D, int8, pos_l)
    q = _randn(rng, (B, 1, H, D), cuda_device)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda_device)
    kw = dict(block_size=bs, paged_len=NB * bs)
    before = decode_attn.paged_decode_attention.launches
    out = decode_attn.paged_decode_attention(q, k, v, tables, pos, **kw)
    ref = decode_attn.paged_decode_reference(q, k, v, tables, pos, **kw)
    v_abs = (quant.QTensor(v.q.abs(), v.scale) if int8 else v.abs())
    mag = decode_attn.paged_decode_reference(q.float(), k, v_abs, tables, pos,
                                             **kw)
    torch.cuda.synchronize()
    assert decode_attn.paged_decode_attention.launches == before + 1
    res = attention.kernel_tolerance(out[:3], ref[:3], mag[:3])
    assert res["ok"], res


@pytest.mark.cuda
def test_bench_train_step_runs_the_flash_kernels_at_d64(cuda_device):
    """Two layers of ``llama3_train_bench`` (head_dim 64) under remat at
    S = 1024: the forward kernel twice a layer, each backward kernel once,
    a finite loss."""
    from kata_xpu_device_plugin_tpu_torch.models import llama3_train_bench
    from kata_xpu_device_plugin_tpu_torch.parallel import make_train_step

    cfg = llama3_train_bench(n_layers=2)
    init_state, step = make_train_step(cfg, remat=True)
    state = init_state(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1024))
    counts = [f.launches for f in (flash.flash_forward, flash.flash_bwd_dq,
                                   flash.flash_bwd_dkv)]
    state, loss = step(state, toks)
    torch.cuda.synchronize()
    after = [f.launches for f in (flash.flash_forward, flash.flash_bwd_dq,
                                  flash.flash_bwd_dkv)]
    assert [a - b for a, b in zip(after, counts)] == [4, 2, 2]
    assert torch.isfinite(loss)
