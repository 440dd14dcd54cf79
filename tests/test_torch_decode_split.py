"""PyTorch port, decode attention: the CPU model of the two decode kernels'
split-K algorithm (``ops.decode_attn.paged_decode_split_reference``: chunk
partials on ``decode_chunks``' partition, then the ordered merge) against
the JAX Pallas kernel in interpret mode (fp32) and against the plain
version (bf16, within ``kernel_tolerance``); and the partition itself.
Kernel-versus-plain checks on the card are in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.ops import decode_attn as jdec
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.ops import attention as tatt
from kata_xpu_device_plugin_tpu_torch.ops import decode_attn as tdec
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant

# Same fp32 math on both sides; only the summation order differs.
TOL = dict(atol=1e-5, rtol=1e-5)
ZERO, SCRATCH = 0, 1


# ----- the partition ------------------------------------------------------------


@pytest.mark.parametrize("bs", [8, 16, 24, 40, 128, 256])
def test_chunks_cover_every_tile_once_and_depend_on_the_tile_alone(bs):
    tiles = {tdec.decode_chunks(bs, n)[0] for n in (1, 2, 7, 16, 33, 300)}
    assert len(tiles) == 1  # the grid never moves the cut
    T = tiles.pop()
    assert T * bs >= tdec.CHUNK_KEYS and (T - 1) * bs < tdec.CHUNK_KEYS
    for grid_k in (1, 2, 7, 16, 33, 300):
        _, n = tdec.decode_chunks(bs, grid_k)
        covered = [t for c in range(n) for t in range(c * T, min((c + 1) * T, grid_k))]
        assert covered == list(range(grid_k))
        assert (n - 1) * T < grid_k  # no chunk is empty


@pytest.mark.parametrize("S", [128, 512, 2048, 4096])
def test_dense_tile_and_slotted_re_view_cut_the_same_chunks(S):
    """The dense kernel's 128-key tile and the slotted arena's re-view tile
    (``dense_decode_tile``) give one chunk a tile, at every cache length
    ``generate`` pads to."""
    dense = tdec.decode_chunks(tdec.DENSE_BLOCK_K, S // tdec.DENSE_BLOCK_K)
    tile = tatt.dense_decode_tile(S)
    assert tile == tdec.DENSE_BLOCK_K
    assert dense == tdec.decode_chunks(tile, S // tile) == (1, S // 128)


# ----- the model against the JAX kernel -------------------------------------------


def _pool_case(seed, bs, SQ, B=4, H=8, KV=2, D=16):
    """``test_torch_ops._pool_case`` with a table wide enough for three
    chunks and a span of SQ rows: ZERO and SCRATCH entries past each lane's
    frontier, ragged positions (a block edge, the shortest span that fits,
    a partial last block), ragged query lengths and lane 3 dead with a
    stale position far past the view."""
    rng = np.random.default_rng(seed)
    NB = (5 * tdec.CHUNK_KEYS) // (2 * bs)  # 2.5 chunks
    paged_len = NB * bs - 2
    NT = (2 + B * NB) * bs
    q = rng.standard_normal((B, SQ, H, D), np.float32)
    pk = rng.standard_normal((1, NT, KV, D), np.float32)
    pv = rng.standard_normal((1, NT, KV, D), np.float32)
    pk[0, :bs] = 0.0
    pv[0, :bs] = 0.0
    pos = np.array([bs * 3 - 1, SQ - 1, paged_len - 1, 10_000], np.int32)
    q_lens = np.array([SQ, SQ, max(1, SQ - 1), 1], np.int32)
    tables = rng.permutation(B * NB).reshape(B, NB).astype(np.int32) + 2
    for b in range(3):
        tail = int(pos[b]) // bs + 1
        tables[b, tail:] = rng.choice([ZERO, SCRATCH], NB - tail)
    return q, pk, pv, tables, pos, q_lens, paged_len


def _torch_args(q, pk, pv, tables, pos, q_lens, int8, dtype=torch.float32):
    kt = torch.from_numpy(pk).to(dtype)
    vt = torch.from_numpy(pv).to(dtype)
    if int8:
        kt, vt = tquant.quantize_kv(kt), tquant.quantize_kv(vt)
    return (torch.from_numpy(q).to(dtype), kt, vt, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(q_lens))


@pytest.mark.parametrize("SQ", [1, 3, 4])
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32-pool", "int8-pool"])
def test_split_model_matches_jax_interpret(bs, int8, SQ):
    """Every row, padding and the dead lane's included: the JAX kernel's
    padding rows average the same visited keys the chunks do."""
    q, pk, pv, tables, pos, q_lens, plen = _pool_case(bs + SQ, bs, SQ)
    kj, vj = jnp.asarray(pk), jnp.asarray(pv)
    if int8:
        kj, vj = jquant.quantize_kv(kj), jquant.quantize_kv(vj)
    out_j = np.asarray(jdec.pallas_paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(q_lens), block_size=bs, paged_len=plen, interpret=True))
    args = _torch_args(q, pk, pv, tables, pos, q_lens, int8)
    out_t = tdec.paged_decode_split_reference(*args, block_size=bs,
                                              paged_len=plen).numpy()
    assert tdec.decode_chunks(bs, tables.shape[1])[1] == 3
    assert out_t.shape == q.shape and np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, **TOL)


# ----- the model in bf16, against the plain version --------------------------------


def _bf16_case(seed, bs, SQ, int8, B=4, H=8, KV=1, D=64, max_len=1024):
    rng = np.random.default_rng(seed)
    nb = max_len // bs
    pos = np.array([SQ - 1, 700, max_len - 1, 10_000], np.int32)
    q_lens = np.array([SQ, 1, SQ, SQ], np.int32)
    tables = rng.permutation(B * nb).reshape(B, nb).astype(np.int32) + 2
    for b in range(3):
        tables[b, int(pos[b]) // bs + 1:] = ZERO
    NT = (2 + B * nb) * bs
    pk = rng.standard_normal((1, NT, KV, D), np.float32)
    pv = rng.standard_normal((1, NT, KV, D), np.float32)
    pk[0, :bs] = pv[0, :bs] = 0.0
    q = rng.standard_normal((B, SQ, H, D), np.float32)
    args = _torch_args(q, pk, pv, tables, pos, q_lens, int8, torch.bfloat16)
    real = np.arange(SQ)[None, :] >= SQ - q_lens[:, None]
    real[3] = False  # a dead lane's rows are garbage on both sides
    return args, dict(block_size=bs, paged_len=max_len), torch.from_numpy(real)


def _v_abs(v):
    return tquant.QTensor(v.q.abs(), v.scale) if isinstance(v, tquant.QTensor) else v.abs()


@pytest.mark.parametrize("SQ", [1, 4])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
def test_split_model_within_kernel_tolerance_of_plain(bs, int8, SQ):
    (q, k, v, tables, pos, q_lens), kw, real = _bf16_case(bs + SQ, bs, SQ, int8)
    out = tdec.paged_decode_split_reference(q, k, v, tables, pos, q_lens, **kw)
    ref = tdec.paged_decode_reference(q, k, v, tables, pos, q_lens, **kw)
    mag = tdec.paged_decode_reference(q.float(), k, _v_abs(v), tables, pos,
                                      q_lens, **kw)
    assert out.dtype == torch.bfloat16
    res = tatt.kernel_tolerance(out[real], ref[real], mag[real])
    assert res["ok"], res
    assert res["max_abs_err"] > 0.0  # the roundings really differ


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
def test_split_model_span_rows_equal_single_query_calls(bs, int8):
    """A span's real row is, bit for bit, the single-query call at the
    row's own position: the chunks and each chunk's visited keys depend on
    that position alone."""
    SQ = 4
    (q, k, v, tables, pos, q_lens), kw, real = _bf16_case(7 + bs, bs, SQ, int8)
    out = tdec.paged_decode_split_reference(q, k, v, tables, pos, q_lens, **kw)
    for j in range(SQ):
        one = tdec.paged_decode_split_reference(
            q[:, j:j + 1].contiguous(), k, v, tables, pos - (SQ - 1) + j, **kw)
        rows = real[:, j]
        assert torch.equal(out[rows, j], one[rows, 0])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
def test_split_model_padding_rows_are_finite_and_bounded(int8):
    (q, k, v, tables, pos, q_lens), kw, real = _bf16_case(3, 16, 4, int8)
    q_lens = torch.tensor([1, 1, 2, 1], dtype=torch.int32)
    out = tdec.paged_decode_split_reference(q, k, v, tables, pos, q_lens, **kw)
    pad = torch.arange(4)[None, :] < 4 - q_lens[:, None]
    v_max = float(tquant.dequantize_kv(v, torch.float32).abs().max())
    assert pad.sum() == 11
    assert torch.isfinite(out[pad].float()).all()
    assert float(out[pad].float().abs().max()) <= v_max


def test_kernel_tolerance_refuses_a_merge_that_drops_a_lane_last_chunk():
    """After ``test_torch_ops``' dropped-split test: the merge over every
    live chunk is taken, the same merge without lane 2's last chunk (its
    position 1919 lies in chunk 14 of 16) is refused."""
    (q, k, v, tables, _pos, _ql), kw, _real = _bf16_case(11, 128, 1, False,
                                                         max_len=2048)
    pos = torch.tensor([31, 700, 1919, 1500], dtype=torch.int32)
    ref = tdec.paged_decode_reference(q, k, v, tables, pos, **kw)
    mag = tdec.paged_decode_reference(q.float(), k, v.abs(), tables, pos, **kw)
    acc, m, l, n_live = tdec._split_partials(q, k, v, tables, pos, **kw)
    assert n_live[:, 0].tolist() == [1, 6, 15, 12]
    full = tdec._merge_partials(acc, m, l, n_live, q.dtype)
    assert tatt.kernel_tolerance(full, ref, mag)["ok"]
    short = n_live.clone()
    short[2] -= 1
    res = tatt.kernel_tolerance(tdec._merge_partials(acc, m, l, short, q.dtype),
                                ref, mag)
    assert not res["ok"] and res["max_err_over_bound"] > 1.0
