"""PyTorch port, flash forward: the tile schedule of the forward kernel
(``ops.flash.fwd_schedule``, the plain-Python model of the loop bounds,
the masked tiles and the grid order in ``csrc/flash_fwd.cu``) at every
head width's tiles. For causal and full attention, with and without a
window, at lengths a 128-row block does not divide (160, 320) and at
S = 128 with one batch row: every live (q, key) pair is visited exactly
once a q head, no warpgroup visits a tile without a live pair, exactly the
tiles that hold a masked pair apply the mask, no key past the frontier is
read, and the longest blocks launch first. Kernel-versus-plain checks on
the card are in ``test_torch_cuda.py``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash

KV = 2
SHAPES = [  # (S, window): 160 and 320 end in a part q tile and key tile
    (128, 0), (160, 0), (256, 64), (320, 0), (320, 96), (512, 200),
]
MASKS = ([(S, w, True) for S, w in SHAPES]
         + [(S, 0, False) for S in (128, 160, 320)])  # a window implies causal
SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use


def _live(S, causal, window):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    if not causal:
        return np.ones((S, S), bool)
    ok = k <= q
    if window > 0:
        ok &= k > q - window
    return ok


def _pairs(S, qw, k0, D):
    """Rows and keys of a warpgroup tile, clipped to the sequence."""
    _, NK, _ = tflash.fwd_tiles(D)
    return slice(qw, min(qw + tflash.FWD_WG_ROWS, S)), slice(k0, min(k0 + NK, S))


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,window,causal", MASKS)
def test_every_live_pair_is_visited_once_a_head(D, G, S, window, causal):
    H = KV * G
    sched = tflash.fwd_schedule(S, S, H, KV, D, causal, window)
    count = np.zeros((H, S, S), np.int32)
    for blk in sched:
        for qw, k0, _ in blk["visits"]:
            rows, keys = _pairs(S, qw, k0, D)
            count[blk["head"], rows, keys] += 1
    live = np.broadcast_to(_live(S, causal, window), (H, S, S))
    assert (count[live] == 1).all()
    assert (count <= 1).all()  # a masked pair at most once, in a live tile
    assert {(b["head"], b["q0"]) for b in sched} == {
        (h, q0) for h in range(H) for q0 in range(0, S, tflash.fwd_tiles(D)[0])}


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,window,causal", MASKS)
def test_visited_tiles_hold_a_live_pair_and_masked_ones_are_marked(
        D, S, window, causal):
    """No warpgroup tile without a live pair runs its products; a tile
    applies the mask exactly when one of its pairs (keys past the sequence
    included) is masked, so interior tiles take none."""
    _, NK, _ = tflash.fwd_tiles(D)
    live = np.zeros((S, S + NK), bool)
    live[:, :S] = _live(S, causal, window)
    masked_tiles = 0
    for blk in tflash.fwd_schedule(S, S, 2, 1, D, causal, window):
        for qw, k0, masked in blk["visits"]:
            tile = live[qw:min(qw + tflash.FWD_WG_ROWS, S), k0:k0 + NK]
            assert tile.any()
            assert masked == (not tile.all())
            masked_tiles += masked
    if causal or S % NK:
        assert masked_tiles  # the diagonal or the sequence's end masks
    else:
        assert not masked_tiles


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,window,causal", MASKS)
def test_the_ring_reads_no_key_past_the_frontier(D, S, window, causal):
    """A block fills its ring from the key tile of its first row's window
    edge up to its last row's causal frontier, each tile once, in order;
    in self-attention the last tile ends at the frontier, and rows past the
    sequence are zero-filled, not read. Each warpgroup adds its tiles up in
    ascending key order."""
    BQ, NK, _ = tflash.fwd_tiles(D)
    for blk in tflash.fwd_schedule(S, S, 2, 1, D, causal, window):
        q0, last = blk["q0"], min(blk["q0"] + BQ, S) - 1
        k0s = [k0 for k0, _ in blk["loads"]]
        assert k0s == list(range(k0s[0], k0s[-1] + 1, NK))
        edge = max(0, q0 - window + 1) if causal and window else 0
        assert k0s[0] == edge // NK * NK
        read_end = k0s[-1] + blk["loads"][-1][1]
        assert read_end == (min(S, last + 1) if causal else S)
        assert all(0 < n <= NK for _, n in blk["loads"])
        for qw in {qw for qw, _, _ in blk["visits"]}:
            ks = [k0 for w, k0, _ in blk["visits"] if w == qw]
            assert ks == sorted(set(ks)) and set(ks) <= set(k0s)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("B,S", [(1, 128), (4, 320), (2, 1024)])
def test_launch_order_puts_the_longest_blocks_first(D, B, S):
    """Causal: q tiles of longer key ranges launch first, then the batch
    rows, the q heads of one KV head side by side. One batch row at S = 128
    is one block a head."""
    G = 4
    H = KV * G
    sched = tflash.fwd_schedule(S, S, H, KV, D, True, 0, B)
    BQ = tflash.fwd_tiles(D)[0]
    assert len(sched) == B * H * -(-S // BQ)
    lengths = [len(b["loads"]) for b in sched]
    assert lengths == sorted(lengths, reverse=True)
    assert [b["head"] for b in sched[:H]] == list(range(H))
    assert [b["kv_head"] for b in sched[:H]] == [h // G for h in range(H)]
    assert [b["row"] for b in sched[:H * B:H]] == list(range(B))
    q0s = [b["q0"] for b in sched]
    assert q0s == sorted(q0s, reverse=True)


@pytest.mark.parametrize("D", tflash.KERNEL_HEAD_DIMS)
def test_tiles_fit_the_kernel_instantiations(D):
    """A block's q rows are whole 64-row warpgroup products; a stage's keys
    are a multiple of the 16-row k-step of O += p V and at most the 256
    columns of S = Q K^T; the Q tiles and the ring fit the shared memory a
    block may use."""
    BQ, NK, stages = tflash.fwd_tiles(D)
    assert BQ == tflash.FWD_WARPGROUPS * tflash.FWD_WG_ROWS
    assert tflash.FWD_WG_ROWS == 64
    assert NK % 16 == 0 and 16 <= NK <= 256
    assert stages >= 2
    # Cfg<D>::SMEM: 1 KB of alignment, the Q tiles, the ring's K and V
    # stages, two 8-byte barriers a stage.
    smem = 1024 + BQ * D * 2 + stages * 2 * NK * D * 2 + 16 * stages
    assert smem <= SMEM_LIMIT
