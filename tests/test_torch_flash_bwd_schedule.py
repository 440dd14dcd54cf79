"""PyTorch port, flash backward: the tile schedule of the two backward
kernels (``ops.flash.bwd_schedule``, the plain-Python model of the loop
bounds and grid order in ``csrc/flash_bwd.cu``) at every head width's
tiles. For causal and full attention, windows, lengths that are not a
multiple of a tile and GQA groups of 1, 4 and 8: each live (q, key) pair
reaches each gradient exactly once, each output row has one owner block,
and each block adds its tiles up in one fixed order (what makes a relaunch
give the same bits). Kernel-versus-plain checks on the card are in
``test_torch_cuda.py``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash

KV = 2
SHAPES = [  # (Sq, window): 160 and 224 end in a part tile
    (128, 0), (160, 0), (224, 96), (256, 64), (320, 200),
]


def _live(S, causal, window):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    if not causal:
        return np.ones((S, S), bool)
    ok = k <= q
    if window > 0:
        ok &= k > q - window
    return ok


def _coverage(sched, grad, S, H, D):
    """How often each (head, q, key) pair is visited by blocks summing
    ``grad``."""
    nk, nq = tflash.bwd_tiles(D)
    rows, cols = (tflash.BWD_TILE, nk) if grad == "dq" else (nq, tflash.BWD_TILE)
    kind = "dq" if grad == "dq" else "dkv"
    count = np.zeros((H, S, S), np.int32)
    for blk in sched[kind]:
        if grad not in blk["grads"]:
            continue
        for q0, k0, h in blk["visits"]:
            count[h, q0:q0 + rows, k0:k0 + cols] += 1
    return count


MASKS = ([(S, w, True) for S, w in SHAPES]
         + [(S, 0, False) for S in (128, 160)])  # a window implies causal


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S,window,causal", MASKS)
def test_every_live_pair_reaches_each_gradient_once(D, G, S, window, causal):
    """At a batch of 1 the dk/dv heads are split into groups (few blocks),
    at a batch of 64 into fewer or none; either way every pair once."""
    H = KV * G
    B = 1 if (S + G) % 2 else 64
    sched = tflash.bwd_schedule(S, S, H, KV, D, causal, window, B)
    live = np.broadcast_to(_live(S, causal, window), (H, S, S))
    for grad in ("dq", "dk", "dv"):
        count = _coverage(sched, grad, S, H, D)
        assert (count[live] == 1).all(), grad
        assert (count <= 1).all(), grad  # a masked pair at most once, in a tile


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,window", SHAPES)
@pytest.mark.parametrize("B", [1, 64])
def test_each_output_row_has_fixed_blocks_that_sum_in_a_fixed_order(D, S,
                                                                    window, B):
    """A dq row has one block; a dk or dv row one block a head group, the
    groups disjoint and covering the KV head's q heads (their partials are
    added in group order); each block adds its tiles up in one order."""
    G = 4
    H = KV * G
    sched = tflash.bwd_schedule(S, S, H, KV, D, True, window, B)
    nsplit = tflash.dkv_splits(B, S, H, KV, D)
    assert G % nsplit == 0
    owners = {}
    for i, blk in enumerate(sched["dq"]):
        assert all(q0 == blk["q0"] and h == blk["head"]
                   for q0, _, h in blk["visits"])
        ks = [k0 for _, k0, _ in blk["visits"]]
        assert ks == sorted(set(ks))  # ascending keys, each tile once
        for q in range(blk["q0"], min(blk["q0"] + tflash.BWD_TILE, S)):
            assert owners.setdefault(("dq", blk["head"], q), i) == i
    heads = {}
    for i, blk in enumerate(sched["dkv"]):
        group = range(blk["kv_head"] * G, (blk["kv_head"] + 1) * G)
        assert all(k0 == blk["k0"] and h in group for _, k0, h in blk["visits"])
        order = [(h, q0) for q0, _, h in blk["visits"]]
        assert order == sorted(set(order))  # head-major, ascending q tiles
        for g in blk["grads"]:
            for k in range(blk["k0"], min(blk["k0"] + tflash.BWD_TILE, S)):
                key = (g, blk["kv_head"], k, blk["split"])
                assert owners.setdefault(key, i) == i
            hs = heads.setdefault((g, blk["kv_head"], blk["k0"]), [])
            hs.append(sorted({h for _, _, h in blk["visits"]}))
    assert len(owners) == S * H + 2 * S * KV * nsplit
    for (_, kvh, k0), hs in heads.items():
        flat = [h for grp in hs for h in grp]
        assert len(hs) == nsplit and flat == sorted(set(flat))
        assert set(flat) <= set(range(kvh * G, (kvh + 1) * G))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_launch_order_puts_the_longest_blocks_first(D):
    """dq: q tiles of longer causal key ranges launch first and the q heads
    of one KV head side by side; dk/dv: lower key tiles (more q rows) first;
    at D = 256 a dv and a dk block for each key tile, side by side."""
    S, G = 320, 4
    H = KV * G
    sched = tflash.bwd_schedule(S, S, H, KV, D, True, 0, B=64)
    lengths = [len(b["visits"]) for b in sched["dq"]]
    assert lengths == sorted(lengths, reverse=True)
    assert [b["head"] for b in sched["dq"][:H]] == list(range(H))
    k0s = [b["k0"] for b in sched["dkv"]]
    assert k0s == sorted(k0s)
    grads = {b["grads"] for b in sched["dkv"]}
    assert grads == ({("dv",), ("dk",)} if D == 256 else {("dk", "dv")})


@pytest.mark.parametrize("B,Sk,H,KV,D,want", [
    (2, 2048, 32, 8, 128, 1),  # Llama-3-8B train: 512 blocks already
    (2, 2048, 8, 1, 256, 4),   # Gemma-2B train: 128 blocks, 4 head groups
    (2, 256, 16, 16, 256, 1),  # MHA: no group to split
    (1, 128, 8, 1, 64, 8),     # few blocks: one head a block
])
def test_dkv_splits_fill_the_grid_with_the_fewest_groups(B, Sk, H, KV, D, want):
    assert tflash.dkv_splits(B, Sk, H, KV, D) == want


def test_tiles_fit_the_kernel_instantiations():
    """Every width's dq keys and dk/dv q rows are multiples of the 16-row
    k-step of a warpgroup product, and at most the 64-row tile."""
    for D in tflash.BWD_HEAD_DIMS:
        for n in tflash.bwd_tiles(D):
            assert n % 16 == 0 and 16 <= n <= tflash.BWD_TILE
