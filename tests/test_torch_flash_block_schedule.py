"""PyTorch port, the ring block API's tile schedule (K1): the forward and
backward kernels' loop bounds and masked tiles at global offsets
(``ops.flash.fwd_schedule`` and ``bwd_schedule`` with ``q_off``/``k_off``,
the plain-Python models of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``)
against the brute-force live set of each block pair a causal ring meets:
the diagonal pair, pairs wholly below it, a pair wholly above it, windowed
pairs whose last rows see no key and pairs the window does not reach.
Every live pair is visited once a head (once a gradient), a tile applies
the mask exactly when one of its pairs is masked, a pair below the
diagonal applies it on no tile, and a pair with no live key visits
nothing. No JAX here; kernel-versus-plain checks are in
``test_torch_cuda.py``."""
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash

S, KV, G = 256, 2, 2  # a shard of 256 rows; 4 q heads over 2 KV heads
H = KV * G
PAIRS = {  # (q_off, k_off, window)
    "diagonal": (512, 512, 0),
    "below": (768, 0, 0),
    "below-adjacent": (256, 0, 0),
    "above": (0, 256, 0),
    "window-dead-rows": (512, 0, 300),
    "window-across": (512, 256, 200),
    "window-diagonal": (256, 256, 100),
    "window-unreached": (1024, 0, 200),
    "unaligned-below": (517, 131, 0),
    "unaligned-near-diagonal": (300, 290, 0),
    "unaligned-window": (700, 333, 250),
}


def _live(q_off, k_off, window):
    qp = q_off + np.arange(S)[:, None]
    kp = k_off + np.arange(S)[None, :]
    ok = kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return ok


def _tile_has_mask(live, q0, k0, rows, keys):
    """A tile masks when one of its pairs is masked: rows and keys past the
    shard count as masked."""
    tile = np.zeros((rows, keys), bool)
    r, c = min(rows, S - q0), min(keys, S - k0)
    tile[:r, :c] = live[q0:q0 + r, k0:k0 + c]
    return not tile.all()


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("pair", PAIRS)
def test_forward_schedule_at_offsets(D, pair):
    q_off, k_off, window = PAIRS[pair]
    live = _live(q_off, k_off, window)
    W, (_, NK, _) = tflash.FWD_WG_ROWS, tflash.fwd_tiles(D)
    sched = tflash.fwd_schedule(S, S, H, KV, D, True, window, 1, q_off, k_off)
    count = np.zeros((H, S, S), np.int32)
    for blk in sched:
        for qw, k0, masked in blk["visits"]:
            rows = slice(qw, min(qw + W, S))
            keys = slice(k0, min(k0 + NK, S))
            assert live[rows, keys].any()  # no tile without a live pair
            assert masked == _tile_has_mask(live, qw, k0, W, NK)
            count[blk["head"], rows, keys] += 1
        if not live[blk["q0"]:blk["q0"] + 2 * W].any():
            assert not blk["loads"] and not blk["visits"]
    assert (count[:, live] == 1).all() and (count <= 1).all()
    masked = [m for blk in sched for _, _, m in blk["visits"]]
    if pair.startswith("below") or pair == "unaligned-below":
        assert masked and not any(masked)  # the fast path on every tile
    if pair in ("above", "window-unreached"):
        assert not masked and not any(blk["loads"] for blk in sched)
    if pair == "diagonal":
        assert sched == tflash.fwd_schedule(S, S, H, KV, D, True, 0)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("pair", PAIRS)
def test_backward_schedule_at_offsets(D, pair):
    q_off, k_off, window = PAIRS[pair]
    live = _live(q_off, k_off, window)
    NK, NQ = tflash.bwd_tiles(D)
    T = tflash.BWD_TILE
    sched = tflash.bwd_schedule(S, S, H, KV, D, True, window, 1, q_off, k_off)
    for grad in ("dq", "dk", "dv"):
        kind, (rows, keys) = (("dq", (T, NK)) if grad == "dq"
                              else ("dkv", (NQ, T)))
        count = np.zeros((H, S, S), np.int32)
        for blk in sched[kind]:
            if grad not in blk["grads"]:
                continue
            assert len(blk["masked"]) == len(blk["visits"])
            for (q0, k0, h), masked in zip(blk["visits"], blk["masked"]):
                assert live[q0:q0 + rows, k0:k0 + keys].any()
                assert masked == _tile_has_mask(live, q0, k0, rows, keys)
                count[h, q0:q0 + rows, k0:k0 + keys] += 1
        assert (count[:, live] == 1).all(), grad
        assert (count <= 1).all(), grad
    masked = [m for kind in ("dq", "dkv") for blk in sched[kind]
              for m in blk["masked"]]
    if pair.startswith("below") or pair == "unaligned-below":
        assert masked and not any(masked)
    if pair in ("above", "window-unreached"):
        assert not masked
    if pair == "diagonal":
        plain = tflash.bwd_schedule(S, S, H, KV, D, True, 0)
        assert sched == plain


def test_live_rows_of_a_windowed_pair():
    """The rows of a pair that see a key: all of them but past the window's
    reach, which ends inside the pair at row k_off + S - 1 + window - q_off."""
    rows = tflash.live_rows(S, S, True, 300, 512, 0)
    assert rows.sum() == 0 + (0 + S - 1 + 300 - 512) and not rows[-1]
    assert tflash.live_rows(S, S, True, 0, 768, 0).all()
    assert not tflash.live_rows(S, S, True, 0, 0, 256).any()
