"""PyTorch port, the training loop: the loader against the JAX package's,
checkpoints, and ``fit`` resuming a preempted run bit-identically (the
contract of the JAX package's tests/test_trainer.py), on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.parallel.loader import TokenBatchLoader as JaxLoader
from kata_xpu_device_plugin_tpu_torch.models import llama3_train_test
from kata_xpu_device_plugin_tpu_torch.parallel import (
    TokenBatchLoader,
    TrainCheckpointer,
    fit,
    make_optimizer,
    make_train_step,
)
from kata_xpu_device_plugin_tpu_torch.parallel.sharding import leaves

TOKENS = np.arange(4096, dtype=np.int32) % 500


@pytest.fixture(autouse=True)
def one_thread():
    """Bit-identical comparisons need a fixed summation order. With several
    threads, MKL by default may run a product on fewer threads than asked
    when the machine is loaded (as under a parallel test run), and so split
    its sums differently from one call to the next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = llama3_train_test(dtype=torch.float32)
    return make_train_step(cfg, make_optimizer(lr=1e-3), device="cpu")


def _loader(seed=5):
    return TokenBatchLoader(TOKENS, batch=8, seq_len=31, seed=seed)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax_across_epochs_and_a_round_trip(shuffle):
    """16 windows of 32 tokens in 8-row batches: two batches an epoch, so
    five draws cross two epoch boundaries; a fresh loader restored from
    the cursor after the third draws what both originals draw."""
    ours = TokenBatchLoader(TOKENS[:520], batch=8, seq_len=31, seed=3,
                            shuffle=shuffle)
    ref = JaxLoader(TOKENS[:520], batch=8, seq_len=31, seed=3, shuffle=shuffle)
    assert ours.steps_per_epoch == ref.steps_per_epoch == 2
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.dtype == np.int32 and a.shape == (8, 32)
        np.testing.assert_array_equal(a, b)
    assert ours.state_dict() == ref.state_dict()
    resumed = TokenBatchLoader(TOKENS[:520], batch=8, seq_len=31, seed=3,
                               shuffle=shuffle)
    resumed.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    for _ in range(2):
        a, b, c = next(ours), next(ref), next(resumed)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    with pytest.raises(ValueError, match="seed"):
        TokenBatchLoader(TOKENS[:520], batch=8, seq_len=31, seed=4).load_state_dict(
            ours.state_dict())


def test_fit_runs_and_returns_losses(setup):
    init_state, step = setup
    state, losses = fit(init_state, step, _loader(), steps=3)
    assert len(losses) == 3 and all(np.isfinite(x) for x in losses)
    assert all(isinstance(x, float) for x in losses)
    assert state["step"] == 3 and state["opt"]["count"] == 3


def test_resume_replays_uninterrupted_run(setup, tmp_path):
    init_state, step = setup
    ref_state, ref_losses = fit(init_state, step, _loader(), steps=6, seed=1)

    class Preempted(Exception):
        pass

    def preempt(s, loss):
        if s == 3:
            raise Preempted

    d = str(tmp_path / "ckpt")
    with pytest.raises(Preempted):
        fit(init_state, step, _loader(), steps=6, seed=1, ckpt_dir=d,
            ckpt_every=2, on_step=preempt)
    assert TrainCheckpointer(d).steps() == [2]
    # A fresh loader and a fresh state: fit restores both from step 2.
    state, losses = fit(init_state, step, _loader(), steps=6, seed=1,
                        ckpt_dir=d, ckpt_every=2)
    assert losses == ref_losses[2:]
    assert state["step"] == 6 and state["opt"]["count"] == 6
    for a, b in zip(leaves(state["params"]) + leaves(state["opt"]["mu"])
                    + leaves(state["opt"]["nu"]),
                    leaves(ref_state["params"]) + leaves(ref_state["opt"]["mu"])
                    + leaves(ref_state["opt"]["nu"])):
        assert torch.equal(a, b)


def test_max_to_keep_prunes_checkpoints_and_cursors(setup, tmp_path):
    init_state, step = setup
    d = tmp_path / "ckpt"
    fit(init_state, step, _loader(), steps=5, ckpt_dir=str(d), ckpt_every=1)
    names = sorted(os.listdir(d))
    assert names == ["loader_3.json", "loader_4.json", "loader_5.json",
                     "step_3.pt", "step_4.pt", "step_5.pt"]
    assert TrainCheckpointer(str(d)).latest_step() == 5


def test_checkpointer_round_trip_and_refusals(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"w": torch.zeros(2)})
    ckpt.save(7, {"w": torch.arange(3.0), "step": 7})
    live = {"w": torch.zeros(3), "step": 0}
    got = ckpt.restore(live)
    assert got["step"] == 7 and got["w"] is live["w"]
    assert torch.equal(live["w"], torch.arange(3.0))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    with pytest.raises(ValueError, match="differs"):
        ckpt.restore({"w": torch.zeros(4), "step": 0})
    with pytest.raises(ValueError, match="differs"):
        ckpt.restore({"v": torch.zeros(3), "step": 0})


def test_fit_validation(setup):
    init_state, step = setup
    seen = []
    fit(init_state, step, _loader(), steps=2, on_step=lambda s, l: seen.append(s))
    assert seen == [1, 2]
    with pytest.raises(ValueError, match="ckpt_dir"):
        fit(init_state, step, _loader(), steps=1, ckpt_every=2)
