"""PyTorch port, the quantization quality ladder
(``scripts/torch_eval_quality.py``) against ``scripts/eval_quality.py
--cpu`` at ``llama3_train_test``: the JAX script runs as its CLI; the
port's ladder runs on the same weights (JAX's ``init_params`` from the
script's key, through the bridge) and the same tokens (the script's
``jax.random.randint``). Rung by rung the keys are equal and the values
within fp32 summation noise:

- ``ce``/``delta_ce``: 1e-4 (a mean of log-sum-exps over 64 positions of
  logits near 1 in magnitude, each side's fp32 sum in its own order);
- ``max_logit_drift``/``mean_logit_drift``: 1e-3 + 1e-3 relative (the
  difference of two fp32 forwards, the int8 rungs' dequantized products
  summed in another order);
- ``top1_agree``: within 2 of the B*S positions (an argmax tie broken the
  other way by that noise moves one position each side);
- ``kv_agree`` and ``first_divergence_step``: equal (greedy tokens of fp32
  decodes over the two caches)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kata_xpu_device_plugin_tpu.models import llama as jllama
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu_torch.models import bridge

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--config", "llama3_train_test", "--batch", "2", "--seq-len", "32",
        "--decode-steps", "8", "--seed", "0", "--cpu"]
B, S = 2, 32


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def jax_rows():
    """``scripts/eval_quality.py`` with :data:`ARGS`, as its CLI runs."""
    import subprocess

    env = {**os.environ, "KATA_TPU_COMPILE_CACHE": "0", "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, str(REPO / "scripts" / "eval_quality.py"),
                          *ARGS], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr
    return _lines(res.stdout)


def test_ladder_matches_the_jax_script(jax_rows):
    cfg = jllama.llama3_train_test(dtype=jnp.float32)
    params = jt.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S + 1), 0,
                                           cfg.vocab_size))
    tcfg = bridge.config_from_fields(dataclasses.asdict(cfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    got = _load("torch_eval_quality").ladder(tparams, tcfg, tokens, 8,
                                             "llama3_train_test", "float32")
    assert [r["variant"] for r in got] == [r["variant"] for r in jax_rows] == [
        "baseline", "int8", "w8a8", "int8_kv"]
    for mine, ref in zip(got, jax_rows):
        assert list(mine) == list(ref), ref["variant"]
        for key, want in ref.items():
            have = mine[key]
            if key in ("ce", "delta_ce"):
                assert have == pytest.approx(want, abs=1e-4), (ref["variant"], key)
            elif key.endswith("logit_drift"):
                assert have == pytest.approx(want, abs=1e-3, rel=1e-3), (
                    ref["variant"], key)
            elif key == "top1_agree":
                assert abs(have - want) <= 2 / (B * S) + 1e-9, ref["variant"]
            else:
                assert have == want, (ref["variant"], key)


def test_cli_prints_one_line_a_rung(capsys):
    """The port's CLI with the JAX script's flags: one JSON line a rung with
    the JAX script's keys, a finite ladder, the baseline's drift 0."""
    assert _load("torch_eval_quality").main(ARGS) == 0
    rows = _lines(capsys.readouterr().out)
    assert [r["variant"] for r in rows] == ["baseline", "int8", "w8a8", "int8_kv"]
    base = rows[0]
    assert (base["delta_ce"], base["max_logit_drift"], base["top1_agree"]) == (
        0.0, 0.0, 1.0)
    assert set(rows[3]) == {"variant", "config", "dtype", "kv_agree",
                            "first_divergence_step", "decode_steps"}
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))


def test_cli_runs_on_the_card_unless_told_otherwise():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load("torch_eval_quality").main([a for a in ARGS if a != "--cpu"])
