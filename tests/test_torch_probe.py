"""PyTorch port, the guest's device-validation ladder and multi-host
rendezvous (``guest/probe.py``, ``guest/distributed.py``) against the JAX
package's: ``resolve`` over a table of envs (single host, multi-host, each
refusal) gives JAX's config or JAX's error; ``initialize_from_env(dry_run=
True)`` JAX's summary; ``run_ladder`` on the CPU prints JAX's keys line by
line; two CPU processes rendezvous through ``initialize_from_env`` (gloo)
and sum across the group."""
from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from kata_xpu_device_plugin_tpu.guest import distributed as jdist
from kata_xpu_device_plugin_tpu.guest import probe as jprobe
from kata_xpu_device_plugin_tpu_torch.guest import distributed as tdist
from kata_xpu_device_plugin_tpu_torch.guest import probe as tprobe

ENVS = {
    "empty": {},
    "single-host-list": {"TPU_WORKER_HOSTNAMES": "h0"},
    "single-host-id0": {"TPU_WORKER_ID": "0"},
    "multi-host-w0": {"TPU_WORKER_HOSTNAMES": "h0,h1,h2", "TPU_WORKER_ID": "0"},
    "multi-host-w2": {"TPU_WORKER_HOSTNAMES": "h0,h1,h2", "TPU_WORKER_ID": "2"},
    "empty-entries": {"TPU_WORKER_HOSTNAMES": "h0,,h1,", "TPU_WORKER_ID": "1"},
    "refuse-lost-list": {"TPU_WORKER_ID": "3"},
    "refuse-no-id": {"TPU_WORKER_HOSTNAMES": "h0,h1"},
    "refuse-bad-id": {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "x"},
    "refuse-out-of-range": {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "2"},
    "refuse-negative": {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "-1"},
}


def _outcome(mod, env, **kw):
    try:
        cfg = mod.resolve(env, **kw)
    except ValueError as exc:
        return ("error", str(exc))
    return ("ok", cfg.num_processes, cfg.process_id, cfg.coordinator_address,
            cfg.multi_host)


@pytest.mark.parametrize("case", list(ENVS))
def test_resolve_matches_jax(case):
    env = ENVS[case]
    assert _outcome(tdist, env) == _outcome(jdist, env)
    assert _outcome(tdist, env, port=1234) == _outcome(jdist, env, port=1234)
    assert case.startswith("refuse") == (_outcome(tdist, env)[0] == "error")
    assert tdist.DEFAULT_COORDINATOR_PORT == jdist.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize("case", ["empty", "multi-host-w2"])
def test_dry_run_matches_jax(case):
    """The dry run reports the JAX summary and starts no group (a
    single-host env is a no-op either way)."""
    import torch.distributed as dist

    env = ENVS[case]
    got = tdist.initialize_from_env(env, dry_run=True)
    assert got == jdist.initialize_from_env(env, dry_run=True)
    assert got["initialized"] is False
    assert not dist.is_initialized()


def _lines(fn) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_run_ladder_prints_jax_keys():
    """On the CPU (asked for) the ladder prints three lines whose keys and
    checks are JAX's (on JAX's 8 forced host devices), every one ``ok``;
    with an expected count that is wrong it fails, as JAX's does."""
    trc, tlines = _lines(lambda: tprobe.run_ladder(1, device="cpu"))
    jrc, jlines = _lines(lambda: jprobe.run_ladder(None))
    assert trc == 0 and jrc == 0
    assert [t["check"] for t in tlines] == [j["check"] for j in jlines]
    assert set(tlines[0]) == set(jlines[0]) | {"expected"}
    for t, j in zip(tlines[1:], jlines[1:]):
        assert set(t) == set(j)
    assert all(t["ok"] for t in tlines)
    assert tlines[0]["platform"] == "cpu" and tlines[1]["value"] == 256.0
    rc, _ = _lines(lambda: tprobe.run_ladder(2, device="cpu"))
    assert rc == 1


def test_probes_default_to_the_card():
    """Without a device the probes and the rendezvous use CUDA, which this
    machine lacks: they raise, as every entry point of the port does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprobe.probe_compute()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize_from_env(ENVS["multi-host-w0"])


CHILD = textwrap.dedent("""
    import json, sys
    from kata_xpu_device_plugin_tpu_torch.guest import distributed, probe
    summary = distributed.initialize_from_env(port=int(sys.argv[1]),
                                              device="cpu")
    line = probe.probe_all_reduce(device="cpu")
    devices = probe.probe_devices(2, device="cpu")
    print(json.dumps({"summary": summary, "all_reduce": line,
                      "devices": devices}))
    import torch.distributed as dist
    dist.destroy_process_group()
""")


def test_two_processes_rendezvous_on_the_cpu():
    """``initialize_from_env`` in two processes (worker hostnames
    ``localhost``, gloo): each is initialized with JAX's summary keys, and
    the ladder's all-reduce and device count see both processes."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = {**os.environ, "TPU_WORKER_HOSTNAMES": "localhost,localhost",
               "TPU_WORKER_ID": str(rank),
               "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, str(port)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rank, o in enumerate(outs):
        assert o["summary"]["initialized"] is True
        assert o["summary"]["process_id"] == rank
        assert o["summary"]["global_devices"] == 2
        assert set(o["summary"]) == set(jdist.initialize_from_env(
            ENVS["empty"], dry_run=True)) | {"global_devices", "local_devices"}
        assert o["all_reduce"]["ok"] and o["all_reduce"]["value"] == 1.0
        assert o["devices"]["ok"] and o["devices"]["device_count"] == 2
