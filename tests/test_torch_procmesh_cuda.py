"""PyTorch port, a process mesh on the card: two ranks sharing ``cuda:0``.
Marked ``cuda``; they skip without an NVIDIA GPU.

Over gloo every group collective moves a card tensor through pinned host
memory, counted, and matches the list form bit for bit; an NCCL group of
two ranks on one card raises at its first collective, and the error
reaches the caller (nothing retries it on gloo). This file imports no
JAX; its gloo ranks run the checks of ``tests/torch_procmesh_worker.py``
on card tensors. From the repository root on a machine with the card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_procmesh_cuda.py -q
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import json, sys
    import torch
    sys.path.insert(0, sys.argv[3])
    sys.path.insert(0, sys.argv[3] + "/tests")
    from kata_xpu_device_plugin_tpu_torch.guest.distributed import initialize_from_env
    from kata_xpu_device_plugin_tpu_torch.ops import collectives
    from kata_xpu_device_plugin_tpu_torch.parallel import process_mesh
    backend = sys.argv[2]
    initialize_from_env(port=int(sys.argv[1]), device="cuda:0", backend=backend)
    mesh = process_mesh({"model": 2}, device="cuda:0")
    out = {"rank": mesh.rank}
    if backend == "nccl":
        try:
            collectives.group_all_reduce_sum(torch.ones(4, device="cuda:0"),
                                             mesh.line())
            torch.cuda.synchronize()
            out["raised"] = None
        except Exception as e:
            out["raised"] = type(e).__name__ + ": " + str(e)[:400]
    else:
        from torch_procmesh_worker import collective_checks
        line = mesh.line("model")
        before = mesh.procs.staging.bytes
        x = torch.ones(8, device="cuda:0")
        y = collectives.group_all_reduce_sum(x, line)
        out["sum_on_card"] = y.is_cuda and float(y[0]) == 2.0
        out["staged"] = mesh.procs.staging.bytes - before
        real = torch.from_numpy
        torch.from_numpy = lambda a: real(a).to("cuda:0")
        try:
            out["checks"] = collective_checks(line, 17)
        finally:
            torch.from_numpy = real
    print(json.dumps(out), flush=True)
    import os
    os._exit(0)
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the process mesh's card path runs "
                    "only on the card")
    return torch.device("cuda")


def _pair(backend: str, timeout: float) -> list:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(port), backend, REPO],
        env={**os.environ, "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            lines = [x for x in out.splitlines() if x.startswith("{")]
            outs.append(json.loads(lines[-1]) if lines else {"err": err[-2000:]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.cuda
def test_gloo_ranks_on_one_card_stage_through_the_host(cuda_device):
    """Two gloo ranks on ``cuda:0``: every group collective of card
    tensors matches its list form bit for bit, the result stays on the
    card, and the bytes through host memory are counted (8 fp32 out and
    2 x 8 back for one sum)."""
    outs = _pair("gloo", 240)
    for o in outs:
        assert "checks" in o, o
        assert o["sum_on_card"] and o["staged"] == 4 * (8 + 16)
        assert all(o["checks"].values()), o["checks"]


@pytest.mark.cuda
def test_nccl_group_of_two_ranks_on_one_card_raises(cuda_device):
    """NCCL refuses two ranks on one device: the first collective raises
    on the ranks that report, with NCCL's words, and no rank reports a
    result (nothing retried the collective on another backend)."""
    outs = _pair("nccl", 120)
    raised = [o["raised"] for o in outs if "raised" in o]
    assert raised and all(raised), outs
