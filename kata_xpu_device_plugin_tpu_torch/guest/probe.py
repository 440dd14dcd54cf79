"""Guest validation ladder (counterpart of
``kata_xpu_device_plugin_tpu/guest/probe.py``).

Runs inside the guest to check that the devices the plugin injected work:
device visibility, a product on the device, and an all-reduce. Prints one
JSON object a check, with the JAX package's keys (``platform`` is
``"gpu"`` on CUDA), so the results compare across the two stacks. The
probes run on the CUDA devices unless the caller passes ``device="cpu"``.

    python -m kata_xpu_device_plugin_tpu_torch.guest.probe [EXPECTED] [--cpu]

exits 0 only when every check passed.
"""
from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from .. import resolve_device


def _local_devices(device=None) -> list:
    """The devices this process probes: every CUDA device, or the one CPU
    the caller asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _processes() -> tuple:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def probe_devices(expected: Optional[int] = None, device=None) -> dict:
    """The injected devices initialize and enumerate; with a process group
    up, ``device_count`` counts every process's devices."""
    devices = _local_devices(device)
    _rank, world = _processes()
    local = len(devices)
    names = [f"{d} {torch.cuda.get_device_name(d)}" if d.type == "cuda"
             else str(d) for d in devices]
    result = {
        "check": "devices",
        "platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
        "device_count": local * world,
        "local_device_count": local,
        "devices": names,
        "ok": True,
    }
    if expected is not None:
        result["expected"] = expected
        result["ok"] = local * world == expected
    return result


def probe_compute(device=None) -> dict:
    """A 256 x 256 bf16 product of ones runs on the device and gives 256
    everywhere (a device check, not a kernel: ``torch.matmul``)."""
    dev = resolve_device(device)
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    y = (x @ x).float()
    ok = bool(torch.allclose(y, torch.full_like(y, 256.0)))
    return {"check": "compute", "ok": ok, "value": float(y[0, 0])}


def probe_all_reduce(device=None) -> dict:
    """One tensor a local device, device ``i`` holding ``i`` (offset by the
    process's rank times its device count), summed through
    ``collectives.all_reduce_sum`` (on the first device) and, with a
    process group up, ``torch.distributed.all_reduce``: the sum of
    ``0 .. N-1`` over all ``N`` devices."""
    from ..ops import collectives

    devices = _local_devices(device)
    rank, world = _processes()
    n = len(devices)
    parts = [torch.full((1, 1), float(rank * n + i), device=d)
             for i, d in enumerate(devices)]
    out = collectives.all_reduce_sum([p.to(devices[0]) for p in parts])
    if world > 1:
        import torch.distributed as dist

        dist.all_reduce(out)
    total = n * world
    expect = float(total * (total - 1) / 2)
    ok = bool(torch.allclose(out, torch.full_like(out, expect)))
    return {"check": "all_reduce", "devices": total, "ok": ok,
            "value": float(out[0, 0])}


def run_ladder(expected_devices: Optional[int] = None, device=None) -> int:
    """Run every probe, printing one JSON line each; 0 only when every
    check passed."""
    ok = True
    for result in (
        probe_devices(expected_devices, device),
        probe_compute(device),
        probe_all_reduce(device),
    ):
        print(json.dumps(result))
        ok = ok and result["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    expected = int(args[0]) if args else None
    sys.exit(run_ladder(expected, "cpu" if "--cpu" in sys.argv else None))
