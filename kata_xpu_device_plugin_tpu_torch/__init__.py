"""PyTorch/CUDA port of the guest serving stack of kata_xpu_device_plugin_tpu.

The JAX package beside it stays the reference this package is tested
against; this package imports ``torch`` and numpy only. Its entry points
(``models.init_params``, ``models.generate``, ``guest.GenerationServer``)
run on ``cuda`` unless the caller passes ``device="cpu"``; with no device
given and no CUDA present they raise. The attention hot spots are CUDA
C++ kernels for Hopper (``csrc/``), built by ``ops._build`` at first use;
each keeps a plain PyTorch version beside it, taken only for CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else CUDA.
    Never drops to the CPU on its own — no device and no CUDA raises."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the plain "
            "PyTorch path"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        # Tensors report an indexed device: "cuda" means the current card.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
