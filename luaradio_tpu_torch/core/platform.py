"""Platform introspection and device selection.

Reference analog: radio/core/platform.lua (OS/arch/cpu introspection,
acceleration feature flags).  Here the acceleration backend is a CUDA card
driven through PyTorch.

Every entry point of the package takes a ``device``.  ``None`` means the
card: without one it raises instead of carrying on quietly on the CPU.
``device="cpu"`` is an explicit request for the plain PyTorch versions
(the tests use it).
"""

from __future__ import annotations

import os
import platform as _platform
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on: ``cuda`` unless the caller
    names another; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_info() -> dict:
    """The CUDA card(s) PyTorch sees, with the torch and CUDA versions."""
    avail = torch.cuda.is_available()
    n = torch.cuda.device_count() if avail else 0
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": avail,
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
    }


def info() -> dict:
    d = {
        "os": _platform.system().lower(),
        "arch": _platform.machine(),
        "python": sys.version.split()[0],
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("LUARADIO_TPU_")},
    }
    d.update(cuda_info())
    return d


def time_us() -> int:
    """Microsecond monotonic timestamp (reference platform.time_us)."""
    import time
    return time.monotonic_ns() // 1000


__all__ = ["resolve_device", "cuda_info", "info", "time_us"]
