"""Interleaved-float32 wire <-> complex64 conversions.

The I/Q wire (files, SDR buffers, the flagship step's input) stores complex
samples as interleaved float32 pairs [..., 2N].  Torch's complex64 has the
same memory layout, so both directions are zero-copy views on the host and
on the card alike; nothing in the port needs the TPU's real-typed program
boundaries.
"""

from __future__ import annotations

import numpy as np
import torch


def wire_to_complex(x: torch.Tensor) -> torch.Tensor:
    """Interleaved float32 [..., 2N] -> complex64 [..., N] (a view; a
    non-contiguous input is copied first)."""
    if x.dtype != torch.float32 or x.shape[-1] % 2:
        raise ValueError(f"wire_to_complex: want float32 [..., 2N], got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    return torch.view_as_complex(x.reshape(x.shape[:-1] + (-1, 2)))


def complex_to_wire(z: torch.Tensor) -> torch.Tensor:
    """complex64 [..., N] -> interleaved float32 [..., 2N] (a view)."""
    z = z.contiguous()
    return torch.view_as_real(z).reshape(z.shape[:-1] + (-1,))


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (complex stays complex)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


__all__ = ["wire_to_complex", "complex_to_wire", "to_device"]
