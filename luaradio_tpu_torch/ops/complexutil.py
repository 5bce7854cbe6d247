"""Interleaved-float32 wire <-> complex64 conversions, and the on-card
conversion of integer wire items.

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


def wire_converter(offset: float, scale: float, *, divide: bool,
                   complex_: bool = True, u16: bool = False):
    """On-card converter of integer wire items: ``(raw - offset) / scale``
    (``divide``: the files' host path, utils/format.py raw_to_float) or
    ``(raw - offset) * scale`` (the SDR rings' host path), then
    interleaved pairs -> complex64 where ``complex_``; ``u16`` codes come
    as the int16 of the same bits (torch's uint16 has few kernels).

    Each equals its host path bit for bit: ``raw - offset`` is exact in
    float32 and the scale a 0-d float32 tensor (a Python scalar divisor
    becomes a multiply by its reciprocal on the card, one ulp off for some
    codes), so each item is one correctly rounded float32 quotient or
    product of the same operands.  The two are not interchangeable: for
    u8, dividing by 127.5 and multiplying by float32(1 / 127.5) differ."""
    op = torch.div if divide else torch.mul

    def convert(raw: torch.Tensor) -> torch.Tensor:
        if u16:
            raw = raw.to(torch.int32) & 0xFFFF
        s = torch.full((), scale, dtype=torch.float32, device=raw.device)
        f = op(raw.to(torch.float32) - offset, s)
        return wire_to_complex(f) if complex_ else f
    return convert


def to_device(arr, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (complex stays complex).
    A host tensor (a wire feed's pinned block, core/ingest.py) is copied
    as itself without waiting, so that the caching host allocator records
    the copy on the block and reuses it only once the copy is done."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


__all__ = ["wire_to_complex", "complex_to_wire", "wire_converter",
           "to_device"]
