"""The windowed gather S8: each tile of a stream with the halo before it,
written by hand in CUDA (csrc/window.cu, device code in csrc/window.cuh),
with its plain PyTorch twin in this module.

* :func:`window_gather` (S8) — x float32 [C, 2 tile NT] and carry float32
  [C, head] -> float32 [C, NT W], W = head + 2 tile, whose window i is
  ``[carry | x][:, 2 tile i : 2 tile i + W]``: the carry before the first
  tile, the ``head`` floats before each later one.  This is
  ``torch.cat([carry, x], 1).unfold(1, W, 2 tile)`` laid out flat.
  Replaces the Pallas TPU kernel of ``scratch/pallas_dma_test.py``
  (``_kernel`` :13, ``pallas_call`` :43), whose two DMAs a grid step fill
  one VMEM window.

The wrapper launches the CUDA kernel for CUDA tensors and takes the twin
only for tensors on the CPU; anything else raises.
``window_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from luaradio_tpu_torch.ops import cudabuild

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _lib():
    lib = cudabuild.load("window")
    if not lib.lr_window_gather.argtypes:
        lib.lr_window_gather.argtypes = [_VP, _LL, _VP] + [_LL] * 5 + \
            [_VP, _VP]
        lib.lr_window_gather.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, carry: torch.Tensor, tile: int) -> int:
    """Validate the arguments; returns the window count NT."""
    for name, t in (("x", x), ("carry", carry)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"window_gather: {name} must be float32 2-D, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"window_gather: {name} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"window_gather: unsupported device {t.device}")
    if carry.device != x.device:
        raise ValueError(f"window_gather: carry on {carry.device}, x on "
                         f"{x.device}")
    if carry.shape[0] != x.shape[0]:
        raise ValueError(f"window_gather: carry has {carry.shape[0]} rows, "
                         f"x {x.shape[0]}")
    if tile < 1 or x.shape[1] % (2 * tile):
        raise ValueError(f"window_gather: tile {tile} must be positive and "
                         f"2 tile divide the {x.shape[1]} columns")
    return x.shape[1] // (2 * tile)


def window_gather_reference(x: torch.Tensor, carry: torch.Tensor,
                            tile: int) -> torch.Tensor:
    """Plain twin of :func:`window_gather`."""
    c, head = carry.shape
    w = head + 2 * tile
    nt = x.shape[1] // (2 * tile)
    return torch.cat([carry, x], 1).unfold(1, w, 2 * tile).reshape(
        c, nt * w)


def window_gather(x: torch.Tensor, carry: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """S8: x float32 [C, 2 tile NT], carry float32 [C, head] -> float32
    [C, NT (head + 2 tile)], window i the ``head`` floats before tile i of
    ``[carry | x]`` and the tile."""
    tile = int(tile)
    nt = _check(x, carry, tile)
    if x.device.type == "cpu":
        return window_gather_reference(x, carry, tile)
    c, head = carry.shape
    w = head + 2 * tile
    out = torch.empty((c, nt * w), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_window_gather(
            x.data_ptr(), x.shape[1], carry.data_ptr(), head, 2 * tile, w,
            nt, c, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    cudabuild.check(lib, code, "window_gather")
    window_gather.launches += 1
    return out


window_gather.launches = 0


__all__ = ["window_gather", "window_gather_reference"]
