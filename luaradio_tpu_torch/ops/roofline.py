"""The roofline probes: an HBM copy through shared memory (serial and
double-buffered) and an in-kernel atan2, written by hand in CUDA
(csrc/roofline.cu), each with its plain PyTorch twin in this module.

* :func:`hbm_copy` — x float32 [C, 2T] contiguous -> an identical copy.
  ``double_buffered=False`` launches R1 (:func:`hbm_copy_serial`), one
  32 KiB slab a CTA with one bulk copy in flight; ``True`` launches R2
  (:func:`hbm_copy_double_buffered`), persistent CTAs over a 2-stage ring
  that keeps the load of slab i+1 in flight while slab i is stored.
  Replace the two bodies of ``measure_hbm_copy`` in the JAX system's
  bench_roofline.py (:59; kern :93 and :72).
* :func:`atan2_halves` (R3) — x float32 [C, 2T] -> out float32 [C, T]
  with, for each column tile j of ``tile`` columns and h = tile / 2,
  ``out[:, j h:(j + 1) h] = atan2(x[:, j tile:j tile + h],
  x[:, j tile + h:(j + 1) tile])``.  ``tile`` is part of the function.
  Replaces ``measure_vpu_atan2`` (bench_roofline.py:144, kern :155).

A wrapper launches the CUDA kernel for CUDA tensors and takes the twin only
for tensors on the CPU; anything else raises.  ``<wrapper>.launches``
counts kernel launches (:func:`hbm_copy_serial`,
:func:`hbm_copy_double_buffered`, :func:`atan2_halves`).
:func:`ring_trace` runs R2 once with its timestamps recorded and
:func:`ring_overlap` reads from them how much of the ring's load time a
store overlaps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: bytes a stage of the copies holds (csrc/roofline.cu kSlab)
SLAB = 32 * 1024


def _lib():
    lib = cudabuild.load("roofline")
    if not lib.lr_hbm_copy.argtypes:
        lib.lr_hbm_copy.argtypes = [_VP, _VP, _LL, _I, _VP, _VP]
        lib.lr_hbm_copy.restype = ctypes.c_int
        lib.lr_hbm_copy_ring_ctas.argtypes = []
        lib.lr_hbm_copy_ring_ctas.restype = ctypes.c_int
        lib.lr_atan2_halves.argtypes = [_VP, _VP, _LL, _LL, _LL, _VP]
        lib.lr_atan2_halves.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{what}: want float32 [C, 2T], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: the bulk copies need a 16-byte aligned "
                         f"start (the tensor begins at an offset)")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- plain PyTorch twins ------------------------------------------------------

def hbm_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`hbm_copy`."""
    return torch.empty_like(x).copy_(x)


def atan2_halves_reference(x: torch.Tensor, tile: int = 1 << 15
                           ) -> torch.Tensor:
    """Plain twin of :func:`atan2_halves`: a view [C, 2T/tile, 2,
    tile/2] and torch.atan2 of its two halves, as [C, T]."""
    c, w = x.shape
    v = x.reshape(c, w // tile, 2, tile // 2)
    return torch.atan2(v[:, :, 0], v[:, :, 1]).reshape(c, w // 2)


# -- kernel wrappers ----------------------------------------------------------

def _copy(x: torch.Tensor, double_buffered: bool, trace=None):
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_hbm_copy(x.data_ptr(), out.data_ptr(),
                               x.numel() * 4, int(double_buffered),
                               None if trace is None else trace.data_ptr(),
                               _stream(x.device))
    cudabuild.check(lib, code, "hbm_copy")
    return out


def hbm_copy_serial(x: torch.Tensor) -> torch.Tensor:
    """R1: x float32 [C, 2T] contiguous -> a copy, one 32 KiB slab a CTA
    loaded and stored by one bulk copy each, one in flight a CTA."""
    _check(x, "hbm_copy")
    if x.device.type == "cpu":
        return hbm_copy_reference(x)
    out = _copy(x, False)
    hbm_copy_serial.launches += 1
    return out


def hbm_copy_double_buffered(x: torch.Tensor) -> torch.Tensor:
    """R2: the same copy by persistent CTAs over a 2-stage ring of
    32 KiB slabs, a load in flight beside each store."""
    _check(x, "hbm_copy")
    if x.device.type == "cpu":
        return hbm_copy_reference(x)
    out = _copy(x, True)
    hbm_copy_double_buffered.launches += 1
    return out


def hbm_copy(x: torch.Tensor, double_buffered: bool = False) -> torch.Tensor:
    """x float32 [C, 2T] contiguous -> an identical copy, by R2 when
    ``double_buffered`` else by R1."""
    return (hbm_copy_double_buffered if double_buffered
            else hbm_copy_serial)(x)


def atan2_halves(x: torch.Tensor, tile: int = 1 << 15) -> torch.Tensor:
    """R3: x float32 [C, 2T] -> float32 [C, T], atan2 of the first half
    of each ``tile``-column tile over its second half.  ``tile`` must be
    even and divide 2T."""
    _check(x, "atan2_halves")
    tile = int(tile)
    w = x.shape[1]
    if tile < 2 or tile % 2 or w % tile:
        raise ValueError(f"atan2_halves: tile {tile} must be even and "
                         f"divide the {w} columns")
    if x.device.type == "cpu":
        return atan2_halves_reference(x, tile)
    c, t = x.shape[0], w // 2
    out = torch.empty((c, t), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_atan2_halves(x.data_ptr(), out.data_ptr(), c, t, tile,
                                   _stream(x.device))
    cudabuild.check(lib, code, "atan2_halves")
    atan2_halves.launches += 1
    return out


hbm_copy_serial.launches = 0
hbm_copy_double_buffered.launches = 0
atan2_halves.launches = 0


# -- the ring's overlap -------------------------------------------------------

def ring_ctas() -> int:
    """R2's grid on this card: the persistent CTAs it holds at once."""
    n = int(_lib().lr_hbm_copy_ring_ctas())
    if n < 1:
        raise RuntimeError("hbm_copy: the occupancy query failed")
    return n


def ring_trace(x: torch.Tensor) -> np.ndarray:
    """Run R2 once on the card with its trace on: [slabs, 4] int64
    nanoseconds (%globaltimer) a slab, at the load's issue, its landing,
    the store's issue and the store's read of shared memory (0 where the
    kernel did not wait on it alone).  A measurement probe: it counts no
    launch and its copy is checked, not returned."""
    _check(x, "hbm_copy")
    if x.device.type != "cuda":
        raise ValueError("ring_trace: the trace is the card's")
    slabs = -(-x.numel() * 4 // SLAB)
    trace = torch.zeros((slabs, 4), dtype=torch.int64, device=x.device)
    out = _copy(x, True, trace)
    if not torch.equal(out, x):
        raise AssertionError("hbm_copy: the traced ring's copy differs")
    return trace.cpu().numpy()


def ring_overlap(trace: np.ndarray, ctas: int) -> dict:
    """From :func:`ring_trace` (slab s on CTA s mod ``ctas``): each slab's
    load in flight [issue, landed] beside the same CTA's store of the slab
    before it [issue, read]; the share of all load time during which that
    store was in flight."""
    t = np.asarray(trace, np.int64)
    load_ns = overlap_ns = pairs = 0
    for cta in range(min(ctas, len(t))):
        rows = t[cta::ctas]
        for j in range(1, len(rows)):
            li, ll = rows[j, 0], rows[j, 1]
            si, sr = rows[j - 1, 2], rows[j - 1, 3]
            if sr <= 0:
                continue
            load_ns += ll - li
            overlap_ns += max(0, min(ll, sr) - max(li, si))
            pairs += 1
    return {"load_ns": int(load_ns), "overlap_ns": int(overlap_ns),
            "overlap_share": overlap_ns / load_ns if load_ns else 0.0,
            "slab_pairs": int(pairs)}


__all__ = ["hbm_copy", "hbm_copy_serial", "hbm_copy_double_buffered",
           "atan2_halves", "hbm_copy_reference", "atan2_halves_reference",
           "ring_trace", "ring_overlap", "ring_ctas", "SLAB"]
