"""WBFM mono demodulation in one pass: frequency discriminator + decimating
FIR (deemphasis folded into the taps).

Two kernels written by hand in CUDA (csrc/wbfm.cu), each with its plain
PyTorch twin in this module:

* :func:`wbfm_mono` (K1) — the flagship step's form: interleaved float32
  I/Q chunk [C, 2T] and a complex64 carry of the last K samples [C, K];
  returns the new carry and the audio [C, T/D].  Replaces
  ``luaradio_tpu/ops/wbfm_pallas.py`` ``make_wbfm_pallas``.
* :func:`disc_fir` (K2) — the in-graph form: a complex64 stream [C, T]
  (read as its re/im planes) and the same carry; returns the audio.
  Replaces ``make_disc_fir_pallas``.

Both compute, over the window w = [carry | x]:

    m[i] = arg(w[i+1] * conj(w[i])) * inv_gain
    y[j] = sum_k h[k] * m[K-1 + j*D - k]

for any T with T % D == 0; the TPU kernels' tile constraints do not carry
over, so ragged chunks run in the kernel too.  A wrapper launches the CUDA
kernel for CUDA tensors and takes the twin only for tensors on the CPU;
anything else raises.  ``<wrapper>.launches`` counts kernel launches.

:func:`plan` sizes a launch from (C, T, K, D): the tile length and the
strips of tiles the persistent blocks walk, so that a long chunk keeps
every block resident and a short one still spreads over the card's SMs;
:func:`smem_bytes` and :func:`fits` mirror the kernel's shared memory
(core/optimize.py reads :func:`fits`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from luaradio_tpu_torch.ops import cudabuild
from luaradio_tpu_torch.ops.complexutil import wire_to_complex
from luaradio_tpu_torch.ops.fir import _conv_real

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = cudabuild.load("wbfm")
    if not lib.lr_wbfm_mono.argtypes:
        lib.lr_wbfm_mono.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F,
                                     _I, _I, _I, _I, _I, _VP]
        lib.lr_wbfm_mono.restype = ctypes.c_int
        lib.lr_disc_fir.argtypes = [_VP, _VP, _LL, _LL, _VP, _VP, _LL, _LL,
                                    _VP, _VP, _I, _I, _I, _I, _F, _I, _I,
                                    _I, _I, _I, _VP]
        lib.lr_disc_fir.restype = ctypes.c_int
        lib.lr_disc_fir_smem.argtypes = [_I] * 6
        lib.lr_disc_fir_smem.restype = ctypes.c_longlong
        lib.lr_disc_fir_occupancy.argtypes = [_I] * 6
        lib.lr_disc_fir_occupancy.restype = ctypes.c_int
        lib.lr_empty_launch.argtypes = [_VP]
        lib.lr_empty_launch.restype = ctypes.c_int
    return lib


# -- plain PyTorch twins ------------------------------------------------------

def discriminate(re: torch.Tensor, im: torch.Tensor,
                 inv_gain: float) -> torch.Tensor:
    """m[i] = arg(w[i+1] * conj(w[i])) * inv_gain over window planes
    [..., L] -> [..., L-1], with the conj-multiply rounded term by term
    as the kernels do."""
    rp, ip = re[..., :-1], im[..., :-1]
    rc, ic = re[..., 1:], im[..., 1:]
    tre = rc * rp + ic * ip
    tim = ic * rp - rc * ip
    return torch.atan2(tim, tre) * inv_gain


def _window(carry: torch.Tensor, xc: torch.Tensor):
    w = torch.cat([carry, xc], dim=-1)
    return w.real, w.imag


def wbfm_mono_reference(carry, x, taps, d: int, inv_gain: float):
    """Plain twin of :func:`wbfm_mono`: carry complex64 [C, K], x float32
    [C, 2T] interleaved -> (new_carry [C, K], audio [C, T/D])."""
    k = taps.shape[0]
    xc = wire_to_complex(x)
    m = discriminate(*_window(carry, xc), inv_gain)
    return _new_carry(carry, xc, k), _conv_real(m, taps, d)


def disc_fir_reference(carry, x, taps, d: int, inv_gain: float):
    """Plain twin of :func:`disc_fir`: carry complex64 [C, K], x complex64
    [C, T] -> audio [C, T/D]."""
    m = discriminate(*_window(carry, x), inv_gain)
    return _conv_real(m, taps, d)


# -- kernel wrappers ----------------------------------------------------------

#: the launch's constants, as in csrc/wbfm.cu: warps a block, shared
#: memory a block may take, and the SMs of an H100 SXM that a launch
#: should fill
_WARPS = 8
_SMEM_MAX = 227 * 1024
_SMS = 132
#: blocks a plan puts on one SM at most (the kernel's launch bounds)
_BLOCKS_PER_SM = 2
#: shared memory of one SM, of which each resident block also takes 1 KB
_SM_SMEM = 228 * 1024


class Plan(NamedTuple):
    """How one launch covers [C, T/D] outputs: tiles of ``tile`` outputs,
    ``tiles_per_strip`` consecutive tiles of one channel a block, a grid
    of (``strips``, C) blocks of ``smem`` bytes of shared memory; warp
    tiles 8 ``nt`` outputs wide; ``stages`` chunks of samples in
    flight; ``compact``: one float32 copy of the m ring and the taps
    (split when loaded), for shapes that do not fit otherwise."""
    tile: int
    tiles_per_strip: int
    strips: int
    nt: int
    stages: int
    compact: bool
    smem: int


def _geometry(k: int, d: int, tile: int, nt: int) -> dict:
    """The kernel's derived sizes (csrc/wbfm.cu make_geometry)."""
    r = -(-k // d)                       # taps a polyphase row
    ksp = -(-(r + 8 * nt - 1) // 8)      # mma k-steps a row
    wt = 128 * nt                        # outputs of a warp tile
    nm = tile // wt if tile >= wt else 1
    # chunks a tile's window spans (rows of a warp tile past a narrower
    # tile read whatever the ring holds and are discarded)
    la = -(-(min(tile, nm * wt) + 8 * ksp) // tile)
    ring = (la + 1) * tile                 # the m ring holds one more
    return {"r": r, "ksp": ksp, "wt": wt, "nm": nm, "nkg": _WARPS // nm,
            "la": la, "ring": ring, "rs": ring + 4, "gs": 8 * ksp + 8 * nt,
            "ss": tile * d + 4}


def smem_bytes(k: int, d: int, tile: int = 64, nt: int = 1,
               stages: int = 2, compact: bool = False) -> int:
    """Shared memory one block of the kernel needs for K taps, decimation
    D, tiles of ``tile`` outputs, warp tiles ``nt`` wide, ``stages``
    sample stages (mirrors smem_bytes in csrc/wbfm.cu): the mbarriers,
    the stages, the m ring and the tap rows (hi and lo, or one float32
    copy each when ``compact``) and the warps' partial sums (two
    buffers)."""
    g = _geometry(k, d, tile, nt)
    copies = 1 if compact else 2
    return 4 * (8 + 2 * stages * g["ss"] + copies * d * (g["rs"] + g["gs"])
                + 2 * _WARPS * g["wt"])


def _smallest(k: int, d: int) -> int:
    """Shared memory of the smallest plan (64-output tiles, 8-wide warp
    tiles, two stages, compact), which every plan can fall back to."""
    return smem_bytes(k, d, 64, 1, 2, compact=True)


def fits(k: int, d: int) -> bool:
    """Whether the kernel takes K taps at decimation D on an H100."""
    return k >= 1 and d >= 1 and _smallest(k, d) <= _SMEM_MAX


def _auto_tile(c: int, n_out: int, k: int, d: int) -> tuple[int, int]:
    """(tile, nt): 256 outputs in 16-wide warp tiles when the chunk has
    two such tiles for every SM, else 128 in 8-wide ones, else (where
    those do not fit) 64.  Tiles of 64 do not pay for the wider spread:
    a strip recomputes the K-1 discriminator values before its first
    tile, for only 64 D new ones.  At the README graph's chunk (1 x
    52 430, K 512, D 5) 82 blocks of 128 outputs took 0.0081 ms of device
    time, 164 blocks of 64 0.0107-0.0110 ms and 41 of 256 0.0093 ms
    (scratch/wbfm_ab.py, H100 SXM at 700 W)."""
    if c * -(-n_out // 256) >= _BLOCKS_PER_SM * _SMS \
            and smem_bytes(k, d, 256, 2) <= _SMEM_MAX:
        return 256, 2
    if smem_bytes(k, d, 128, 1) <= _SMEM_MAX:
        return 128, 1
    return 64, 1


@functools.lru_cache(maxsize=256)
def plan(c: int, t: int, k: int, d: int) -> Plan:
    """The launch for C channels of T samples, K taps, decimation D.

    A chunk with enough outputs for two 256-output tiles an SM takes
    16-wide warp tiles of 256 outputs (fewer shared-memory reads an
    mma); a shorter one 128 (:func:`_auto_tile`).  Blocks are
    persistent: at most ``_BLOCKS_PER_SM`` per SM (fewer where shared
    memory runs out), each walking a strip of consecutive tiles of one
    channel, so that the halo is computed once a strip.  A strip of a
    few tiles keeps four chunks of samples in flight (its loads are all
    latency), a long one two.  Where even 64-output tiles do not fit,
    the plan is compact.  Cached: a graph launches at one shape chunk
    after chunk."""
    n_out = t // d
    if smem_bytes(k, d, 64, 1, 2) > _SMEM_MAX:
        tiles = max(1, -(-n_out // 64))
        spc = max(1, min(tiles, _SMS // c))
        tps = -(-tiles // spc)
        return Plan(64, tps, -(-tiles // tps), 1, 2, True,
                    smem_bytes(k, d, 64, 1, 2, compact=True))
    tile, nt = _auto_tile(c, n_out, k, d)
    tiles = max(1, -(-n_out // tile))
    per_sm = max(1, min(_BLOCKS_PER_SM,
                        _SM_SMEM // (smem_bytes(k, d, tile, nt) + 1024)))
    strips_per_channel = max(1, min(tiles, (_SMS * per_sm) // c))
    tps = -(-tiles // strips_per_channel)
    stages = 4 if (tps <= 4 and smem_bytes(k, d, tile, nt, 4)
                   <= _SMEM_MAX) else 2
    return Plan(tile, tps, -(-tiles // tps), nt, stages, False,
                smem_bytes(k, d, tile, nt, stages))


def _new_carry(carry: torch.Tensor, xc: torch.Tensor, k: int):
    if xc.shape[-1] >= k:
        return xc[:, xc.shape[-1] - k:].contiguous()
    return torch.cat([carry, xc], dim=-1)[:, -k:].contiguous()


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_common(carry, taps, c, t, d, device):
    k = taps.shape[0] if taps.dim() == 1 else -1
    _check("taps", taps, torch.float32, (k,), device)
    _check("carry", carry, torch.complex64, (c, k), device)
    if d < 1 or t < 1 or t % d:
        raise ValueError(f"chunk of {t} samples is not a positive multiple "
                         f"of the decimation {d}")
    if not fits(k, d):
        raise ValueError(f"{k} taps at decimation {d} need "
                         f"{_smallest(k, d)} bytes of shared memory, more "
                         f"than the kernel's {_SMEM_MAX}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return k


def _k1_call(entry, lib, carry, x, taps, d, inv_gain, p: Plan, *extra):
    c, t, k = x.shape[0], x.shape[1] // 2, taps.shape[0]
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = entry(carry.data_ptr(), x.data_ptr(), taps.data_ptr(),
                     out.data_ptr(), c, t, k, d, float(inv_gain), p.tile,
                     p.tiles_per_strip, p.nt, p.stages, int(p.compact),
                     *extra, stream)
    cudabuild.check(lib, code, "wbfm_mono")
    return out


def _launch_k1(carry, x, taps, d, inv_gain, p: Plan):
    """Launch K1 under plan ``p`` (checked inputs on the card)."""
    lib = _lib()
    return _k1_call(lib.lr_wbfm_mono, lib, carry, x, taps, d, inv_gain, p)


def k1_half(carry, x, taps, d, inv_gain, p: Plan, mode: int):
    """Launch one half of K1 alone under plan ``p``: mode 1 the
    discriminator (loads, atan2, the m ring), mode 2 the FIR over
    whatever the ring holds.  A measurement probe built apart
    (cudabuild.PROBES "wbfm_parts"); its output is not the audio and it
    counts no launch."""
    lib = cudabuild.load("wbfm_parts")
    if not lib.lr_wbfm_mono_part.argtypes:
        lib.lr_wbfm_mono_part.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I,
                                          _I, _F, _I, _I, _I, _I, _I, _I,
                                          _VP]
        lib.lr_wbfm_mono_part.restype = ctypes.c_int
    return _k1_call(lib.lr_wbfm_mono_part, lib, carry, x, taps, d, inv_gain,
                    p, mode)


def _launch_k2(carry, x, taps, d, inv_gain, p: Plan):
    """Launch K2 under plan ``p`` (checked inputs on the card)."""
    c, t = x.shape
    k = taps.shape[0]
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    lib = _lib()
    # the re/im planes of a complex64 tensor: step 2 floats, im 4 bytes on
    cre, xre = carry.data_ptr(), x.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lr_disc_fir(cre, cre + 4, 2 * k, 2, xre, xre + 4, 2 * t,
                               2, taps.data_ptr(), out.data_ptr(), c, t, k,
                               d, float(inv_gain), p.tile,
                               p.tiles_per_strip, p.nt, p.stages,
                               int(p.compact), stream)
    cudabuild.check(lib, code, "disc_fir")
    return out


def wbfm_mono(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
              d: int, inv_gain: float):
    """K1.  carry complex64 [C, K], x float32 [C, 2T] interleaved I/Q,
    taps float32 [K] -> (new_carry complex64 [C, K], audio float32
    [C, T/D])."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x: want float32 [C, 2T], got {tuple(x.shape)}")
    c, t = x.shape[0], x.shape[1] // 2
    _check("x", x, torch.float32, (c, 2 * t), x.device)
    k = _check_common(carry, taps, c, t, d, x.device)
    if x.data_ptr() % 8 or carry.data_ptr() % 8:
        # the kernel reads each I/Q pair as one 8-byte float2
        raise ValueError("x and carry must start on an 8-byte boundary "
                         "(x begins at an odd float offset)")
    if x.device.type == "cpu":
        return wbfm_mono_reference(carry, x, taps, d, inv_gain)
    out = _launch_k1(carry, x, taps, d, inv_gain, plan(c, t, k, d))
    wbfm_mono.launches += 1
    return _new_carry(carry, wire_to_complex(x), k), out


def disc_fir(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
             d: int, inv_gain: float) -> torch.Tensor:
    """K2.  carry complex64 [C, K], x complex64 [C, T], taps float32 [K]
    -> audio float32 [C, T/D]."""
    if x.dim() != 2:
        raise ValueError(f"x: want complex64 [C, T], got {tuple(x.shape)}")
    c, t = x.shape
    _check("x", x, torch.complex64, (c, t), x.device)
    k = _check_common(carry, taps, c, t, d, x.device)
    if x.device.type == "cpu":
        return disc_fir_reference(carry, x, taps, d, inv_gain)
    out = _launch_k2(carry, x, taps, d, inv_gain, plan(c, t, k, d))
    disc_fir.launches += 1
    return out


wbfm_mono.launches = 0
disc_fir.launches = 0


def empty_launch(device) -> None:
    """Launch csrc/wbfm.cu's empty kernel once on ``device``'s current
    stream: timed, it is the launch floor under any kernel.  A
    measurement probe, not a kernel of the receiver."""
    dev = torch.device(device)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.lr_empty_launch(torch.cuda.current_stream(dev).cuda_stream)
    cudabuild.check(lib, code, "empty_launch")


def kernel_smem_bytes(k: int, d: int, p: Plan) -> int:
    """smem_bytes as the built kernel computes it (csrc/wbfm.cu), to hold
    the Python mirror against on the card."""
    return int(_lib().lr_disc_fir_smem(k, d, p.tile, p.nt, p.stages,
                                       int(p.compact)))


def occupancy(k: int, d: int, p: Plan) -> int:
    """Blocks of the kernel that fit on one SM of the card under plan
    ``p`` (CUDA's occupancy calculator), to hold the plan's blocks per
    SM against."""
    n = int(_lib().lr_disc_fir_occupancy(k, d, p.tile, p.nt, p.stages,
                                         int(p.compact)))
    if n < 0:
        cudabuild.check(_lib(), -n, "occupancy")
    return n

__all__ = ["wbfm_mono", "disc_fir", "wbfm_mono_reference",
           "disc_fir_reference", "discriminate", "fits", "smem_bytes",
           "plan", "Plan"]
