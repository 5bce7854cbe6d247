"""The critically sampled polyphase filter-bank channelizer in one pass:
one hand-written CUDA kernel (csrc/channelizer.cu) and its plain PyTorch
twin.

:func:`channelize` takes the block's state complex64 [K] or [*lead, K]
(K = C q), a chunk x complex64 [*lead, n] and the branch taps float32
[C, q] (``g[p][j] = h[(q-1-j) C + p]`` of the C q-tap prototype h), and
returns (the new state [*lead, K], y complex64 [*lead, C, n // C]):

    v_p[m]    = sum_j g[p][j] xin[(m + j + 1) C - p],   xin = [state | x]
    y[c][m]   = sum_p e^{+2 pi i c p / C} v_p[m]
    new state = the last K samples of xin

For CUDA tensors it launches the kernel, for CPU tensors it takes the
twin (:func:`channelize_reference`, the block's stock-torch body), and
anything else raises.  ``channelize.launches`` counts kernel launches.

The kernel factors the DFT as C = a b (:func:`radices`) and walks tiles
of T output times (:func:`plan`, its grid sized by the card's SMs);
:func:`fits` says whether it takes a shape: both radices at most 16 and
the smallest tile's shared memory (:func:`smem_bytes`, the one count of
it: the plan passes it to the launch) within a block's 227 KB.  The
block keeps the stock path on a card for shapes that do not fit.  Roots,
twiddles and taps are built in float64 and stored as float32
(:func:`tables`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: the kernel's constants (csrc/channelizer.cu): the largest radix of a
#: DFT stage, shared memory a block may take and the blocks the kernel's
#: launch bounds put on one SM
_MAX_RADIX = 16
_SMEM_MAX = 227 * 1024
_BLOCKS_PER_SM = 2
#: shared memory of one SM, of which each resident block also takes 1 KB
_SM_SMEM = 228 * 1024
#: tile lengths (output times) a plan may take, largest first
_TILES = (64, 32, 16)


def _lib():
    lib = cudabuild.load("channelizer")
    if not lib.lr_channelize.argtypes:
        lib.lr_channelize.argtypes = [_VP, _LL, _VP, _LL, _VP, _VP, _VP, _VP,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _VP]
        lib.lr_channelize.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- plain PyTorch twin -------------------------------------------------------

def channelize_reference(state: torch.Tensor, x: torch.Tensor,
                         branch: torch.Tensor):
    """Plain twin of :func:`channelize` in stock torch ops: one slice of
    [state | x] covers every branch window, q strided multiply-adds give
    the branch sums and the inverse FFT across branches, scaled by C, the
    channels."""
    c, q = branch.shape
    k = c * q
    m = x.shape[-1] // c
    lead = x.shape[:-1]
    # xin[k + t] = x[t]; output m' reads xin[k + m'C - k'], k' < K, so
    # every index lies in [1, k + (m-1)C]
    xin = torch.cat([state.to(x.dtype).expand(lead + state.shape[-1:]),
                     x], dim=-1)
    # one slice covers every branch window: fr[u, j] = xin[1 + uC + j],
    # and branch p's decimated stream is brx[p, u] = fr[u, C-1-p]
    fr = xin[..., 1:1 + (m + q - 1) * c].reshape(lead + (m + q - 1, c))
    brx = fr.flip(-1).transpose(-1, -2)                # [.., C, m+q-1]
    # per-branch causal FIR: v_p[m'] = sum_j hp[p, q-1-j] brx[p, m'+j]
    v = torch.zeros(lead + (c, m), dtype=x.dtype, device=x.device)
    for j in range(q):
        v = v + branch[:, j:j + 1] * brx[..., j:j + m]
    # inverse DFT across branches, scaled by C: channel c lands at
    # +c rate / C
    y = (torch.fft.ifft(v, dim=-2) * np.float32(c)).to(torch.complex64)
    return xin[..., xin.shape[-1] - k:], y


# -- the kernel's plan --------------------------------------------------------

def radices(c: int) -> tuple[int, int]:
    """(a, b): C = a b with a the largest divisor of C at most sqrt C, so
    b is as small as a factorisation in two allows (a = 1 where C has no
    such divisor)."""
    a = max(d for d in range(1, math.isqrt(c) + 1) if c % d == 0)
    return a, c // a


def smem_bytes(c: int, q: int, tile: int) -> int:
    """Shared memory one block of the kernel takes at C channels, q taps a
    branch and tiles of ``tile`` times, in the kernel's order
    (csrc/channelizer.cu pfb_kernel): two windows of (tile + q - 1) C
    samples, the branch sums [C, tile + 1], the roots and twiddles, the
    taps."""
    a, b = radices(c)
    return 8 * (2 * (tile + q - 1) * c + c * (tile + 1) + a + b + a * b) \
        + 4 * q * c


@functools.lru_cache(maxsize=64)
def fits(c: int, q: int) -> bool:
    """Whether the kernel takes C channels with q taps a branch: C = a b
    with both radices at most 16, and the smallest tile within a block's
    shared memory."""
    if c < 2 or q < 1:
        return False
    a, b = radices(c)
    return b <= _MAX_RADIX and smem_bytes(c, q, _TILES[-1]) <= _SMEM_MAX


class Plan(NamedTuple):
    """One launch: radices ``a`` x ``b`` = C, tiles of ``tile`` output
    times, ``grid`` persistent blocks (``per_sm`` of them an SM) of
    ``smem`` bytes of shared memory."""
    a: int
    b: int
    tile: int
    grid: int
    per_sm: int
    smem: int


@functools.lru_cache(maxsize=64)
def plan(c: int, q: int, m: int, rows: int, sms: int) -> Plan:
    """The launch for ``rows`` rows of ``m`` outputs at C channels, q taps
    a branch, on a card of ``sms`` SMs: the longest tile with which two
    blocks share an SM (the one block's windows in flight while the other
    computes), else the longest that fits at all; as many persistent
    blocks as the card holds, no more than there are tiles (at least one,
    which writes the new state of a chunk shorter than C).  Cached: a
    graph launches one shape chunk after chunk."""
    if not fits(c, q):
        raise ValueError(f"the channelizer kernel does not take C {c}, "
                         f"q {q}")
    a, b = radices(c)
    fitting = [t for t in _TILES if smem_bytes(c, q, t) <= _SMEM_MAX]
    paired = [t for t in fitting
              if _BLOCKS_PER_SM * (smem_bytes(c, q, t) + 1024) <= _SM_SMEM]
    tile = (paired or fitting)[0]
    smem = smem_bytes(c, q, tile)
    per_sm = max(1, min(_BLOCKS_PER_SM, _SM_SMEM // (smem + 1024)))
    tiles = rows * -(-m // tile)
    return Plan(a, b, tile, max(1, min(tiles, per_sm * sms)), per_sm, smem)


def tables(c: int) -> np.ndarray:
    """The kernel's roots and twiddles, complex64 [a + b + a b]: the a-th
    roots e^{2 pi i k / a}, the b-th roots, then e^{2 pi i c1 p2 / C} at
    c1 b + p2; computed in float64."""
    a, b = radices(c)
    c1, p2 = np.divmod(np.arange(a * b), b)
    return np.concatenate([np.exp(2j * np.pi * np.arange(a) / a),
                           np.exp(2j * np.pi * np.arange(b) / b),
                           np.exp(2j * np.pi * ((c1 * p2) % c) / c)]
                          ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _device_tables(c: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tables(c)).to(device)


# -- the kernel wrapper -------------------------------------------------------

def _check(name, t, dtype, shape, device, contiguous=True):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or (contiguous and not t.is_contiguous()):
        raise ValueError(
            f"{name}: want {'contiguous ' if contiguous else ''}{dtype} "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}{'' if t.is_contiguous() else ' (not contiguous)'}")


def channelize(state: torch.Tensor, x: torch.Tensor, branch: torch.Tensor):
    """state complex64 [C q] or [*lead, C q], x complex64 [*lead, n],
    branch float32 [C, q] -> (new state complex64 [*lead, C q], y
    complex64 [*lead, C, n // C])."""
    if branch.dim() != 2 or x.dim() < 1:
        raise ValueError(f"branch: want [C, q], got {tuple(branch.shape)}; "
                         f"x: want [*lead, n], got {tuple(x.shape)}")
    c, q = branch.shape
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    dev = x.device
    _check("x", x, torch.complex64, lead + (n,), dev)
    _check("branch", branch, torch.float32, (c, q), dev)
    want = (c * q,) if state.dim() == 1 else lead + (c * q,)
    # the twin's state is a view of its window, not contiguous over rows
    _check("state", state, torch.complex64, want, dev,
           contiguous=dev.type != "cpu")
    if dev.type == "cpu":
        return channelize_reference(state, x, branch)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, m = math.prod(lead), n // c
    p = plan(c, q, m, rows, _sms(dev.index))  # raises where it does not fit
    new_state = torch.empty(lead + (c * q,), dtype=torch.complex64,
                            device=dev)
    y = torch.empty(lead + (c, m), dtype=torch.complex64, device=dev)
    tw = _device_tables(c, dev)
    lib = _lib()
    # the raw handle of the card's current stream (torch.cuda.current_stream
    # builds a Stream object: several microseconds a chunk on the host)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    code = lib.lr_channelize(
        state.data_ptr(), 0 if state.dim() == 1 else c * q, x.data_ptr(), n,
        branch.data_ptr(), tw.data_ptr(), new_state.data_ptr(), y.data_ptr(),
        rows, c, q, p.a, p.b, p.tile, p.grid, p.smem, dev.index, stream)
    cudabuild.check(lib, code, "channelize")
    channelize.launches += 1
    return new_state, y


channelize.launches = 0


__all__ = ["channelize", "channelize_reference", "fits", "plan", "Plan",
           "radices", "smem_bytes", "tables"]
