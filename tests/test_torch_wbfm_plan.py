"""K1/K2's launch planner (luaradio_tpu_torch/ops/wbfm.py plan, smem_bytes,
fits) and the numerics of the kernel's 3xTF32 FIR, on the CPU.

The kernel (csrc/wbfm.cu) runs only on the card; what surrounds it is
plain Python that these tests reach: which tiles and strips a launch
walks, how much shared memory a block takes, and which shapes it takes at
all.  The FIR's arithmetic is emulated in numpy: both operands split into
a TF32 high part and a TF32 low part (10-bit mantissa, round to nearest
even, as the kernel's tf32_rne), the three products hi*hi + hi*lo + lo*hi
formed exactly and summed in float32, and the result held against the
plain PyTorch twin at the kernels' tolerance, 2e-5 * scale.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from luaradio_tpu_torch.ops import wbfm  # noqa: E402
from luaradio_tpu_torch.ops.fir import _conv_real  # noqa: E402
from luaradio_tpu_torch.parallel.flagship import (INV_GAIN,  # noqa: E402
                                                  wbfm_mono_taps)

#: (C, T, K, D): the flagship step, the README graph's K2 chunk, a ragged
#: chunk, a few short channels, one tile, and a tap count that needs the
#: compact layout
SHAPES = {
    "flagship": (8, 1 << 22, 640, 8),
    "graph chunk": (1, 52430, 512, 5),
    "ragged": (8, 3 * (1 << 14) + 8 * 37, 640, 8),
    "channels, short": (3, 4000, 256, 8),
    "one tile": (2, 64, 16, 8),
    "compact": (2, 1 << 16, 16384, 16),
}


def _first_kernel_smem(k, d):
    """Shared memory of the first K1/K2 kernel (1024-output tiles, rows
    padded one float in five), which took every (K, D) with this at most
    227 KB."""
    cols = 1024 + (k - 1) // d + 2
    return 4 * (k + d * (cols + cols // 4 + 1))


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_covers_every_output_once(name):
    c, t, k, d = SHAPES[name]
    p = wbfm.plan(c, t, k, d)
    n_out = t // d
    n_tiles = -(-n_out // p.tile)
    count = np.zeros(n_out, np.int64)
    for strip in range(p.strips):
        first = strip * p.tiles_per_strip
        last = min(first + p.tiles_per_strip, n_tiles)
        assert first < last, f"strip {strip} of {p} has no tile"
        count[first * p.tile:min(last * p.tile, n_out)] += 1
    assert (count == 1).all()
    assert p.tile % 64 == 0 and p.nt in (1, 2) and 2 <= p.stages <= 4


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_fits_shared_memory(name):
    c, t, k, d = SHAPES[name]
    p = wbfm.plan(c, t, k, d)
    assert wbfm.fits(k, d)
    assert p.smem == wbfm.smem_bytes(k, d, p.tile, p.nt, p.stages,
                                     p.compact)
    assert p.smem <= 227 * 1024
    assert p.compact == (name == "compact")


def test_graph_chunk_plan_amortises_the_halo():
    """The README graph's 52 430-sample chunk (10 486 outputs) spreads
    over more blocks than the first kernel's 11, in tiles that bring at
    least as many new samples (tile * D) as the K-1 halo each strip
    recomputes: 164 blocks of 64 outputs were slower on the card than 82
    of 128 (ops/wbfm.py _auto_tile)."""
    c, t, k, d = SHAPES["graph chunk"]
    p = wbfm.plan(c, t, k, d)
    assert p.strips * c > 11
    assert p.tile * d >= k - 1


def test_flagship_blocks_are_persistent():
    """The flagship step's blocks each walk a strip of many tiles, and all
    of them are resident at once (two a SM)."""
    c, t, k, d = SHAPES["flagship"]
    p = wbfm.plan(c, t, k, d)
    assert p.tiles_per_strip > 1
    assert p.strips * c <= 132 * 2
    assert 2 * (p.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("k", [1, 16, 128, 443, 512, 640, 1024, 4096,
                               16384, 25000])
def test_fits_takes_every_shape_the_first_kernel_took(k):
    took = [d for d in range(1, 129) if _first_kernel_smem(k, d) <= 227 * 1024]
    assert took and all(wbfm.fits(k, d) for d in took)


def _tf32(x):
    """float32 -> TF32 (10-bit mantissa), round to nearest even; kept in a
    float32 with the low 13 bits zero."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _fir_3xtf32(m, taps, d):
    """y[j] = sum_q h[K-1-q] m[j*D + q] with the kernel's split products:
    each product of TF32 parts is exact in float64, the three are added
    to float32 accumulators tap by tap."""
    k = taps.shape[0]
    hr = taps[::-1].astype(np.float32)
    mh = _tf32(m)
    ml = _tf32(m - mh)
    hh = _tf32(hr)
    hl = _tf32(hr - hh)
    n_out = (m.shape[-1] - k) // d + 1
    acc_hh = np.zeros(m.shape[:-1] + (n_out,), np.float32)
    acc_x = np.zeros_like(acc_hh)
    for q in range(k):
        win = slice(q, q + d * (n_out - 1) + 1, d)
        a_h = mh[..., win].astype(np.float64)
        a_l = ml[..., win].astype(np.float64)
        acc_hh += (a_h * hh[q]).astype(np.float32)
        acc_x += (a_l * hh[q] + a_h * hl[q]).astype(np.float32)
    return acc_hh + acc_x


def _signal(rng, c, t):
    ph = np.cumsum(0.4 * rng.standard_normal((c, t)), axis=-1)
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal((c, t))
                                  + 1j * rng.standard_normal((c, t)))
    return z.astype(np.complex64)


def _discriminator(z):
    zt = torch.from_numpy(z)
    return wbfm.discriminate(zt.real, zt.imag, INV_GAIN).numpy()


@pytest.mark.parametrize("case", ["test taps, K 256, D 8",
                                  "flagship taps, K 640, D 8",
                                  "graph-like taps, K 512, D 5"])
def test_3xtf32_fir_is_inside_the_tolerance(case):
    """On the K1/K2 tests' signals the emulated 3xTF32 FIR stays inside
    2e-5 * scale of the float32 twin (scale 1 here).  Measured: 1.34e-7
    on the test taps, 1.49e-8 on the flagship taps, 3.73e-8 on the
    graph-like taps (margins 149, 1342, 537; printed with -s).  One TF32
    product alone (hi*hi) is off by 5.59e-5 on the test taps, outside the
    tolerance, and 6.4e-6 / 7.5e-6 on the others: that is why the kernel
    keeps the two correction products."""
    rng = np.random.default_rng(5)
    if case.startswith("test"):
        k, d = 256, 8
        taps = (np.hanning(k) * rng.standard_normal(k) * 0.1).astype(
            np.float32)
    elif case.startswith("flagship"):
        taps, d = wbfm_mono_taps(), 8
        k = taps.shape[0]
    else:
        k, d = 512, 5
        taps = (np.hanning(k) * np.sinc(np.linspace(-8, 8, k)) / 40).astype(
            np.float32)
    m = _discriminator(_signal(rng, 2, 4096 + k))
    exp = _conv_real(torch.from_numpy(m), torch.from_numpy(taps), d).numpy()
    got = _fir_3xtf32(m, taps, d)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got - exp)))
    one = float(np.max(np.abs(_fir_3xtf32(_tf32(m), _tf32(taps), d)
                              - exp)))
    print(f"{case}: 3xTF32 max error {err:.3g}, one TF32 product "
          f"{one:.3g}, tolerance {2e-5 * scale:.3g}, margin "
          f"{2e-5 * scale / max(err, 1e-30):.0f}")
    assert err < 2e-5 * scale
    if case.startswith("test"):
        assert one > 2e-5 * scale
