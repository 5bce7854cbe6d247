"""K3's split into a serial walk and parallel rebuilds, emulated on the
CPU.

The kernel (luaradio_tpu_torch/csrc/pll.cu) walks only the loop's chain,
(phi_l, fk), in one thread and records the phase error d of each step.
For an integer multiplier its consumer warps rebuild everything else from
wrapping 32-bit sums, tile by tile:

    phi_l[i] = theta[i] - d[i]
    phi_m[i] = phi_m[0] + mult (phi_l[i] - phi_l[0]) - C[i]
    C[i]     = sum_{j<i} trunc(k_corr d_f[j])              (mod 2^32)

with C a prefix sum over each tile's two halves (one per consumer warp,
32 samples at a time) carried from tile to tile.  For a fractional
multiplier the walker also records fk, and one consumer thread walks
phi_m from (fk, err).  This file emulates that decomposition in numpy, at
the kernel's tile size, and requires it to equal the sequential twin
``pll_phase_reference`` exactly (out, err and state, difference 0): the
identity holds before the card sees it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.ops import pll  # noqa: E402
from luaradio_tpu_torch.ops.pll import (  # noqa: E402
    _TO_F, _TO_I, _to_int, _wrap32, _wrap_pi, constants,
    pll_phase_reference, theta_turns)

T = pll.TILE
LENGTHS = (1, T - 1, T, T + 1, 3 * T + 5)
CASES = ("noise", "carrier", "zeros+carrier")
_I32 = (-(1 << 31), (1 << 31) - 1)


def _params():
    """The loop constants of PLLBlock(1e3, 200e3, 220e3) at 1 MS/s (the
    JAX package's benchmark PLL, as tests/test_torch_pll.py uses)."""
    blk = tl.PLLBlock(1e3, 200e3, 220e3)
    blk.device = torch.device("cpu")
    blk.differentiate([tl.ComplexFloat32])
    blk.input_rate = 1e6
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def _case(name, n):
    """The three inputs of tests/test_torch_pll.py, at n samples (the
    zeros run over the first 128, or all of a shorter input)."""
    rng = np.random.default_rng(17 + CASES.index(name))
    t = np.arange(n)
    if name == "noise":
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    else:
        x = 0.7 * np.exp(1j * (2 * np.pi * 0.21 * t + 0.9))
        if name == "zeros+carrier":
            x[:128] = 0
    return x.astype(np.complex64)


def _trunc_i32(v):
    """float32 -> int32 toward zero, saturating (no NaN here)."""
    return np.clip(np.trunc(v.astype(np.float64)), *_I32).astype(np.int64)


def _walk(ti, zero, phi_l, fk, k):
    """The walker: the chain alone.  Returns the recorded d (int64, each
    wrapped to int32) and fk before each step, and the exit (phi_l, fk)."""
    n = len(ti)
    d_rec = np.empty(n, np.int64)
    fk_rec = np.empty(n, np.float32)
    for i in range(n):
        fk_rec[i] = fk
        d = _wrap32(ti[i] - phi_l)
        d_rec[i] = d
        d_f = np.float32(0) if zero[i] else np.float32(d)
        phi_l = _wrap32(phi_l + _to_int(fk + k["k_ab"] * d_f, "rz"))
        fk = min(max(fk + k["k_b"] * d_f, k["fmin_k"]), k["fmax_k"])
    return d_rec, fk_rec, phi_l, fk


def _prefix_by_tiles(terms):
    """The consumers' exclusive prefix sum C of int32 terms, mod 2^32:
    per tile, two halves, 32 samples at a time (an inclusive scan and the
    running total of the earlier groups), the second half offset by the
    first's total, the tile's total carried to the next."""
    c = np.empty(len(terms), np.int64)
    carry = 0
    for base in range(0, len(terms), T):
        tile = terms[base:base + T]
        halves = [tile[:T // 2], tile[T // 2:]]
        run = [carry, carry + int(halves[0].sum())]
        for h, part in enumerate(halves):
            for g in range(0, len(part), 32):
                grp = part[g:g + 32]
                incl = np.cumsum(grp)
                lo = base + h * (T // 2) + g
                c[lo:lo + len(grp)] = run[h] + incl - grp
                run[h] += int(incl[-1])
        carry = _wrap32(run[1])
    return (c - _I32[0]) % (1 << 32) + _I32[0], carry


def split_phase(x, state, alpha, beta, fmin, fmax, mult):
    """The kernel's decomposition, in numpy: (out, err, new state) as
    pll_phase_reference returns them."""
    k = constants(alpha, beta, fmin, fmax, mult)
    f32, to_f = np.float32, _TO_F
    ti, zero = theta_turns(x)
    ti, zero = ti.numpy().astype(np.int64), zero.numpy()
    s0, s1, s2 = (f32(v) for v in state.tolist())
    phi_l0 = _to_int(s0 * _TO_I, "rn")
    fk0 = f32(_to_int(s2 * _TO_I, "rn"))
    phi_mf0 = _wrap_pi(s1)
    phi_m0 = _to_int(phi_mf0 * _TO_I, "rn")
    d, fk_rec, phi_l_end, fk_end = _walk(ti.tolist(), zero.tolist(),
                                         phi_l0, fk0, k)
    d_f = np.where(zero, f32(0), d.astype(np.float32))
    err = d_f * to_f
    if k["int_mult"]:
        terms = _trunc_i32(k["k_corr"] * d_f)
        c, total = _prefix_by_tiles(terms)
        phi_l = (ti - d - _I32[0]) % (1 << 32) + _I32[0]
        phi_m = phi_m0 + k["mult_i"] * (phi_l - phi_l0) - c
        phi_m = (phi_m - _I32[0]) % (1 << 32) + _I32[0]
        phim = phi_m.astype(np.float32) * to_f
        end_m = _wrap32(phi_m0 + k["mult_i"] * (phi_l_end - phi_l0) - total)
        st1 = f32(end_m) * to_f
    else:
        phim = np.empty(len(d), np.float32)
        phi_mf = phi_mf0
        for i in range(len(d)):
            phim[i] = phi_mf
            phi_mf = _wrap_pi(phi_mf + fk_rec[i] * k["k_fm"]
                              + k["k_amb"] * err[i])
        st1 = phi_mf
    phim = torch.from_numpy(phim)
    out = torch.complex(torch.cos(phim), torch.sin(phim))
    new_state = np.array([f32(phi_l_end) * to_f, st1, fk_end * to_f],
                         np.float32)
    return out, torch.from_numpy(err), torch.from_numpy(new_state)


def _assert_equal(got, exp):
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == e.dtype
        assert torch.equal(g, e), (g - e).abs().max()


def _state(fmin, fmax):
    return torch.tensor([0.3, -0.5, float((fmin + fmax) / 2)],
                        dtype=torch.float32)


def test_tile_is_the_kernel_tile():
    """The emulation's tile is the one csrc/pll.cu is built with (the card
    reports the built kernel's through lr_pll_tile in chip_smoke.py)."""
    src = (Path(pll.__file__).parent.parent / "csrc" / "pll.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) == T


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("mult", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("case", CASES)
def test_split_equals_twin_integer_multiplier(case, mult, n):
    """Walk plus tiled wrapping prefix sums: the twin's bits, at the tile
    edges (1, T - 1, T, T + 1, 3 T + 5 samples)."""
    alpha, beta, fmin, fmax = _params()
    x = torch.from_numpy(_case(case, n))
    st = _state(fmin, fmax)
    _assert_equal(split_phase(x, st, alpha, beta, fmin, fmax, mult),
                  pll_phase_reference(x, st, alpha, beta, fmin, fmax, mult))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("case", CASES)
def test_split_equals_twin_fractional_multiplier(case, n):
    """Multiplier 2.5: the walker's recorded fk and the rebuilt err feed
    a second walk of phi_m, which equals the twin's."""
    alpha, beta, fmin, fmax = _params()
    x = torch.from_numpy(_case(case, n))
    st = _state(fmin, fmax)
    _assert_equal(split_phase(x, st, alpha, beta, fmin, fmax, 2.5),
                  pll_phase_reference(x, st, alpha, beta, fmin, fmax, 2.5))


@pytest.mark.parametrize("mult", [1.0, 2.0, 2.5, 3.0])
@pytest.mark.parametrize("case", CASES)
def test_split_chains_across_calls(case, mult):
    """Two chained calls (3 T + 5 samples split at T + 7, the state
    passed on) equal the twin's two chained calls exactly.  One call over
    the concatenation departs from them only through the state, which
    crosses calls as float32 radians (rounding the integer phases and
    fk's fraction), in the twin as in the kernel: measured up to 5.8e-5 in
    out and the phases and 5.6e-6 in err (zeros + carrier, acquiring), it
    is held at the tolerances the twin meets against the float64 loop
    (tests/test_torch_pll.py: err 1e-3, out 5e-2, phases 1e-3, frequency
    1e-5), with err and the phases compared modulo 2 pi."""
    alpha, beta, fmin, fmax = _params()
    x = torch.from_numpy(_case(case, 3 * T + 5))
    st = _state(fmin, fmax)
    args = (alpha, beta, fmin, fmax, mult)
    parts, twin_parts, s, ts = [], [], st, st
    for xc in (x[:T + 7], x[T + 7:]):
        out, err, s = split_phase(xc, s, *args)
        parts.append((out, err))
        tout, terr, ts = pll_phase_reference(xc, ts, *args)
        twin_parts.append((tout, terr))
    got = tuple(torch.cat([p[j] for p in parts]) for j in (0, 1)) + (s,)
    _assert_equal(got, tuple(torch.cat([p[j] for p in twin_parts])
                             for j in (0, 1)) + (ts,))
    one = split_phase(x, st, *args)
    _assert_equal(one, pll_phase_reference(x, st, *args))

    def wrapped(a):
        return np.abs(np.angle(np.exp(1j * a.numpy().astype(np.float64))))
    assert (got[0] - one[0]).abs().max() < 5e-2
    assert wrapped(got[1] - one[1]).max() < 1e-3
    assert wrapped(got[2][:2] - one[2][:2]).max() < 1e-3
    assert abs(float(got[2][2] - one[2][2])) < 1e-5
