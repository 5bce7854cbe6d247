"""The PLL linear tier's CPU side (ops/pll_linear.py, csrc/pll_linear.cu):
the router sends a CPU tensor to the twin (bit-equal to
``pll_linear_reference``, which tests/test_torch_pll.py holds against the
JAX package) and raises on any other non-CUDA device; the kernel's launch
plan at the stereo pilot's, the AM band's and a bank's shapes; its
float32 constants against the twin's; ``pll_linear.launches`` staying 0 on
the CPU; and the fused coherence gate, row 1 of the flags that
``pll_hybrid`` reads, against its definition on carrier rows and
carrier-free rows.  The kernel itself runs only on a card
(tests/test_torch_pll_linear_cuda.py, chip_smoke.py's pll-linear phase).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from luaradio_tpu_torch.ops import pll_linear as pl  # noqa: E402
from luaradio_tpu_torch.ops.pll_linear import (  # noqa: E402
    _eigen_setup, pll_hybrid)
from tests.test_torch_bank_pll import _mixed_bank  # noqa: E402

SMS = 132           # an H100's SMs


def _args(blk, mult=1):
    return (blk._alpha, blk._beta, blk._freq_min, blk._freq_max, mult)


@pytest.mark.parametrize("mult", [1, 2, 3])
@pytest.mark.parametrize("one", [False, True])
def test_router_sends_a_cpu_tensor_to_the_twin(mult, one):
    """On the CPU, pll_linear is the twin, output for output and bit for
    bit, for a bank and for one stream; the gated form's first row of
    flags is the twin's ``valid``; no kernel launches."""
    blk, x, st = _mixed_bank(2048)
    xt = torch.from_numpy(x[1] if one else x)
    st = tuple(v[1] for v in st) if one else st
    n0 = pl.pll_linear.launches
    got = pl.pll_linear(xt, st, *_args(blk, mult))
    exp = pl.pll_linear_reference(xt, st, *_args(blk, mult))
    assert torch.equal(got[0], exp[0])
    assert all(torch.equal(u, w) for u, w in zip(got[1], exp[1]))
    assert torch.equal(got[2], exp[2]) and torch.equal(got[3], exp[3])
    flags, gst, gout, gerr = pl.pll_linear_gated(
        xt[None] if one else xt, st, *_args(blk, mult))
    assert flags.dtype == torch.bool and flags.shape == (2, 1 if one else 4)
    assert torch.equal(flags[0], exp[0].reshape(-1))
    assert torch.equal(gout.reshape(exp[2].shape), exp[2])
    assert torch.equal(gerr.reshape(exp[3].shape), exp[3])
    assert pl.pll_linear.launches == n0


@pytest.mark.parametrize("call", ["pll_linear", "pll_linear_gated"])
def test_router_raises_on_another_device(call):
    """A tensor on neither the CPU nor a CUDA card raises, before any
    work."""
    x = torch.empty(2, 64, dtype=torch.complex64, device="meta")
    st = tuple(torch.zeros(2, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(pl, call)(x, st, 0.1, 0.01, -1.0, 1.0, 1)


@pytest.mark.parametrize("rows,n", [(1, 52430), (117, 65536), (264, 65536),
                                    (8, 65536), (50, 65536), (1, 1 << 22),
                                    (3, 1)])
def test_plan_gives_a_valid_grid(rows, n):
    """The grid covers every sample of every row once: segments of whole
    tiles (the last may be short, never empty), a block each; a block a
    row once the rows fill half the card; a cut row's blocks no more than
    the card's SMs (all resident for the grid barrier)."""
    p = pl.plan(rows, n, SMS)
    assert p.segs >= 1 and p.grid == rows * p.segs
    assert p.seg_len % pl.TILE == 0 and p.seg_len > 0
    assert (p.segs - 1) * p.seg_len < n <= p.segs * p.seg_len
    if 2 * rows > SMS or n <= pl.TILE:
        assert p.segs == 1
    else:
        assert 1 < p.segs and p.grid <= SMS
    assert 0 < p.grid < 2 ** 31


def test_plan_cuts_the_pilot_and_not_the_band():
    """The stereo pilot's row is cut so no one SM walks it alone; the AM
    band's 117 rows and a 264-row bank take a block a row."""
    assert pl.plan(1, 52430, SMS) == pl.Plan(13, 4096, 13)
    assert pl.plan(117, 65536, SMS) == pl.Plan(1, 65536, 117)
    assert pl.plan(264, 65536, SMS) == pl.Plan(1, 65536, 264)
    with pytest.raises(ValueError):
        pl.plan(0, 10, SMS)


@pytest.mark.parametrize("mult", [1, 2, 3])
def test_constants_are_the_twins_roundings(mult):
    """The kernel's constants: the twin's float32 scalars and its
    complex64 roundings of the loop's eigen decomposition, in the order
    csrc/pll_linear.cu reads them."""
    blk, _, _ = _mixed_bank(64)
    alpha, beta, fmin, fmax = (np.float32(v) for v in _args(blk)[:4])
    k = pl._constants(float(alpha), float(beta), float(fmin), float(fmax),
                      mult)
    assert k.dtype == np.float32 and k.shape == (27,)
    assert list(k[:7]) == [alpha, beta, fmin, fmax,
                           np.float32(np.pi * (15.0 / 16.0)),
                           alpha * np.float32(1 - mult),
                           alpha - np.float32(1.0)]
    lam, vmat, vinv = _eigen_setup(alpha, beta)
    w_in = vinv @ np.array([alpha + beta, beta], np.complex128)
    pairs = k[7:].view(np.complex64).reshape(5, 2)
    for got, exp in zip(pairs, (lam, w_in, vinv[:, 1], vmat[0], vmat[1])):
        assert np.array_equal(got, np.asarray(exp).astype(np.complex64))


def test_launches_stay_zero_on_the_cpu():
    """pll_linear, its gated form and pll_hybrid on CPU tensors launch
    no kernel."""
    blk, x, st = _mixed_bank(1024)
    n0 = pl.pll_linear.launches
    pl.pll_linear(torch.from_numpy(x), st, *_args(blk))
    pl.pll_linear_gated(torch.from_numpy(x), st, *_args(blk))
    pll_hybrid(torch.from_numpy(x), st, *_args(blk), blk._sequential)
    assert pl.pll_linear.launches == n0 == 0


def test_fused_coherence_is_pll_hybrids_gate():
    """Row 1 of the flags, the gate pll_hybrid reads with the guards,
    against its definition (|sum x[n] conj x[n-1]| > 0.05 sum |x|^2, in
    float64) on the dispatch test's rows: two carrier rows (a locked one
    and a weak one from a cold start) pass, the carrier-free rows (noise,
    zeros) fail; pll_hybrid then sends the weak carrier to the overlap
    scan and the carrier-free rows to K3."""
    blk, x, st = _mixed_bank()
    flags, _, _, _ = pl.pll_linear_gated(torch.from_numpy(x), st,
                                         *_args(blk))
    xd = x.astype(np.complex128)
    lag = np.abs((xd[:, 1:] * np.conj(xd[:, :-1])).sum(-1))
    want = lag > 0.05 * np.maximum((np.abs(xd) ** 2).sum(-1), 1e-30)
    assert flags[1].tolist() == want.tolist() == [True, True, False, False]
    assert torch.equal(flags[1], pl.coherence(torch.from_numpy(x)))
    tiers = []
    pll_hybrid(torch.from_numpy(x), st, *_args(blk), blk._sequential,
               row_tiers=tiers)
    assert tiers == [1, 2, 3, 3]
