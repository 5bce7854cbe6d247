"""The PLL linear tier's kernel (csrc/pll_linear.cu) on a CUDA card
against its twin (ops/pll_linear.py pll_linear_reference and coherence,
stock torch on the same card): locked pilots at multipliers 1, 2 and 3
on one row (cut in segments) and on a bank (a block a row), two chained
chunks each, with a noise row in the bank.  Flags equal on every row;
the pilot rows' out within 1e-5 and err and state within 1.2e-5 (1e-5
plus 2^-22 of a locked pilot's |tau| of a few radians: the twin's
float32 rounding; the kernel carries its prefix sums and recurrences in
float64); one launch a call.  Skipped without a
card; on the card (this file imports no JAX; the conftest does, so it
is left out):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_pll_linear_cuda.py
"""

import math

import pytest
import torch

from luaradio_tpu_torch.blocks.signal.carrier import PLLBlock
from luaradio_tpu_torch.ops import pll_linear as pl


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(mult, rate):
    blk = PLLBlock(100.0, 19e3 - 50, 19e3 + 50, multiplier=mult)
    blk.input_rate = rate
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max, mult


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 52430), (64, 20000)])
@pytest.mark.parametrize("mult", [1, 2, 3])
def test_kernel_matches_twin(dev, rows, n, mult):
    params = _params(mult, 220500.0)
    w = float(params[2] + params[3]) / 2
    gen = torch.Generator(device=dev).manual_seed(rows * 10 + mult)
    t = torch.arange(2 * n, dtype=torch.float64, device=dev)
    ph = torch.rand(rows, 1, generator=gen, dtype=torch.float64,
                    device=dev) * 6 - 3
    x = (torch.exp(1j * (w * t + ph)) + 0.05 * torch.randn(
        (rows, 2 * n), generator=gen, dtype=torch.complex128, device=dev)
         ).to(torch.complex64)
    if rows > 1:
        x[-1] = torch.randn(2 * n, generator=gen, dtype=torch.complex64,
                            device=dev)
    st = (ph[:, 0].float(), (mult * ph[:, 0]).float(),
          torch.full((rows,), w, dtype=torch.float32, device=dev))
    pilots = slice(0, rows - 1 if rows > 1 else 1)
    for chunk in (x[:, :n].contiguous(), x[:, n:].contiguous()):
        n0 = pl.pll_linear.launches
        flags, kst, out, err = pl.pll_linear_gated(chunk, st, *params)
        valid, tst, tout, terr = pl.pll_linear_reference(chunk, st, *params)
        torch.cuda.synchronize()
        assert pl.pll_linear.launches == n0 + 1
        assert torch.equal(flags[0], valid)
        assert torch.equal(flags[1], pl.coherence(chunk))
        assert flags[0][pilots].all()
        assert (out - tout)[pilots].abs().max().item() <= 1e-5
        assert (err - terr)[pilots].abs().max().item() <= 1.2e-5
        for i, (a, b) in enumerate(zip(kst, tst)):
            d = _wrap(a - b) if i < 2 else a - b
            assert d[pilots].abs().max().item() <= 1.2e-5
        st = tst
