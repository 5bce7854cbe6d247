#!/usr/bin/env python3
"""A first check of K3 and the overlap scan widened to banks [C, N], on
one card: each row of a banked launch against a one-row launch of that
row (bit equality), K3 against its twin on two rows, torch.cumprod on a
bank's rows against each row alone, and K3 a launch on 1 to 264 rows of
52 430 samples (CUDA events around one call).

    python3 scratch/bank_check.py

chip_smoke.py's bank phases hold the same on the bank paths; this is the
short call that builds and checks the kernels alone.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from luaradio_tpu_torch.ops import cudabuild, pll, pll_overlap  # noqa: E402

A, B, FMIN, FMAX = 7.57e-3, 2.9e-5, 0.2, 0.6


def signal(gen, dev, c, n):
    """Unit phasors turning ~0.3 rad a sample plus noise; row 1 starts
    with a third of zeros."""
    ph = torch.cumsum(0.3 + 0.05 * torch.randn((c, n), generator=gen,
                                               device=dev), -1)
    z = torch.polar(torch.ones_like(ph), ph) + 0.1 * torch.randn(
        (c, n), generator=gen, device=dev, dtype=torch.complex64)
    z[1, :n // 3] = 0
    return z.to(torch.complex64).contiguous()


def main():
    cudabuild.build(("pll", "pll_overlap"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for n in (0, 1, 511, 513, 1541, 52430):
        for mult in (1.0, 2.0, 3.0, 2.5):
            c = 5
            x = signal(gen, dev, c, max(n, 1))[:, :n].contiguous()
            st = torch.tensor([[0.1, 0.2, 0.4]] * c, device=dev) \
                + 0.1 * torch.arange(c, device=dev)[:, None]
            out = pll.pll_phase(x, st, A, B, FMIN, FMAX, mult)
            bad = sum(not all(torch.equal(u[r], v) for u, v in zip(
                out, pll.pll_phase(x[r].contiguous(), st[r].contiguous(),
                                   A, B, FMIN, FMAX, mult)))
                      for r in range(c))
            twin = None
            if n <= 1541 and mult != 2.5:
                ref = pll.pll_phase_reference(x[:2].contiguous(),
                                              st[:2].contiguous(), A, B,
                                              FMIN, FMAX, mult)
                twin = max((u[:2] - v).abs().max().item() if u.numel()
                           else 0.0 for u, v in zip(out, ref))
            print(f"K3 N={n} mult={mult}: rows off their one-row launch "
                  f"{bad}; |kernel - twin| on 2 rows {twin}", flush=True)
    x = signal(gen, dev, 4, 1 << 16)
    st = (torch.zeros(4, device=dev), torch.zeros(4, device=dev),
          torch.full((4,), 0.4, device=dev))
    got = pll_overlap.pll_overlap_discard(x, st, A, B, FMIN, FMAX, 2.0,
                                          8192, 1585)
    for r in range(4):
        one = pll_overlap.pll_overlap_discard(
            x[r].contiguous(), tuple(v[r] for v in st), A, B, FMIN, FMAX,
            2.0, 8192, 1585)
        print(f"scan row {r}: valid {bool(got[0][r]) == bool(one[0])}, "
              f"out {torch.equal(got[2][r], one[2])}, err "
              f"{torch.equal(got[3][r], one[3])}, state "
              f"{all(torch.equal(u[r], v) for u, v in zip(got[1], one[1]))}",
              flush=True)
    # what the scan's chaining met: torch.cumprod of unit phasors along
    # the rows of a bank against the same rows alone
    for s in (8, 64, 4096):
        z = torch.polar(torch.ones(4, s, device=dev),
                        torch.randn((4, s), generator=gen, device=dev))
        bank = torch.cumprod(z, dim=1)
        same = [torch.equal(bank[r], torch.cumprod(z[r:r + 1], dim=1)[0])
                for r in range(4)]
        print(f"torch.cumprod [4, {s}] rows equal to each row alone: "
              f"{same}", flush=True)
    for c in (1, 8, 64, 132, 264):
        x = signal(gen, dev, max(c, 2), 52430)[:c].contiguous()
        st = torch.tensor([[0.0, 0.0, 0.4]] * c, device=dev)
        for _ in range(2):
            pll.pll_phase(x, st, A, B, FMIN, FMAX, 2.0)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        pll.pll_phase(x, st, A, B, FMIN, FMAX, 2.0)
        b.record()
        b.synchronize()
        print(f"K3 on {c} rows x 52430: {a.elapsed_time(b):.4f} ms a launch",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
