"""The PLL ablations S7 on the card (scratch/pll_ablate.py, on the port):
what each part of a serial float PLL step costs.

    python -m luaradio_tpu_torch.benchmarks.pll_ablate [--out PATH]

On n = 2^21 samples of normal noise (seed 0) from a zero state, with the
script's constants (alpha 0.01, beta 1e-4, fmin -1, fmax 1, multiplier
1): ``shipped`` is the port's K3 (ops/pll.py ``pll_phase``) on the same
samples, then each variant of ops/pll_ablate.py (``full``, ``no-osc``,
``no-atan``, ``bare``), each in M samples/s from the median of ``reps``
calls by CUDA events, printed a line each as the script prints them.  On
the card each variant also gets its chain probe (``chain_probe``: the
step alone in one thread, clock64) in M samples/s, ns and SM cycles a
step.  For ``full`` the probe is the floor of the loop-carried chain; a
variant may run below its own (``no-atan`` does), so for it the probe
is a cost, not a floor.  Prints one JSON object last (``--out`` also
writes it), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.ops import pll, pll_ablate

N = 1 << 21
PARAMS = (0.01, 1e-4, -1.0, 1.0, 1.0)
REPS = 3


def inputs(dev, n=N):
    """(x [2, n] of normal noise from seed 0, the zero state [3]) on
    ``dev``."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n)).astype(np.float32)).to(dev)
    return x, torch.zeros(3, dtype=torch.float32, device=dev)


def run(device=None, n=N, reps=REPS, emit=print) -> dict:
    """The script's record on ``device`` (the card by default)."""
    dev, info = common.setup(device)
    x, state = inputs(dev, n)
    z = torch.complex(x[0], x[1])
    rec = {"device": info["device"], "power_limit_w": info["power_limit_w"],
           "n": n, "params": list(PARAMS)}
    ms = common.event_ms(lambda: pll.pll_phase(z, state, *PARAMS), dev, reps,
                         warmup=1)
    rec["shipped"] = n / ms / 1e3
    emit(f"shipped: {rec['shipped']:.1f} MS/s")
    floors = {}
    for v in pll_ablate.VARIANTS:
        ms = common.event_ms(
            lambda: pll_ablate.pll_ablate(x, state, *PARAMS, v), dev, reps,
            warmup=1)
        rec[v] = n / ms / 1e3
        line = f"{v:8s}: {rec[v]:.1f} MS/s"
        if dev.type == "cuda":
            pll_ablate.chain_probe(1024, v, *PARAMS, dev)       # warm-up
            fms, cycles, steps = pll_ablate.chain_probe(n, v, *PARAMS, dev)
            floors[v] = {"MSps": steps / fms / 1e3,
                         "ns_per_step": fms * 1e6 / steps,
                         "cycles_per_step": cycles / steps,
                         "ratio_to_probe": (1e3 / rec[v])
                         / (fms * 1e6 / steps)}
            line += (f"  (chain probe {floors[v]['MSps']:.1f} MS/s, "
                     f"{floors[v]['cycles_per_step']:.1f} cycles a step)")
        emit(line)
    if floors:
        rec["chain_probe"] = floors
    rec["method"] = ("M samples/s from the median of the repetitions' CUDA "
                     "event times; chain probes from one thread's clock64 "
                     "count and CUDA events")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the object here")
    args = ap.parse_args(argv)
    common.emit(run(), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
