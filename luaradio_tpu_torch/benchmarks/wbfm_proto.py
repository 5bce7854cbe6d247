"""The flagship kernel taken apart, S4, on the card (scratch/wbfm_proto.py,
on the port): K1's function at each precision of its two products and
stopped after each stage.

    python -m luaradio_tpu_torch.benchmarks.wbfm_proto [--out PATH]

At the script's size (C = 8, T = 2^22, x normal from seed 0, a zero carry,
taps 120 Hann-windowed sinc + 8 zeros, D = 8, inv_gain 1): ``prod_GSps``
is the port's K1 (ops/wbfm.py ``wbfm_mono``), then for each variant of
the script's ``main()`` (:250-254) and each added here (every other
precision, and the four stages at tile 2^14) ops/wbfm_proto.py
``wbfm_proto``'s ``<name>_GSps`` and, for the full stage, its
``<name>_rel_err``: max |variant - K1| over max |K1|.  Rates are complex
samples/s from the median of ``reps`` calls by CUDA events.  Prints one
JSON object (``--out`` also writes it), with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.ops import wbfm, wbfm_proto

C, T, TILE, D = 8, 1 << 22, 1 << 14, 8
#: (name, deint_prec, fir_prec, stage, tile as a multiple of TILE): the
#: script's main() variants, then the other precisions and the stages
VARIANTS = (("v2_sel3_fir22", "sel3", "split22", "full", 1),
            ("v3_sel3cat_fir2", "sel3cat", "two", "full", 1),
            ("v3_sel3_fir2", "sel3", "two", "full", 1),
            ("v3_sel3cat_fir22", "sel3cat", "split22", "full", 1),
            ("v3_sel3cat_fir2_t32k", "sel3cat", "two", "full", 2),
            ("p_highest", "highest", "highest", "full", 1),
            ("p_default", "default", "default", "full", 1),
            ("p_sel3", "sel3", "sel3", "full", 1),
            ("p_sel2", "sel2", "sel2", "full", 1),
            ("p_two_hi", "highest", "two_hi", "full", 1),
            ("stage_dma_only", "sel3cat", "two", "dma_only", 1),
            ("stage_no_deint", "sel3cat", "two", "no_deint", 1),
            ("stage_deint_only", "sel3cat", "two", "deint_only", 1),
            ("stage_no_fir", "sel3cat", "two", "no_fir", 1))
REPS = 3


def proto_taps() -> np.ndarray:
    """The script's taps: 120 of a Hann-windowed sinc and 8 zeros."""
    taps = (np.hanning(120) * np.sinc(np.linspace(-4, 4, 120))).astype(
        np.float32)
    return np.concatenate([taps, np.zeros(8, np.float32)])


def inputs(dev, c=C, t=T, seed=0):
    """(x [c, 2t], the zero carry [c, 2K], taps [K]) on ``dev``."""
    x = np.random.default_rng(seed).standard_normal((c, 2 * t)).astype(
        np.float32)
    taps = proto_taps()
    return (torch.from_numpy(x).to(dev),
            torch.zeros((c, 2 * len(taps)), dtype=torch.float32, device=dev),
            torch.from_numpy(taps).to(dev))


def run(device=None, c=C, t=T, tile=TILE, reps=REPS,
        variants=VARIANTS) -> dict:
    """The script's record on ``device`` (the card by default)."""
    dev, info = common.setup(device)
    x, carry, taps = inputs(dev, c, t)
    k = taps.shape[0]
    kcarry = torch.zeros((c, k), dtype=torch.complex64, device=dev)
    _, prod = wbfm.wbfm_mono(kcarry, x, taps, D, 1.0)
    scale = float(prod.abs().max())
    ms = common.event_ms(lambda: wbfm.wbfm_mono(kcarry, x, taps, D, 1.0),
                         dev, reps)
    rec = {"device": info["device"], "power_limit_w": info["power_limit_w"],
           "shape": [c, t], "tile": tile, "prod_GSps": c * t / ms / 1e6,
           "prod_ms": ms}
    for name, dp, fp, st, mul in variants:
        def call():
            return wbfm_proto.wbfm_proto(carry, x, taps, D, 1.0, mul * tile,
                                         128, dp, fp, st)
        if st == "full":
            _, audio = call()
            err = float((audio - prod).abs().max())
            rec[f"{name}_rel_err"] = err / scale
        ms = common.event_ms(call, dev, reps)
        rec[f"{name}_GSps"] = c * t / ms / 1e6
        rec[f"{name}_ms"] = ms
    rec["method"] = ("complex samples/s from the median of the repetitions' "
                     "CUDA event times; rel_err against K1 on the same "
                     "input")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the object here")
    args = ap.parse_args(argv)
    common.emit(run(), args.out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
