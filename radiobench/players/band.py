"""Kind ``band``: one wideband capture of a whole broadcast band, a station
on every channel of the configuration's grid, replayed in a loop through
``IQFileSource(..., repeat_on_eof=True, resident=<the mix's>)`` as fast
as the graph takes it (a closed loop).

The band is made from radiobench/synth.py's parts: station c, on channel
c of C (FFT order: c above C / 2 are the negative offsets), is
``synth.baseband``'s FM multiplex seeded by ``synth.row_seed(seed, c)``
with its carrier at c rate / C from the tuned frequency; complex Gaussian
noise over the whole band (its seed ``synth.row_seed(seed, C)``) is added
to their sum, which ``synth.quantize`` puts on the wire.  Every carrier,
pilot and tone makes a whole number of cycles over the capture, whose
length is also a whole number of the graph's total decimation, so the
looped capture is one seamless stream.  One input stream: ``rows`` 1."""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from radiobench import synth
from radiobench.drive import Capture


def offsets(cfg: dict) -> list[float]:
    """Each channel's carrier offset from the tuned frequency in Hz, in
    FFT order."""
    c, rate = int(cfg["channels"]), float(cfg["rate"])
    return [(k if k < c / 2 else k - c) * rate / c for k in range(c)]


def unit(cfg: dict) -> int:
    """The capture lengths that close at the wrap are the multiples of
    this: every carrier's period, the pilot's, and the total decimation
    (C times the audio's)."""
    rate = float(cfg["rate"])
    if_ds, af_ds = synth.decimations(rate, cfg["if_rate"], cfg["af_rate"])
    periods = [Fraction(f / rate).limit_denominator(1 << 24).denominator
               for f in offsets(cfg) + [synth.PILOT_HZ]]
    return math.lcm(if_ds * af_ds, *periods)


def capture(seed: int, n: int, cfg: dict, sig: dict,
            device) -> torch.Tensor:
    """The band's capture of ``n`` samples as wire items [2 n] on
    ``device``."""
    if n % unit(cfg):
        raise ValueError(f"a capture of {n} samples does not close at the "
                         f"wrap (unit {unit(cfg)})")
    iq = torch.zeros(n, dtype=torch.complex128, device=device)
    for c, f in enumerate(offsets(cfg)):
        station, _ = synth.baseband(synth.row_seed(seed, c), n,
                                    dict(cfg, tune_offset=-f), sig, device)
        iq += station
    gen = torch.Generator(device=device)
    gen.manual_seed(synth.row_seed(seed, len(offsets(cfg))))
    noise = torch.randn((n, 2), generator=gen, dtype=torch.float64,
                        device=device) * sig["noise_sigma"]
    return synth.quantize(iq + torch.view_as_complex(noise), cfg["wire"])


class Player(Capture):
    def _make(self, seed, device) -> list[np.ndarray]:
        return [capture(seed, self.length, self.cfg, self.mix["signal"],
                        device).cpu().numpy()]


__all__ = ["Player", "capture", "offsets", "unit"]
