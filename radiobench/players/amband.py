"""Kind ``amband``: one capture of the whole AM broadcast band, a
synchronous-AM station on every channel of the configuration's grid,
replayed in a loop through ``IQFileSource(..., repeat_on_eof=True,
resident=<the mix's>)`` as fast as the graph takes it (a closed loop).

Station c, on channel c of C (FFT order: c above C / 2 are the negative
offsets), is double-sideband AM with its carrier, seeded by
``synth.row_seed(seed, c)``:

    A (1 + sum_i a_i cos(2 pi f_i t + phi_i)) exp(j (2 pi (c rate / C + d) t
                                                     + theta))

with A the mix's ``carrier_amplitude``, ``tones`` tones in
``tone_band_hz`` whose amplitudes a_i sum to ``modulation_depth``, a
carrier offset d within +-``carrier_offset_hz`` and a carrier phase theta.
Complex Gaussian noise over the whole band (its seed
``synth.row_seed(seed, C)``) is added to the stations' sum, which
``synth.quantize`` puts on the wire.  Every carrier and tone makes a whole
number of cycles over the capture, whose length is a whole number of the
graph's decimation C, so the looped capture is one seamless stream.  One
input stream: ``rows`` 1."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from radiobench import synth
from radiobench.drive import Capture


def offsets(cfg: dict) -> list[float]:
    """Each channel's frequency from the tuned one in Hz, in FFT order."""
    c, rate = int(cfg["channels"]), float(cfg["rate"])
    return [(k if k < c / 2 else k - c) * rate / c for k in range(c)]


def unit(cfg: dict) -> int:
    """The capture lengths that close at the wrap are the multiples of
    this: the decimation C (every frequency is snapped to whole cycles of
    the capture itself)."""
    return int(cfg["channels"])


def seamless_length(target: int, cfg: dict) -> int:
    return max(1, round(target / unit(cfg))) * unit(cfg)


def station(seed: int, n: int, rate: float, freq: float, sig: dict,
            idx: torch.Tensor) -> torch.Tensor:
    """One station's noiseless complex baseband at sample indices ``idx``
    of a capture of ``n`` samples, its carrier near ``freq`` Hz."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    per_hz = n / rate                       # cycles over the capture a Hz
    lo, hi = sig["tone_band_hz"]
    amps = sig["modulation_depth"] * rng.dirichlet(np.ones(sig["tones"]))
    ks = rng.integers(math.ceil(lo * per_hz), math.floor(hi * per_hz) + 1,
                      size=sig["tones"])
    phs = rng.uniform(0, 2 * np.pi, size=sig["tones"])
    d = float(rng.uniform(-1.0, 1.0)) * sig["carrier_offset_hz"]
    k_c = round((freq + d) * per_hz)
    theta = float(rng.uniform(0, 2 * np.pi))
    env = torch.ones(idx.shape, dtype=torch.float64, device=idx.device)
    for a, k, ph in zip(amps, ks, phs):
        env += float(a) * torch.cos(synth._cycles(int(k), idx, n)
                                   + float(ph))
    return sig["carrier_amplitude"] * torch.polar(
        env, synth._cycles(k_c, idx, n) + theta)


def capture(seed: int, n: int, cfg: dict, sig: dict,
            device) -> torch.Tensor:
    """The band's capture of ``n`` samples as wire items [2 n] on
    ``device``."""
    if n % unit(cfg):
        raise ValueError(f"a capture of {n} samples does not close at the "
                         f"wrap (unit {unit(cfg)})")
    rate = float(cfg["rate"])
    idx = torch.arange(n, dtype=torch.int64, device=device)
    iq = torch.zeros(n, dtype=torch.complex128, device=device)
    for c, f in enumerate(offsets(cfg)):
        iq += station(synth.row_seed(seed, c), n, rate, f, sig, idx)
    gen = torch.Generator(device=device)
    gen.manual_seed(synth.row_seed(seed, len(offsets(cfg))))
    noise = torch.randn((n, 2), generator=gen, dtype=torch.float64,
                        device=device) * sig["noise_sigma"]
    return synth.quantize(iq + torch.view_as_complex(noise), cfg["wire"])


class Player(Capture):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmpdir):
        # drive.Capture's length snaps to an FM station's periods; the
        # band's unit is the decimation alone
        self.cfg, self.mix = cfg, mix
        self.length = seamless_length(mix["capture_samples"], cfg)
        self.wire = [capture(seed, self.length, cfg, mix["signal"],
                             device).cpu().numpy()]
        self.paths = [os.path.join(tmpdir, f"capture0.{cfg['wire']}")]
        self.wire[0].tofile(self.paths[0])


__all__ = ["Player", "capture", "offsets", "seamless_length", "station",
           "unit"]
