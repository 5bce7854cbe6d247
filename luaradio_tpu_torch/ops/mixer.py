"""Complex phasor rotation (frequency translation).

The reference implements this with a VOLK rotator / liquid NCO per sample
(radio/blocks/signal/frequencytranslator.lua:32-112).  Here the rotator is
an elementwise multiply by a precomputed phasor ramp.  exp(j*omega*n) in
float32 loses all phase accuracy for n ~ 1e6 (omega*n ~ 1e7 rad, float32
ulp ~ 1 rad), so the ramp is built from a **split-index table pair**
computed on the host in float64:

    rot[q*K + r] = E1[q] * E2[r],   E1[q] = exp(j*((omega*K*q) mod 2pi))
                                    E2[r] = exp(j*((omega*r)   mod 2pi))

giving ~1e-7 phase error for arbitrarily long chunks.  The carried state is
a single wrapped float32 phase; the per-chunk increment (omega*N mod 2pi)
is a float64 host constant.
"""

from __future__ import annotations

import numpy as np
import torch

_K = 1024


class PhasorRamp:
    """Phasor ramp tables for a fixed rotation rate, cached per chunk
    length on one device."""

    def __init__(self, omega: float, device):
        self.omega = float(omega)
        self.device = device
        self._cache: dict[int, tuple[torch.Tensor, float]] = {}

    def _tables(self, n: int):
        if n not in self._cache:
            two_pi = 2 * np.pi
            nq = -(-n // _K)
            r = np.arange(_K, dtype=np.float64)
            q = np.arange(nq, dtype=np.float64)
            e2 = np.exp(1j * np.mod(self.omega * r, two_pi))
            e1 = np.exp(1j * np.mod(self.omega * _K * q, two_pi))
            ramp = (e1[:, None] * e2[None, :]).reshape(-1)[:n]
            dphi = float(np.mod(self.omega * n, two_pi))
            self._cache[n] = (
                torch.from_numpy(ramp.astype(np.complex64)).to(self.device),
                dphi)
        return self._cache[n]

    def rotate(self, x: torch.Tensor, phase0: torch.Tensor):
        """y = x * exp(j*(omega*n + phase0)); returns (y, new_phase)."""
        p, new_phase = self.phasor(x.shape[-1], phase0)
        return x * p, new_phase

    def phasor(self, n: int, phase0: torch.Tensor):
        """exp(j*(omega*k + phase0)) for k in [0, n); returns
        (p, new_phase) with the phase wrapped to [-pi, pi]."""
        ramp, dphi = self._tables(n)
        rot0 = torch.polar(torch.ones_like(phase0), phase0)
        p = ramp * rot0[..., None]
        two_pi = np.float32(2 * np.pi)
        new_phase = phase0 + np.float32(dphi)
        new_phase = new_phase - two_pi * torch.round(new_phase / two_pi)
        return p, new_phase


class FracRamp:
    """Phase-position ramp frac((omega*n + phase0) / 2pi) in [0, 1), for
    the waveform sources (square/triangle/sawtooth/cosine/sine).  Same
    split-index float64 tables as PhasorRamp for long-stream accuracy."""

    def __init__(self, omega: float, device):
        self.omega = float(omega)
        self.device = device
        self._cache: dict[int, tuple[torch.Tensor, float]] = {}

    def _tables(self, n: int):
        if n not in self._cache:
            f = self.omega / (2 * np.pi)  # cycles per sample
            nq = -(-n // _K)
            r = np.arange(_K, dtype=np.float64)
            q = np.arange(nq, dtype=np.float64)
            t2 = np.mod(f * r, 1.0)
            t1 = np.mod(f * _K * q, 1.0)
            ramp = np.mod(t1[:, None] + t2[None, :], 1.0).reshape(-1)[:n]
            dfrac = float(np.mod(f * n, 1.0))
            self._cache[n] = (
                torch.from_numpy(ramp.astype(np.float32)).to(self.device),
                dfrac)
        return self._cache[n]

    def positions(self, n: int, frac0: torch.Tensor):
        """Wrapped cycle positions for k in [0, n); frac0 in [0, 1).
        Returns (pos [n] float32 in [0, 1), new_frac0)."""
        ramp, dfrac = self._tables(n)
        pos = ramp + frac0[..., None]
        pos = pos - torch.floor(pos)
        new_frac = frac0 + np.float32(dfrac)
        return pos, new_frac - torch.floor(new_frac)


__all__ = ["PhasorRamp", "FracRamp"]
