"""Filtering blocks on the main path.

Equivalents of the reference's filter family
(radio/blocks/signal/firfilter.lua, iirfilter.lua, lowpassfilter.lua,
fmdeemphasisfilter.lua).  FIR filters run as float32 convolutions
(ops/fir.py); single-pole IIR recurrences as blocked matrix products
(ops/scan.py).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import fir as fir_ops
from luaradio_tpu_torch.ops.scan import linrec_first_order
from luaradio_tpu_torch.types import ComplexFloat32, Float32
from luaradio_tpu_torch.utils import filter_design


def _taps_tensor(taps: np.ndarray, device) -> torch.Tensor:
    dt = np.complex64 if np.iscomplexobj(taps) else np.float32
    return torch.from_numpy(np.ascontiguousarray(taps, dtype=dt)).to(device)


class FIRFilterBlock(SignalBlock):
    """Streaming FIR filter.

    Signatures mirror the reference (firfilter.lua:28-50): complex taps x
    complex input, real taps x complex input, real taps x real input.  One
    convolution per chunk whatever the tap count (the reference's FFT
    overlap-save path, firfilter.lua:313-492, is a CPU optimisation)."""

    def __init__(self, taps):
        super().__init__()
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            self.taps = taps.astype(np.complex64)
            self.add_type_signature([Input("in", ComplexFloat32)],
                                    [Output("out", ComplexFloat32)])
        else:
            self.taps = taps.astype(np.float32)
            self.add_type_signature([Input("in", ComplexFloat32)],
                                    [Output("out", ComplexFloat32)])
            self.add_type_signature([Input("in", Float32)],
                                    [Output("out", Float32)])

    def initialize(self):
        self._taps = _taps_tensor(self.taps, self.device)

    def init_state(self):
        dtype = (torch.complex64 if self.get_input_type() == ComplexFloat32
                 else torch.float32)
        return fir_ops.fir_init_state(len(self.taps), dtype, self.device)

    def process(self, state, x):
        y, state = fir_ops.fir_direct(x, self._taps, state)
        return state, y

    def fir_equivalent(self):
        """Graph-optimizer protocol: this block's exact FIR taps (designed
        with the propagated rate when needed).  See core/optimize.py."""
        if isinstance(self, _DesignedFIRBlock):
            return np.asarray(self.design_taps())
        return np.asarray(self.taps)


class IIRFilterBlock(SignalBlock):
    """IIR filter y = (b/a) * x (reference: iirfilter.lua).

    This slice of the port runs filters of order <= 1 — the single-pole
    designs of the receivers (deemphasis, single-pole lowpass) — in the
    transposed direct form II: s[n] = -a1 s[n-1] + g x[n],
    y[n] = b0 x[n] + s[n-1], with the recurrence solved by
    ops/scan.py linrec_first_order.  Higher orders raise."""

    def __init__(self, b_taps, a_taps):
        super().__init__()
        self.b_taps = np.asarray(b_taps, dtype=np.float64)
        self.a_taps = np.asarray(a_taps, dtype=np.float64)
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", Float32)])

    def _design_ba(self):
        """(b, a) coefficients; wrappers whose design depends on the
        propagated rate override this (it runs after rate validation)."""
        return self.b_taps, self.a_taps

    def initialize(self):
        self.b_taps, self.a_taps = self._design_ba()
        b = self.b_taps / self.a_taps[0]
        a = self.a_taps / self.a_taps[0]
        order = max(len(b), len(a)) - 1
        if order > 1:
            raise NotImplementedError(
                f"{self.name}: IIR order {order} is not ported yet "
                f"(order <= 1 only)")
        bb = np.zeros(2)
        bb[:len(b)] = b
        a1 = a[1] if len(a) > 1 else 0.0
        self._order = order
        self._b0 = float(np.float32(bb[0]))
        self._g = float(np.float32(bb[1] - a1 * bb[0]))
        self._pole = float(np.float32(-a1))

    def init_state(self):
        dtype = (torch.complex64 if self.get_input_type() == ComplexFloat32
                 else torch.float32)
        return torch.zeros((self._order,), dtype=dtype, device=self.device)

    def process(self, state, x):
        if self._order == 0:
            return state, x * self._b0
        s_in = state[..., 0]
        s = linrec_first_order(x * self._g, self._pole, s_in)
        s_prev = torch.cat([s_in.expand(x.shape[:-1])[..., None],
                            s[..., :-1]], dim=-1)
        y = x * self._b0 + s_prev
        return s[..., -1:], y

    def fir_equivalent(self):
        """Graph-optimizer protocol: the truncated impulse response when the
        filter decays into float32 noise quickly enough, else None.  See
        core/optimize.py."""
        b, a = self._design_ba()
        return fir_ops.iir_to_fir_taps(b, a, tol=1e-10)


class _DesignedFIRBlock(FIRFilterBlock):
    """FIR whose taps are designed at initialize() time from the propagated
    sample rate (like the reference wrappers, which design taps in
    initialize() using the differentiated rate)."""

    def __init__(self, num_taps: int, complex_taps: bool = False):
        super().__init__(np.zeros(num_taps, dtype=np.complex64 if complex_taps
                                  else np.float32))
        self.num_taps = num_taps

    def design_taps(self) -> np.ndarray:
        raise NotImplementedError

    def initialize(self):
        dt = np.complex64 if np.iscomplexobj(self.taps) else np.float32
        self.taps = np.asarray(self.design_taps()).astype(dt)
        super().initialize()


class LowpassFilterBlock(_DesignedFIRBlock):
    def __init__(self, num_taps: int, cutoff: float,
                 nyquist: float | None = None, window: str = "hamming"):
        super().__init__(num_taps)
        self.cutoff = cutoff
        self.nyquist = nyquist
        self.window = window

    def design_taps(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        return filter_design.firwin_lowpass(self.num_taps, self.cutoff / nyq,
                                            self.window)


class ComplexBandpassFilterBlock(_DesignedFIRBlock):
    """Complex (single-sided) bandpass; cutoffs in Hz, negative allowed
    (reference: complexbandpassfilter.lua)."""

    def __init__(self, num_taps: int, cutoffs, nyquist: float | None = None,
                 window: str = "hamming"):
        super().__init__(num_taps, complex_taps=True)
        self.cutoffs = tuple(cutoffs)
        self.nyquist = nyquist
        self.window = window

    def design_taps(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        return filter_design.firwin_complex_bandpass(
            self.num_taps, (self.cutoffs[0] / nyq, self.cutoffs[1] / nyq),
            self.window)


def _singlepole_lowpass_coeffs(cutoff: float, rate: float):
    """Bilinear-transform 1-pole lowpass H(s) = 1/(1 + s/wc) with
    prewarping (reference: singlepolelowpassfilter.lua)."""
    k = np.tan(np.pi * cutoff / rate)
    b = np.array([k / (1 + k), k / (1 + k)])
    a = np.array([1.0, (k - 1) / (1 + k)])
    return b, a


class FMDeemphasisFilterBlock(IIRFilterBlock):
    """FM deemphasis: 1-pole lowpass at 1/(2*pi*tau)
    (reference: fmdeemphasisfilter.lua:25-28)."""

    def __init__(self, tau: float):
        super().__init__([1.0], [1.0])
        self.tau = tau

    def _design_ba(self):
        cutoff = 1.0 / (2 * np.pi * self.tau)
        return _singlepole_lowpass_coeffs(cutoff, self.get_rate())


class DecimatingFIRBlock(SignalBlock):
    """Fused causal FIR + decimate-by-D, synthesized by the graph optimizer
    (core/optimize.py) from FIR/IIR/Downsampler chains: only every D-th
    convolution output is computed (ops/fir.py fir_decimate).  The
    reference has no analog — its pipeline filters at full rate and
    discards 1-1/D of the output in the downsampler
    (radio/blocks/signal/downsampler.lua).

    Also constructible directly by users who want an explicit polyphase
    decimator."""

    def __init__(self, taps, decimation: int = 1):
        super().__init__()
        taps = np.asarray(taps)
        self.taps = (taps.astype(np.complex64) if np.iscomplexobj(taps)
                     else taps.astype(np.float32))
        self.decimation = int(decimation)
        real_out = Float32 if not np.iscomplexobj(taps) else ComplexFloat32
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", real_out)])

    @classmethod
    def synth(cls, taps, decimation, in_type, rate, device,
              name_hint: str = ""):
        """Build a fully-differentiated instance for graph rewriting."""
        blk = cls(taps, decimation)
        blk.differentiate([in_type])
        blk.input_rate = rate
        blk.device = device
        if name_hint:
            blk.name = f"DecimatingFIRBlock[{name_hint}]"
        return blk

    def get_rate_ratio(self):
        return Fraction(1, self.decimation)

    def chunk_multiple(self):
        return self.decimation

    def initialize(self):
        self._taps = _taps_tensor(self.taps, self.device)

    def init_state(self):
        dtype = (torch.complex64 if self.get_input_type() == ComplexFloat32
                 else torch.float32)
        return fir_ops.fir_init_state(len(self.taps), dtype, self.device)

    def process(self, state, x):
        y, state = fir_ops.fir_decimate(x, self._taps, state,
                                        self.decimation)
        return state, y

    def fir_equivalent(self):
        return np.asarray(self.taps) if self.decimation == 1 else None


class HilbertTransformBlock(SignalBlock):
    """Real -> analytic signal: the real part delayed by the filter's group
    delay, the imaginary part through the windowed 2/(pi n) FIR
    (reference: hilberttransform.lua)."""

    def __init__(self, num_taps: int, window: str = "hamming"):
        super().__init__()
        if num_taps % 2 == 0:
            raise ValueError("HilbertTransformBlock requires odd num_taps")
        self.num_taps = num_taps
        self.taps = filter_design.fir_hilbert_transform(
            num_taps, window).astype(np.float32)
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", ComplexFloat32)])

    def initialize(self):
        self._taps = _taps_tensor(self.taps, self.device)

    def init_state(self):
        return fir_ops.fir_init_state(self.num_taps, torch.float32,
                                      self.device)

    def process(self, state, x):
        m = self.num_taps
        c = (m - 1) // 2
        xin = torch.cat([state.expand(x.shape[:-1] + state.shape[-1:]), x],
                        dim=-1)
        imag, new_tail = fir_ops.fir_direct(x, self._taps, state)
        real = xin[..., (m - 1) - c:(m - 1) - c + x.shape[-1]]
        return new_tail, torch.complex(real, imag)


__all__ = [
    "FIRFilterBlock", "IIRFilterBlock", "DecimatingFIRBlock",
    "LowpassFilterBlock", "ComplexBandpassFilterBlock",
    "FMDeemphasisFilterBlock", "HilbertTransformBlock",
]
