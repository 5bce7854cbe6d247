"""Filtering blocks on the main path.

Equivalents of the reference's filter family
(radio/blocks/signal/firfilter.lua, iirfilter.lua, the windowed-sinc
designs lowpassfilter.lua, highpassfilter.lua, bandpassfilter.lua,
bandstopfilter.lua, complexbandpassfilter.lua, complexbandstopfilter.lua,
and the single-pole designs singlepolelowpassfilter.lua,
singlepolehighpassfilter.lua, fmdeemphasisfilter.lua,
fmpreemphasisfilter.lua).  FIR filters run as float32 convolutions
(ops/fir.py) or, with ``use_fft=True``, FFT overlap-save; IIR recurrences
as blocked matrix products (ops/scan.py).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.ops import fir as fir_ops
from luaradio_tpu_torch.ops import scan as scan_ops
from luaradio_tpu_torch.types import ComplexFloat32, Float32
from luaradio_tpu_torch.utils import filter_design


def _taps_tensor(taps: np.ndarray, device) -> torch.Tensor:
    dt = np.complex64 if np.iscomplexobj(taps) else np.float32
    return torch.from_numpy(np.ascontiguousarray(taps, dtype=dt)).to(device)


class FIRFilterBlock(SignalBlock):
    """Streaming FIR filter.

    Signatures mirror the reference (firfilter.lua:28-50): complex taps x
    complex input, real taps x complex input, real taps x real input.
    ``use_fft=True`` runs FFT overlap-save (ops/fir.py fir_fft, the
    reference's firfilter.lua:313-492 and the JAX package's path), whose
    frame hop L makes the block's chunk a multiple of L; ``False`` and
    ``None`` run one direct convolution a chunk.  ``None`` departs from
    the JAX package, whose default takes FFT above 16 taps: that default
    would force every undecimated FIR above 16 taps (the Hilbert
    transform, the stereo and SSB bandpasses) to chunks of a multiple of
    1024 or more and move the receivers' chunk plans."""

    def __init__(self, taps, use_fft: bool | None = None):
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
        self.use_fft = use_fft

    def chunk_multiple(self) -> int:
        return (fir_ops.fft_frame_length(len(self.taps)) if self.use_fft
                else 1)

    def initialize(self):
        if self.use_fft:
            self._l = fir_ops.fft_frame_length(len(self.taps))
            self._real_fft = (self.get_input_type() == Float32
                              and not np.iscomplexobj(self.taps))
            self._h_freq = torch.from_numpy(fir_ops.fir_fft_freq_taps(
                self.taps, self._l, self._real_fft)).to(self.device)
        else:
            self._taps = _taps_tensor(self.taps, self.device)

    def init_state(self):
        dtype = (torch.complex64 if self.get_input_type() == ComplexFloat32
                 else torch.float32)
        if self.use_fft:
            return fir_ops.fir_fft_init_state(self._l, dtype, self.device)
        return fir_ops.fir_init_state(len(self.taps), dtype, self.device)

    def process(self, state, x):
        if self.use_fft:
            y, state = fir_ops.fir_fft(x, self._h_freq, state,
                                       self._real_fft)
        else:
            y, state = fir_ops.fir_direct(x, self._taps, state)
        return state, y

    def fir_equivalent(self):
        """Graph-optimizer protocol: this block's exact FIR taps (designed
        with the propagated rate when needed).  See core/optimize.py."""
        if isinstance(self, _DesignedFIRBlock):
            return np.asarray(self.design_taps())
        return np.asarray(self.taps)


class IIRFilterBlock(SignalBlock):
    """IIR filter y = (b/a) * x of any order (reference: iirfilter.lua) in
    the transposed direct form II state space s[n] = A s[n-1] + g x[n],
    y[n] = b0 x[n] + s[n-1][0] (ops/scan.py iir_state_space), with the
    state [..., p] carried across chunks.  Order 1 — the single-pole
    designs of the receivers (deemphasis, single-pole lowpass) — solves
    its scalar recurrence with linrec_first_order; order 2 and above run
    ops/scan.py iir_apply, the blocked order-p scan."""

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
        self._A, self._g, b0 = scan_ops.iir_state_space(self.b_taps,
                                                        self.a_taps)
        self._order = self._A.shape[0]
        self._b0 = float(b0)
        if self._order == 1:
            self._g1 = float(self._g[0])
            self._pole = float(self._A[0, 0])

    def init_state(self):
        dtype = (torch.complex64 if self.get_input_type() == ComplexFloat32
                 else torch.float32)
        return torch.zeros((self._order,), dtype=dtype, device=self.device)

    def process(self, state, x):
        if self._order == 0:
            return state, x * self._b0
        if self._order > 1:
            y, state = scan_ops.iir_apply(x, self._A, self._g, self._b0,
                                          state)
            return state, y
        s_in = state[..., 0]
        s = scan_ops.linrec_first_order(x * self._g1, self._pole, s_in)
        s_prev = torch.cat([s_in.expand(x.shape[:-1])[..., None],
                            s[..., :-1]], dim=-1)
        y = x * self._b0 + s_prev
        return s[..., -1:], y

    def process_sharded(self, state, x, *, axis):
        # the state recurrence over the shards: order 1 as a distributed
        # first-order prefix, order p through one gather of the shards'
        # p-vector summaries (ops/scan.py iir_apply_sharded)
        if self._order == 0:
            return state, x * self._b0
        if self._order > 1:
            y, state = scan_ops.iir_apply_sharded(x, self._A, self._g,
                                                  self._b0, state, axis)
            return state, y
        from luaradio_tpu_torch.parallel.time import (
            linrec_first_order_sharded)
        s_in = state[..., 0]
        s, s_final = linrec_first_order_sharded(
            x * self._g1, self._pole, s_in, axis, with_final=True)
        halo = axis.left_halo(s, 1, first=s_in[..., None])
        y = x * self._b0 + torch.cat([halo, s[..., :-1]], dim=-1)
        return s_final[..., None], y

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

    def __init__(self, num_taps: int, complex_taps: bool = False,
                 use_fft: bool | None = None):
        super().__init__(np.zeros(num_taps, dtype=np.complex64 if complex_taps
                                  else np.float32), use_fft=use_fft)
        self.num_taps = num_taps

    def design_taps(self) -> np.ndarray:
        raise NotImplementedError

    def initialize(self):
        dt = np.complex64 if np.iscomplexobj(self.taps) else np.float32
        self.taps = np.asarray(self.design_taps()).astype(dt)
        super().initialize()


class LowpassFilterBlock(_DesignedFIRBlock):
    def __init__(self, num_taps: int, cutoff: float,
                 nyquist: float | None = None, window: str = "hamming",
                 use_fft: bool | None = None):
        super().__init__(num_taps, use_fft=use_fft)
        self.cutoff = cutoff
        self.nyquist = nyquist
        self.window = window

    def design_taps(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        return filter_design.firwin_lowpass(self.num_taps, self.cutoff / nyq,
                                            self.window)


class HighpassFilterBlock(_DesignedFIRBlock):
    def __init__(self, num_taps: int, cutoff: float,
                 nyquist: float | None = None, window: str = "hamming",
                 use_fft: bool | None = None):
        super().__init__(num_taps, use_fft=use_fft)
        self.cutoff = cutoff
        self.nyquist = nyquist
        self.window = window

    def design_taps(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        return filter_design.firwin_highpass(self.num_taps,
                                             self.cutoff / nyq, self.window)


class _BandFIRBlock(_DesignedFIRBlock):
    """A two-edge windowed-sinc design; cutoffs in Hz."""

    _design = None
    _complex = False

    def __init__(self, num_taps: int, cutoffs, nyquist: float | None = None,
                 window: str = "hamming", use_fft: bool | None = None):
        super().__init__(num_taps, complex_taps=self._complex,
                         use_fft=use_fft)
        self.cutoffs = tuple(cutoffs)
        self.nyquist = nyquist
        self.window = window

    def design_taps(self):
        nyq = self.nyquist or (self.get_rate() / 2.0)
        return self._design(
            self.num_taps, (self.cutoffs[0] / nyq, self.cutoffs[1] / nyq),
            self.window)


class BandpassFilterBlock(_BandFIRBlock):
    _design = staticmethod(filter_design.firwin_bandpass)


class BandstopFilterBlock(_BandFIRBlock):
    _design = staticmethod(filter_design.firwin_bandstop)


class ComplexBandstopFilterBlock(_BandFIRBlock):
    """Complex (single-sided) bandstop; cutoffs in Hz, negative allowed
    (reference: complexbandstopfilter.lua)."""

    _design = staticmethod(filter_design.firwin_complex_bandstop)
    _complex = True


class ComplexBandpassFilterBlock(_BandFIRBlock):
    """Complex (single-sided) bandpass; cutoffs in Hz, negative allowed
    (reference: complexbandpassfilter.lua)."""

    _design = staticmethod(filter_design.firwin_complex_bandpass)
    _complex = True


class RootRaisedCosineFilterBlock(_DesignedFIRBlock):
    """Root-raised-cosine matched filter (reference:
    rootraisedcosinefilter.lua)."""

    def __init__(self, num_taps: int, beta: float, symbol_rate: float,
                 use_fft: bool | None = None):
        super().__init__(num_taps, use_fft=use_fft)
        self.beta = beta
        self.symbol_rate = symbol_rate

    def design_taps(self):
        return filter_design.fir_root_raised_cosine(
            self.num_taps, self.get_rate(), self.beta, 1.0 / self.symbol_rate)


def _symbol_period(block) -> int:
    return max(1, int(block.get_rate() / block.baudrate))


class PulseMatchedFilterBlock(_DesignedFIRBlock):
    """Matched filter for a rectangular one-symbol pulse: symbol_period taps
    of +1 (-1 when inverted), exactly the reference's tap vector
    (pulsematchedfilter.lua)."""

    def __init__(self, baudrate: float, invert: bool = False):
        super().__init__(1)
        self.baudrate = baudrate
        self.invert = invert

    def design_taps(self):
        return np.full(_symbol_period(self), -1.0 if self.invert else 1.0)


class ManchesterMatchedFilterBlock(_DesignedFIRBlock):
    """Matched filter for a Manchester transition: symbol_period taps of -1
    followed by symbol_period taps of +1 (swapped when inverted), exactly
    the reference's tap vector (manchestermatchedfilter.lua:11-23)."""

    def __init__(self, baudrate: float, invert: bool = False):
        super().__init__(2)
        self.baudrate = baudrate
        self.invert = invert

    def design_taps(self):
        sp = _symbol_period(self)
        first = 1.0 if self.invert else -1.0
        return np.concatenate([np.full(sp, first), np.full(sp, -first)])


def _singlepole_lowpass_coeffs(cutoff: float, rate: float):
    """Bilinear-transform 1-pole lowpass H(s) = 1/(1 + s/wc) with
    prewarping (reference: singlepolelowpassfilter.lua)."""
    k = np.tan(np.pi * cutoff / rate)
    b = np.array([k / (1 + k), k / (1 + k)])
    a = np.array([1.0, (k - 1) / (1 + k)])
    return b, a


class SinglepoleLowpassFilterBlock(IIRFilterBlock):
    def __init__(self, cutoff: float):
        super().__init__([1.0], [1.0])
        self.cutoff = cutoff

    def _design_ba(self):
        return _singlepole_lowpass_coeffs(self.cutoff, self.get_rate())


class SinglepoleHighpassFilterBlock(IIRFilterBlock):
    """1-pole highpass H(s) = (s/wc)/(1 + s/wc) via bilinear transform
    (reference: singlepolehighpassfilter.lua)."""

    def __init__(self, cutoff: float):
        super().__init__([1.0], [1.0])
        self.cutoff = cutoff

    def _design_ba(self):
        k = np.tan(np.pi * self.cutoff / self.get_rate())
        return (np.array([1 / (1 + k), -1 / (1 + k)]),
                np.array([1.0, (k - 1) / (1 + k)]))


class FMDeemphasisFilterBlock(IIRFilterBlock):
    """FM deemphasis: 1-pole lowpass at 1/(2*pi*tau)
    (reference: fmdeemphasisfilter.lua:25-28)."""

    def __init__(self, tau: float):
        super().__init__([1.0], [1.0])
        self.tau = tau

    def _design_ba(self):
        cutoff = 1.0 / (2 * np.pi * self.tau)
        return _singlepole_lowpass_coeffs(cutoff, self.get_rate())


class FMPreemphasisFilterBlock(SinglepoleHighpassFilterBlock):
    """FM preemphasis: the single-pole highpass at 1/(2*pi*tau), as the
    reference delegates it (fmpreemphasisfilter.lua:24-27)."""

    def __init__(self, tau: float):
        super().__init__(1.0 / (2 * np.pi * tau))
        self.tau = tau


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
    "LowpassFilterBlock", "HighpassFilterBlock", "BandpassFilterBlock",
    "BandstopFilterBlock", "ComplexBandpassFilterBlock",
    "ComplexBandstopFilterBlock", "SinglepoleLowpassFilterBlock",
    "SinglepoleHighpassFilterBlock", "FMDeemphasisFilterBlock",
    "FMPreemphasisFilterBlock", "HilbertTransformBlock",
    "RootRaisedCosineFilterBlock", "PulseMatchedFilterBlock",
    "ManchesterMatchedFilterBlock",
]

# The FIR family carries pure input tails (fir_init_state,
# fir_fft_init_state): the generic halo exchange of
# SignalBlock.process_sharded is exact for them.
for _cls in (FIRFilterBlock, DecimatingFIRBlock, HilbertTransformBlock):
    _cls.tail_state = True
del _cls
