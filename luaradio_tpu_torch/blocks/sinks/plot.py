"""Gnuplot plotting sinks (the JAX package's blocks/sinks/plot.py;
reference radio/blocks/sinks/{gnuplotplot,gnuplotxyplot,gnuplotspectrum,
gnuplotwaterfall}.lua): live time-series, XY/constellation, PSD spectrum,
and waterfall displays piped to a gnuplot subprocess.  The spectrum and
waterfall sinks compute their PSD windows as one batch on the graph's
device (utils/spectrum.py); only the plotted rows come back to the host.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, SinkBlock
from luaradio_tpu_torch.types import ComplexFloat32, Float32
from luaradio_tpu_torch.utils.spectrum import PSD, fftshift


class _GnuplotSink(SinkBlock):
    def __init__(self, title: str = "", options: dict | None = None):
        super().__init__()
        self.title = title
        self.extra_options = options or {}
        self._gp = None

    def _start(self, setup_cmds: list[str]):
        if shutil.which("gnuplot") is None:
            raise RuntimeError("gnuplot not found in PATH; plotting sinks "
                               "require gnuplot (or use a file sink)")
        self._gp = subprocess.Popen(["gnuplot", "-persist"],
                                    stdin=subprocess.PIPE)
        cmds = ["set grid", f'set title "{self.title}"']
        cmds += [f"set {k} {v}" for k, v in self.extra_options.items()]
        cmds += setup_cmds
        self._write("\n".join(cmds) + "\n")

    def _write(self, s: str):
        if self._gp and self._gp.stdin:
            try:
                self._gp.stdin.write(s.encode())
                self._gp.stdin.flush()
            except BrokenPipeError:
                self._gp = None

    def _plot_series(self, header: str, columns: np.ndarray):
        self._write(header + "\n")
        buf = "\n".join(" ".join(f"{v:g}" for v in np.atleast_1d(row))
                        for row in columns) + "\ne\n"
        self._write(buf)

    def cleanup(self):
        if self._gp:
            try:
                self._gp.stdin.close()
            except OSError:
                pass
            self._gp.wait(timeout=2)
            self._gp = None


class GnuplotPlotSink(_GnuplotSink):
    """Scrolling time-series plot of real samples
    (reference: gnuplotplot.lua)."""

    def __init__(self, num_samples: int = 1024, title: str = "",
                 options: dict | None = None):
        super().__init__(title, options)
        self.num_samples = num_samples
        self._window = np.zeros(0, dtype=np.float32)
        self.add_type_signature([Input("in", Float32)], [])

    def initialize(self):
        self._start(["set xlabel 'Sample'", "set ylabel 'Value'"])

    def process(self, x):
        self._window = np.concatenate([self._window, np.asarray(x)])
        if len(self._window) < self.num_samples:
            return
        self._window = self._window[-self.num_samples:]
        self._plot_series("plot '-' with lines notitle", self._window)


class GnuplotXYPlotSink(_GnuplotSink):
    """XY / constellation plot of a ComplexFloat32 input, the real part
    against the imaginary (reference: gnuplotxyplot.lua).

    The reference also takes two Float32 inputs ``x`` and ``y``, through a
    second type signature with another port count.  The block model here
    (the JAX package's) requires one port count for all signatures, so
    the JAX class, which registers both, raises at construction; the port
    registers the complex one."""

    def __init__(self, num_samples: int = 1024, title: str = "",
                 options: dict | None = None):
        super().__init__(title, options)
        self.num_samples = num_samples
        self._pts = np.zeros((0, 2), dtype=np.float32)
        self.add_type_signature([Input("in", ComplexFloat32)], [])

    def initialize(self):
        self._start(["set xlabel 'X'", "set ylabel 'Y'"])

    def process(self, z):
        z = np.asarray(z)
        pts = np.stack([z.real, z.imag], axis=-1).astype(np.float32)
        self._pts = np.concatenate([self._pts, pts])
        if len(self._pts) < self.num_samples:
            return
        self._pts = self._pts[-self.num_samples:]
        self._plot_series("plot '-' with points pt 7 ps 0.5 notitle",
                          self._pts)


class _SpectrumBase(_GnuplotSink):
    def __init__(self, num_samples: int = 1024, title: str = "",
                 window: str = "hanning", overlap: float = 0.0,
                 options: dict | None = None):
        super().__init__(title, options)
        self.num_samples = num_samples
        self.window_type = window
        self.overlap = overlap
        self._buf = None
        self.add_type_signature([Input("in", ComplexFloat32)], [])
        self.add_type_signature([Input("in", Float32)], [])

    def initialize(self):
        self._psd = PSD(self.num_samples, self.window_type, self.get_rate(),
                        logarithmic=True)
        self._complex = self.get_input_type() == ComplexFloat32
        dtype = np.complex64 if self._complex else np.float32
        self._buf = np.zeros(0, dtype=dtype)
        self._setup_plot()

    def _next_psd(self, x):
        """Accumulate samples; the PSD row of each full window (hop
        ``num_samples * (1 - overlap)``), DC centered for complex input,
        computed as one batch on the block's device."""
        self._buf = np.concatenate([self._buf, np.asarray(x)])
        n = self.num_samples
        hop = max(1, int(n * (1.0 - self.overlap)))
        if len(self._buf) < n:
            return []
        starts = range(0, len(self._buf) - n + 1, hop)
        windows = np.stack([self._buf[s:s + n] for s in starts])
        self._buf = self._buf[len(starts) * hop:]
        rows = self._psd.compute(torch.from_numpy(windows).to(self.device))
        if self._complex:
            rows = fftshift(rows)
        return list(rows.cpu().numpy())


class GnuplotSpectrumSink(_SpectrumBase):
    """Averaged PSD spectrum display (reference: gnuplotspectrum.lua)."""

    def _setup_plot(self):
        self._start(["set xlabel 'Frequency (Hz)'",
                     "set ylabel 'Power (dB)'"])
        rate = self.get_rate()
        n = self.num_samples
        if self._complex:
            self._freqs = (np.arange(n) - n // 2) * rate / n
        else:
            self._freqs = np.arange(n // 2 + 1) * rate / n

    def process(self, x):
        rows = self._next_psd(x)
        if not rows:
            return
        psd = np.mean(rows, axis=0)
        if not self._complex:
            psd = psd[:len(self._freqs)]
        data = np.stack([self._freqs, psd], axis=-1)
        self._plot_series("plot '-' with lines notitle", data)


class GnuplotWaterfallSink(_SpectrumBase):
    """Scrolling waterfall spectrogram (reference: gnuplotwaterfall.lua)."""

    def __init__(self, num_samples: int = 1024, title: str = "",
                 height: int = 64, **kw):
        super().__init__(num_samples, title, **kw)
        self.height = height
        self._rows: list[np.ndarray] = []

    def _setup_plot(self):
        self._start(["set xlabel 'Frequency (Hz)'", "set ylabel 'Time'",
                     "unset key", "set view map"])

    def process(self, x):
        self._rows.extend(self._next_psd(x))
        if len(self._rows) < self.height:
            return
        self._rows = self._rows[-self.height:]
        img = np.stack(self._rows)
        self._write("plot '-' matrix with image notitle\n")
        for row in img:
            self._write(" ".join(f"{v:.1f}" for v in row) + "\n")
        self._write("e\ne\n")


__all__ = ["GnuplotPlotSink", "GnuplotXYPlotSink", "GnuplotSpectrumSink",
           "GnuplotWaterfallSink"]
