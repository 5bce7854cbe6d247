"""The port's other host I/O against the JAX package's: the spectrum
utilities, the gnuplot sinks (through a fake ``gnuplot`` on PATH), the
PulseAudio and PortAudio sinks and sources (through fake libraries), the
native format-conversion library, the dispatcher's network, SDR and audio
inputs and outputs, and the nine RTL-SDR example modules (built, and the
mono WBFM and synchronous AM receivers run on the CPU from a fake radio
against the JAX package's examples fed the same fake)."""

import ctypes
import ctypes.util
import importlib
import importlib.util
import os
import pathlib
import sys
import wave

import numpy as np
import pytest
import scipy.signal
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu import applications as japps  # noqa: E402
from luaradio_tpu.blocks.sinks import audio as jaudio  # noqa: E402
from luaradio_tpu.utils import format as jformat  # noqa: E402
from luaradio_tpu.utils import native as jnative  # noqa: E402
from luaradio_tpu.utils import spectrum as jspec  # noqa: E402
from luaradio_tpu_torch import applications as tapps  # noqa: E402
from luaradio_tpu_torch.blocks.sinks import audio as taudio  # noqa: E402
from luaradio_tpu_torch.blocks.sources import sdr as tsdr  # noqa: E402
from luaradio_tpu_torch.utils import format as tformat  # noqa: E402
from luaradio_tpu_torch.utils import native  # noqa: E402
from luaradio_tpu_torch.utils import spectrum  # noqa: E402
from tests.test_torch_am import _af_response  # noqa: E402
from tests.test_torch_sdr import FakeRtlSdr, _norm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(77)


def _rel_close(got, exp, tol=1e-5):
    got = np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    scale = float(np.max(np.abs(exp)))
    assert float(np.max(np.abs(got - exp))) <= tol * scale


# -- spectrum -----------------------------------------------------------------

def _cx(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("n", [None, 100, 300])
def test_dft_idft_fftshift_match_jax(n):
    x = _cx(3, 256)
    _rel_close(spectrum.dft(x, n).numpy(), np.asarray(jspec.dft(x, n)))
    _rel_close(spectrum.idft(x, n).numpy(), np.asarray(jspec.idft(x, n)))
    np.testing.assert_array_equal(spectrum.fftshift(x).numpy(),
                                  np.asarray(jspec.fftshift(x)))
    np.testing.assert_array_equal(spectrum.fftfreq(64, 1e3),
                                  jspec.fftfreq(64, 1e3))


@pytest.mark.parametrize("window", ["hanning", "hamming", "rectangular"])
@pytest.mark.parametrize("log", [True, False])
@pytest.mark.parametrize("kind", ["complex", "real"])
def test_psd_matches_jax(window, log, kind):
    """PSD of a tone in noise, batched [4, 512]: within 1e-5 of the JAX
    package's (relative to its largest value; in dB, of the dB range)."""
    x = _cx(4, 512) * 0.1
    x += np.exp(2j * np.pi * 0.1 * np.arange(512)).astype(np.complex64)
    if kind == "real":
        x = x.real.copy()
    p = spectrum.PSD(512, window, 48e3, logarithmic=log)
    j = jspec.PSD(512, window, 48e3, logarithmic=log)
    got, exp = p.compute(x), np.asarray(j.compute(x))
    assert got.dtype == torch.float32 and got.shape == exp.shape
    if log:
        assert float(np.max(np.abs(got.numpy() - exp))) <= \
            1e-5 * float(np.ptp(exp))
    else:
        _rel_close(got.numpy(), exp)
    np.testing.assert_array_equal(p.window, j.window)
    assert p.scale == j.scale


def test_psd_computes_on_the_tensors_device():
    x = torch.from_numpy(_cx(2, 64))
    assert spectrum.PSD(64).compute(x).device == x.device
    assert spectrum.dft(x).device == x.device


# -- gnuplot sinks --------------------------------------------------------------

def _fake_gnuplot(tmp_path, monkeypatch):
    """A ``gnuplot`` first on PATH that appends its standard input to the
    file named by FAKE_GNUPLOT_OUT."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    gp = bindir / "gnuplot"
    gp.write_text('#!/bin/sh\ncat >> "$FAKE_GNUPLOT_OUT"\n')
    gp.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ.get('PATH', '')}")


PLOTS = {
    "plot": (lambda m: m.GnuplotPlotSink(256, "t", {"yrange": "[-2:2]"}),
             "Float32"),
    "spectrum_complex": (lambda m: m.GnuplotSpectrumSink(
        256, "s", overlap=0.5), "ComplexFloat32"),
    "spectrum_real": (lambda m: m.GnuplotSpectrumSink(128, "r",
                                                      window="hamming"),
                      "Float32"),
    "waterfall": (lambda m: m.GnuplotWaterfallSink(128, "w", height=4),
                  "ComplexFloat32"),
}


def _plot_stream(mod, name, chunks, tmp_path, monkeypatch):
    out = tmp_path / f"{name}.{mod.__name__}.gp"
    monkeypatch.setenv("FAKE_GNUPLOT_OUT", str(out))
    make, t = PLOTS[name]
    sink = make(mod)
    sink.differentiate([getattr(mod, t)])
    sink.input_rate = 48e3
    sink.device = torch.device("cpu")
    sink.initialize()
    for c in chunks:
        sink.process(c)
    sink.cleanup()
    return out.read_text()


def _same_stream(got, exp, tol):
    """Equal line by line and token by token, numbers within ``tol``
    (absolute, or relative above 1)."""
    g, e = got.splitlines(), exp.splitlines()
    assert len(g) == len(e)
    for lg, le in zip(g, e):
        tg, te = lg.split(), le.split()
        assert len(tg) == len(te), (lg, le)
        for a, b in zip(tg, te):
            if a == b:
                continue
            fa, fb = float(a), float(b)
            assert abs(fa - fb) <= tol * max(1.0, abs(fb)), (lg, le)


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_gnuplot_streams_match_jax(name, tmp_path, monkeypatch):
    """The command stream each package's sink writes to gnuplot for the
    same chunks: equal byte for byte for the time series and XY plots;
    for the spectrum and waterfall, whose values come from each package's
    FFT, equal line by line with the numbers within their printed
    precision (6 significant digits; 0.1 dB for the waterfall's %.1f)."""
    _fake_gnuplot(tmp_path, monkeypatch)
    complex_ = PLOTS[name][1] == "ComplexFloat32"
    tone = np.exp(2j * np.pi * 6e3 / 48e3 * np.arange(1300))
    data = (tone + 0.01 * _cx(1300)).astype(np.complex64)
    if not complex_:
        data = data.real.copy()
    chunks = [data[:500], data[500:1100], data[1100:]]
    got = _plot_stream(tl, name, chunks, tmp_path, monkeypatch)
    exp = _plot_stream(jl, name, chunks, tmp_path, monkeypatch)
    assert got.startswith("set grid\n")
    if name == "plot":
        assert got == exp
    else:
        _same_stream(got, exp, 0.11 if name == "waterfall" else 2e-5)


def test_gnuplot_xy_stream_matches_jax_writer(tmp_path, monkeypatch):
    """The JAX package's GnuplotXYPlotSink registers signatures of one
    and two inputs, which its block model refuses: it raises at
    construction.  The port's takes the complex input; its stream equals
    the one the JAX package's gnuplot writer (its _GnuplotSink) gives the
    same points."""
    from luaradio_tpu.blocks.sinks import plot as jplot
    with pytest.raises(ValueError, match="inconsistent input port count"):
        jl.GnuplotXYPlotSink(300, "c")
    _fake_gnuplot(tmp_path, monkeypatch)
    z = _cx(700)
    chunks = [z[:250], z[250:500], z[500:]]
    out = tmp_path / "xy.port.gp"
    monkeypatch.setenv("FAKE_GNUPLOT_OUT", str(out))
    sink = tl.GnuplotXYPlotSink(300, "c")
    sink.differentiate([tl.ComplexFloat32])
    sink.input_rate = 48e3
    sink.initialize()
    for c in chunks:
        sink.process(c)
    sink.cleanup()
    ref = tmp_path / "xy.jax.gp"
    monkeypatch.setenv("FAKE_GNUPLOT_OUT", str(ref))
    writer = jplot._GnuplotSink("c")
    writer._start(["set xlabel 'X'", "set ylabel 'Y'"])
    pts = np.zeros((0, 2), np.float32)
    for c in chunks:
        pts = np.concatenate([pts, np.stack([c.real, c.imag], axis=-1)])
        if len(pts) >= 300:
            pts = pts[-300:]
            writer._plot_series("plot '-' with points pt 7 ps 0.5 notitle",
                                pts)
    writer.cleanup()
    assert out.read_text() == ref.read_text()


def test_gnuplot_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    sink = tl.GnuplotPlotSink()
    sink.differentiate([tl.Float32])
    sink.input_rate = 1e3
    with pytest.raises(RuntimeError, match="gnuplot not found"):
        sink.initialize()


# -- audio ----------------------------------------------------------------------

class FakePulse:
    """libpulse-simple: records the calls, keeps what is written, and
    serves reads from ``feed``."""

    def __init__(self, feed=b""):
        self.calls = []
        self.written = bytearray()
        self.feed = feed

    def pa_simple_new(self, server, app, direction, dev, name, spec, *rest):
        spec = ctypes.cast(spec, ctypes.POINTER(jaudio._pa_sample_spec))
        s = spec.contents
        self.calls.append(("new", (app, direction, name,
                                   (s.format, s.rate, s.channels))))
        return 0x5A

    def pa_simple_write(self, pa, data, n, err):
        self.calls.append(("write", (_norm(pa), n)))
        self.written += bytes(data)[:n]
        return 0

    def pa_simple_read(self, pa, buf, n, err):
        self.calls.append(("read", (_norm(pa), n)))
        ctypes.memmove(buf, self.feed[:n], min(n, len(self.feed)))
        self.feed = self.feed[n:]
        return 0

    def pa_simple_drain(self, pa, err):
        self.calls.append(("drain", (_norm(pa),)))
        return 0

    def pa_simple_free(self, pa):
        self.calls.append(("free", (_norm(pa),)))


class FakePortAudio:
    def __init__(self, feed=b""):
        self.calls = []
        self.written = bytearray()
        self.feed = feed

    def __getattr__(self, name):
        if not name.startswith("Pa_"):
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, tuple(_norm(a) for a in args)))
            return 0
        return record

    def Pa_OpenDefaultStream(self, streamp, inch, outch, fmt, rate, frames,
                             cb, user):
        self.calls.append(("Pa_OpenDefaultStream",
                           (inch, outch, fmt, _norm(rate), frames)))
        ctypes.cast(streamp, ctypes.POINTER(ctypes.c_void_p))[0] = \
            ctypes.c_void_p(0x9A)
        return 0

    def Pa_WriteStream(self, stream, data, frames):
        self.calls.append(("Pa_WriteStream", (_norm(stream), frames)))
        self.written += data
        return 0

    def Pa_ReadStream(self, stream, buf, frames):
        self.calls.append(("Pa_ReadStream", (_norm(stream), frames)))
        n = ctypes.sizeof(buf)
        ctypes.memmove(buf, self.feed[:n], min(n, len(self.feed)))
        self.feed = self.feed[n:]
        return 0


def _install_audio(mod, fake, monkeypatch):
    if mod is tl:
        if isinstance(fake, FakePulse):
            monkeypatch.setattr(taudio, "_load_pulse", lambda: fake)
        else:
            monkeypatch.setattr(taudio, "_load_portaudio", lambda: fake)
    elif isinstance(fake, FakePulse):
        monkeypatch.setattr(jaudio, "_load_pulse", lambda: fake)
    else:
        monkeypatch.setattr(ctypes.util, "find_library",
                            lambda name: "fake-portaudio")
        monkeypatch.setattr(ctypes, "CDLL", lambda path: fake)


@pytest.mark.parametrize("lib", ["pulse", "portaudio"])
@pytest.mark.parametrize("nch", [1, 2])
def test_audio_sinks_match_jax(lib, nch, monkeypatch):
    """The same chunks through each package's sink: the same calls and
    the same interleaved float32 bytes."""
    chunks = [[RNG.standard_normal(k).astype(np.float32)
               for _ in range(nch)] for k in (1000, 37)]
    runs = {}
    for mod in (jl, tl):
        fake = FakePulse() if lib == "pulse" else FakePortAudio()
        with monkeypatch.context() as mp:
            _install_audio(mod, fake, mp)
            sink = (mod.PulseAudioSink if lib == "pulse"
                    else mod.PortAudioSink)(nch)
            sink.differentiate([mod.Float32] * nch)
            sink.input_rate = 44100.0
            sink.initialize()
            for c in chunks:
                sink.process(*c)
            sink.cleanup()
        runs[mod] = fake
    assert runs[tl].calls == runs[jl].calls
    assert bytes(runs[tl].written) == bytes(runs[jl].written)
    exp = np.concatenate([np.stack(c, axis=-1).reshape(-1) for c in chunks])
    assert bytes(runs[tl].written) == exp.astype(np.float32).tobytes()


@pytest.mark.parametrize("lib", ["pulse", "portaudio"])
@pytest.mark.parametrize("nch", [1, 2])
def test_audio_sources_match_jax(lib, nch, monkeypatch):
    feed = RNG.standard_normal(4096).astype(np.float32).tobytes()
    runs = {}
    for mod in (jl, tl):
        fake = FakePulse(feed) if lib == "pulse" else FakePortAudio(feed)
        with monkeypatch.context() as mp:
            _install_audio(mod, fake, mp)
            src = (mod.PulseAudioSource if lib == "pulse"
                   else mod.PortAudioSource)(nch, 8000.0)
            src.differentiate([])
            src.initialize()
            got = [src.read(300), src.read(200)]
            src.cleanup()
        runs[mod] = (fake.calls, got)
    assert runs[tl][0] == runs[jl][0]
    for a, b in zip(runs[tl][1], runs[jl][1]):
        for x, y in zip(*((v,) if nch == 1 else v for v in (a, b))):
            np.testing.assert_array_equal(x, y)


def test_missing_audio_library_raises(monkeypatch):
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    for blk, match in ((tl.PulseAudioSink(1), "libpulse-simple not found"),
                       (tl.PortAudioSink(1), "libportaudio not found")):
        blk.differentiate([tl.Float32])
        blk.input_rate = 8000.0
        with pytest.raises(RuntimeError, match=match):
            blk.initialize()


# -- native format conversion --------------------------------------------------

@pytest.mark.parametrize("name", sorted(tformat.FORMATS))
def test_native_matches_numpy_and_jax(name):
    """The port's build of native/src/format_conv.c against numpy (the
    JAX package's tests/utils/test_native.py bounds) and against the JAX
    package's library, bit for bit."""
    assert native.available()
    f = tformat.get_format(name)
    x = RNG.uniform(-0.99, 0.99, 10000).astype(np.float32)
    b = native.f32_to_raw_bytes(x, name, f.offset, f.scale)
    raw_np = tformat.float_to_raw(x, f).tobytes()
    assert sum(a != c for a, c in zip(b, raw_np)) < len(b) * 0.001
    back = native.raw_bytes_to_f32(b, name, f.offset, f.scale)
    assert np.max(np.abs(back - x)) < (1e-2 if f.itemsize == 1 else 1e-4)
    if jnative.available():
        assert b == jnative.f32_to_raw_bytes(x, name, f.offset, f.scale)
        np.testing.assert_array_equal(
            back, jnative.raw_bytes_to_f32(b, name, f.offset, f.scale))
    if f.itemsize <= 2:   # exact in float32: equal to numpy bit for bit
        np.testing.assert_array_equal(
            back, tformat.raw_to_float(np.frombuffer(b, f.dtype), f))


def test_format_module_uses_native_and_can_be_disabled(monkeypatch):
    """utils/format.py takes the native conversions when the library is
    there (the JAX package's bytes for the same samples), and numpy's
    with LUARADIO_TPU_DISABLE_NATIVE set."""
    rng = np.random.default_rng(5)
    x = (rng.uniform(-0.9, 0.9, 1000) + 1j * rng.uniform(-0.9, 0.9, 1000)
         ).astype(np.complex64)
    f, jf = tformat.get_format("s16le"), jformat.get_format("s16le")
    calls = []
    real = native.raw_bytes_to_f32
    monkeypatch.setattr(native, "raw_bytes_to_f32",
                        lambda *a: calls.append(a[1]) or real(*a))
    wire = tformat.complex_to_bytes(x, f)
    back = tformat.bytes_to_complex(wire, f)
    assert calls == ["s16le"] and np.max(np.abs(back - x)) < 1e-4
    if jnative.available():
        assert wire == jformat.complex_to_bytes(x, jf)
    np.testing.assert_array_equal(back, jformat.bytes_to_complex(wire, jf))
    monkeypatch.setenv("LUARADIO_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    wire = tformat.complex_to_bytes(x, f)
    assert wire == tformat.float_to_raw(x.view(np.float32), f).tobytes()
    np.testing.assert_array_equal(
        tformat.bytes_to_complex(wire, f),
        tformat.raw_to_float(np.frombuffer(wire, f.dtype), f).view(
            np.complex64))
    assert len(calls) == 1


# -- the dispatcher -------------------------------------------------------------

def _attrs(block):
    keys = ("frequency", "rate", "options", "transport", "address", "mode",
            "reconnect", "num_channels", "uri", "file", "bits_per_sample")
    out = {k: getattr(block, k) for k in keys if hasattr(block, k)}
    out["class"] = type(block).__name__
    fmt = getattr(block, "format", None)
    out["format"] = getattr(fmt, "name", fmt)
    if isinstance(block, (tl.UHDSource, tl.UHDSink)):
        out["device"] = block.device_args
    elif type(block).__name__ in ("UHDSource", "UHDSink"):
        out["device"] = block.device
    return out


INPUT_SPECS = [
    "networkclient:127.0.0.1:5555,rate=1e6",
    "networkclient:/tmp/x.sock,transport=unix,format=u8,rate=2e6",
    "networkserver:0.0.0.0:6000,format=s16le,rate=1102500",
    "rtlsdr", "rtlsdr:gain=20,rate=2.4e6", "airspy", "airspyhf",
    "bladerf:device_id=abc", "hackrf", "hydrasdr", "sdrplay",
    "uhd:addr=192.168.10.2", "soapysdr:driver=rtlsdr,rate=1e6",
    "pulseaudio:channels=2,rate=48000", "portaudio:rate=44100",
]


@pytest.mark.parametrize("spec", INPUT_SPECS)
def test_dispatcher_inputs_build_as_jax(spec):
    """Each input through rx_raw's dispatch (whose per-input defaults are
    dicts in both packages): the same class with the same arguments."""
    got = {}
    for mod, apps in ((jl, japps), (tl, tapps)):
        inp = apps.make_input(spec, apps.APPLICATIONS["rx_raw"])
        got[mod] = _attrs(inp.make(100e6, inp.rate))
    assert got[tl] == got[jl]


@pytest.mark.parametrize("name", ["rtlsdr", "airspy", "hackrf", "uhd"])
@pytest.mark.parametrize("app", ["rx_wbfm", "rx_am", "rx_rds"])
def test_receiver_sdr_inputs_take_their_default_rate(name, app):
    """The receivers list each input's default rate as a number
    (apps.py _SDR_RATES).  The JAX package's make_input merges it as a
    dict and raises TypeError; the port takes it as the input's rate (the
    same rate the dispatcher's INPUTS give)."""
    with pytest.raises(TypeError):
        japps.make_input(name, japps.APPLICATIONS[app])
    inp = tapps.make_input(name, tapps.APPLICATIONS[app])
    assert inp.rate == tapps.INPUTS[name][1]["_rate"] == \
        tapps.APPLICATIONS[app].supported_inputs[name]
    src = inp.make(100e6, inp.rate)
    assert type(src).__name__ == type(
        japps.make_input(name, japps.APPLICATIONS["rx_raw"]).make(
            100e6, inp.rate)).__name__
    assert src.rate == inp.rate


OUTPUT_SPECS = [("networkclient:127.0.0.1:7000", 1),
                ("networkserver:/tmp/o.sock,transport=unix,format=json", 1),
                ("networkserver:127.0.0.1:7001,format=s16le", 1),
                ("pulseaudio", 1), ("pulseaudio", 2), ("portaudio", 2)]


@pytest.mark.parametrize("spec,nch", OUTPUT_SPECS)
def test_dispatcher_outputs_build_as_jax(spec, nch):
    got = {}
    for mod, apps in ((jl, japps), (tl, tapps)):
        out = apps.make_output(spec, apps.APPLICATIONS["rx_wbfm"])
        got[mod] = _attrs(out.make(nch))
    assert got[tl] == got[jl]
    assert sorted(tapps.INPUTS) == sorted(japps.INPUTS)
    assert sorted(tapps.OUTPUTS) == sorted(japps.OUTPUTS)


# -- the RTL-SDR examples -------------------------------------------------------

EXAMPLES = ["wbfm_mono", "wbfm_stereo", "am_envelope", "am_synchronous",
            "nbfm", "ssb", "rds", "pocsag", "ax25"]


def _jax_example(name, monkeypatch):
    """The JAX package's examples/rtlsdr_<name>.py, loaded with no
    command-line arguments (it builds its graph at import)."""
    monkeypatch.setattr(sys, "argv", ["x"])
    path = ROOT / "examples" / f"rtlsdr_{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_rtlsdr_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.top


def _port_example(name):
    return importlib.import_module(
        f"luaradio_tpu_torch.examples.rtlsdr_{name}").build()


def _shape(top):
    def nm(b):
        return "top" if b is top else type(b).__name__
    src = next(b for b in top._blocks if isinstance(b, (jl.RtlSdrSource,
                                                        tl.RtlSdrSource)))
    return ([type(b).__name__ for b in top._blocks],
            [(nm(s), sp, nm(d), dp) for s, sp, d, dp in top._connections],
            (src.frequency, src.rate))


@pytest.mark.parametrize("display", [None, ":0"])
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_builds_the_jax_graph(name, display, monkeypatch, tmp_path):
    """Each module's build() gives the JAX example's blocks, connections
    and tuning, with the same choice of sink for DISPLAY set or not."""
    monkeypatch.chdir(tmp_path)
    if display:
        monkeypatch.setenv("DISPLAY", display)
    else:
        monkeypatch.delenv("DISPLAY", raising=False)
    assert _shape(_port_example(name)) == \
        _shape(_jax_example(name, monkeypatch))


def _u8(z):
    f = z.astype(np.complex64).view(np.float32)
    return np.clip(np.round(f * 127.5 + 127.5), 0, 255).astype(np.uint8)


def _tap(mod, top, cls_name):
    """A collector on the "out" of the top's first block of ``cls_name``."""
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            self.got.append(np.array(x))
    blk = next(b for b in top._blocks if type(b).__name__ == cls_name)
    sink = Collect()
    top.connect(blk, "out", sink, "in")
    return sink


def _run_example(name, mod, data, monkeypatch, taps=()):
    """The example on ``mod`` from an unpaced fake librtlsdr serving
    ``data``, into a fake libpulse-simple; returns the audio and taps."""
    pulse = FakePulse()
    top = (_port_example(name) if mod is tl
           else _jax_example(name, monkeypatch))
    sinks = {t: _tap(mod, top, t) for t in taps}
    sdr = tsdr if mod is tl else sys.modules[
        "luaradio_tpu.blocks.sources.sdr"]
    with monkeypatch.context() as mp:
        mp.setattr(taudio if mod is tl else jaudio, "_load_pulse",
                   lambda: pulse)
        mp.setattr(mod.RtlSdrSource, "_injected_lib",
                   FakeRtlSdr(sdr, data, n_reads=1 << 30))
        top.run(**({"device": "cpu"} if mod is tl else {}))
    out = {"out": np.frombuffer(bytes(pulse.written), np.float32)}
    out.update({t: np.concatenate(s.got) for t, s in sinks.items()})
    return out


def test_rtlsdr_wbfm_mono_runs_as_jax(monkeypatch):
    """0.4 s of an FM station 250 kHz above the tuning (a 3 kHz tone)
    through each package's example: the port's audio within 2e-5 * scale
    of the JAX package's (test_torch_graph.py's bound) and the tone on
    its bin."""
    rate = 1102500
    t = np.arange(int(0.4 * rate)) / rate
    ph = 2 * np.pi * np.cumsum(250e3 + 50e3 * np.cos(2 * np.pi * 3e3 * t)
                               ) / rate
    data = _u8(0.7 * np.exp(1j * ph))
    got = _run_example("wbfm_mono", tl, data, monkeypatch)["out"]
    exp = _run_example("wbfm_mono", jl, data, monkeypatch)["out"]
    assert got.shape == exp.shape == (len(t) // 25,)
    assert float(np.max(np.abs(got - exp))) < 2e-5 * max(
        1.0, float(np.max(np.abs(exp))))
    a = got[len(got) // 4:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    assert abs((np.argmax(spec[1:]) + 1) * 44100 / len(a) - 3e3) < 50


def test_rtlsdr_am_synchronous_runs_as_jax(monkeypatch):
    """0.5 s of a carrier 50 kHz above the tuning, AM 50 % by 1 kHz,
    through each package's example (DISPLAY set: PulseAudio).  The
    demodulator's audio (the AF lowpass) is held within
    tests/test_torch_am.py's derived bound: 2e-5 * scale plus the two
    runs' PLL phase gap times the IF amplitude through the DC block and
    the AF lowpass; the example's output (that audio downsampled by 10,
    then the slow AGC's gain) within 2e-5 * scale plus that bound times
    the largest AGC gain of the JAX run."""
    monkeypatch.setenv("DISPLAY", ":0")
    rate, if_rate = 1102500, 220500.0
    t = np.arange(int(0.5 * rate)) / rate
    z = 0.5 * (1 + 0.5 * np.sin(2 * np.pi * 1e3 * t)) * np.exp(
        1j * (2 * np.pi * 50e3 * t + 0.7))
    data = _u8(z)
    taps = ("PLLBlock", "ComplexBandpassFilterBlock", "LowpassFilterBlock",
            "DownsamplerBlock")
    port = _run_example("am_synchronous", tl, data, monkeypatch, taps)
    jax_ = _run_example("am_synchronous", jl, data, monkeypatch, taps)
    dphi = np.abs(np.angle(port["PLLBlock"].astype(np.complex128)
                           * np.conj(jax_["PLLBlock"])))
    mixed = np.abs(jax_["ComplexBandpassFilterBlock"]).astype(
        np.float64) * dphi
    h = np.abs(_af_response(if_rate, 5e3, len(mixed)))
    bound = scipy.signal.fftconvolve(h, mixed)[:len(mixed)]
    af_p, af_j = port["LowpassFilterBlock"], jax_["LowpassFilterBlock"]
    d = np.abs(af_p.astype(np.float64) - af_j)
    assert np.all(d <= 2e-5 * max(1.0, float(np.max(np.abs(af_j)))) + bound)
    x_j, y_j = jax_["DownsamplerBlock"], jax_["out"]
    big = np.abs(x_j) > 0.01 * np.max(np.abs(x_j))
    gain = float(np.max(np.abs(y_j[big] / x_j[big])))
    out_p = port["out"]
    assert out_p.shape == y_j.shape == (len(t) // 50,)
    d = np.abs(out_p.astype(np.float64) - y_j)
    limit = 2e-5 * max(1.0, float(np.max(np.abs(y_j)))) + gain * (
        2e-5 * max(1.0, float(np.max(np.abs(af_j)))) + bound[::10])
    assert np.all(d <= limit), float(np.max(d - limit))
    a = out_p[len(out_p) // 2:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    assert abs((np.argmax(spec[1:]) + 1) * 22050 / len(a) - 1e3) < 50


def test_example_main_runs_on_the_cpu(monkeypatch, tmp_path):
    """main() with --cpu runs the module's graph (the SSB receiver, to its
    WAV without DISPLAY) from a fake radio to the end of its stream."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    data = RNG.integers(0, 256, 2 * 1102500 // 10).astype(np.uint8)
    monkeypatch.setattr(tl.RtlSdrSource, "_injected_lib",
                        FakeRtlSdr(tsdr, data, n_reads=1 << 30))
    from luaradio_tpu_torch.examples import rtlsdr_ssb
    assert rtlsdr_ssb.main(["7.1e6", "lsb", "--cpu"]) == 0
    with wave.open(str(tmp_path / "ssb.wav")) as w:
        assert w.getnframes() == len(data) // 2 // 50
