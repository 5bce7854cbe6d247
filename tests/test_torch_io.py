"""Sources and sinks of the port's main path against the JAX package:
SignalSource, IQFileSource/IQFileSink round trips in several wire formats,
WAVFileSink, and the Nop/Benchmark sinks that never fetch device data."""

import io
import json
import wave

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402


@pytest.mark.parametrize("signal", ["exponential", "cosine", "sine",
                                    "square", "triangle", "sawtooth",
                                    "constant"])
def test_signal_source_matches_jax(signal):
    outs = {}
    for name, mod in (("jax", jl), ("port", tl)):
        src = mod.SignalSource(signal, 1234.5, 48e3, amplitude=0.7,
                               offset=0.1, phase=0.3)
        if name == "port":
            src.device = torch.device("cpu")
        src.differentiate([])
        src.initialize()
        st, ys = src.init_state(), []
        for _ in range(3):
            st, y = src.generate(st, 5000)
            ys.append(np.asarray(y))
        outs[name] = np.concatenate(ys)
    a, b = outs["port"], outs["jax"]
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.max(np.abs(a - b)) < 1e-5


@pytest.mark.parametrize("fmt", ["f32le", "u8", "s16be", "u16le"])
def test_iq_file_round_trip_matches_jax(tmp_path, fmt):
    """SignalSource -> IQFileSink writes the same bytes in both packages,
    and IQFileSource reads them back to the same samples."""
    written = {}
    for name, mod in (("jax", jl), ("port", tl)):
        path = str(tmp_path / f"{name}.iq")
        top = mod.CompositeBlock()
        top.connect(mod.SignalSource("exponential", 1e3, 48e3,
                                     amplitude=0.9),
                    mod.IQFileSink(path, fmt))
        kw = {"device": "cpu"} if name == "port" else {}
        top.run(max_chunks=2, chunk_size=4096, **kw)
        written[name] = open(path, "rb").read()
    from luaradio_tpu_torch.utils import format as fu
    f = fu.get_format(fmt)
    a, b = (fu.bytes_to_complex(written[k], f) for k in ("port", "jax"))
    assert a.shape == b.shape == (2 * 4096,)
    # one wire step: the two packages' float32 rounding may straddle it
    tol = 1e-6 if fmt == "f32le" else 1.001 / f.scale
    assert np.max(np.abs(a - b)) <= tol

    got = []
    for name, mod in (("jax", jl), ("port", tl)):
        class Collect(mod.SinkBlock):
            def __init__(self):
                super().__init__()
                self.add_type_signature(
                    [mod.Input("in", mod.ComplexFloat32)], [])

            def process(self, x):
                got.append((name, np.array(x)))
        top = mod.CompositeBlock()
        top.connect(mod.IQFileSource(str(tmp_path / "jax.iq"), fmt, 48e3),
                    mod.DownsamplerBlock(1), Collect())
        kw = {"device": "cpu"} if name == "port" else {}
        top.run(chunk_size=3000, **kw)
    pa = np.concatenate([x for n, x in got if n == "port"])
    ja = np.concatenate([x for n, x in got if n == "jax"])
    host = fu.bytes_to_complex(written["jax"], f)
    # the port converts the wire exactly as the host path does; the JAX
    # package's on-device conversion of the integer formats may land one
    # float32 ulp away from it
    assert np.array_equal(pa, host)
    assert np.max(np.abs(pa - ja)) <= 1.2e-7


def test_wav_sink_matches_jax(tmp_path):
    frames = {}
    for name, mod in (("jax", jl), ("port", tl)):
        path = str(tmp_path / f"{name}.wav")
        top = mod.CompositeBlock()
        top.connect(mod.SignalSource("cosine", 440, 44100, amplitude=0.5),
                    mod.WAVFileSink(path, 1))
        kw = {"device": "cpu"} if name == "port" else {}
        top.run(max_chunks=3, chunk_size=4410, **kw)
        with wave.open(path) as w:
            assert w.getframerate() == 44100 and w.getnchannels() == 1
            frames[name] = np.frombuffer(w.readframes(w.getnframes()),
                                         np.int16)
    assert frames["port"].shape == frames["jax"].shape == (3 * 4410,)
    assert np.max(np.abs(frames["port"].astype(int) - frames["jax"])) <= 1


def test_benchmark_and_nop_sinks_count_without_fetching():
    out = io.StringIO()
    bench = tl.BenchmarkSink(file=out, use_json=True)
    top = tl.CompositeBlock()
    src = tl.SignalSource("exponential", 1e3, 1e6)
    top.connect(src, tl.FrequencyTranslatorBlock(1e3), bench)
    top.connect(src, "out", tl.NopSink(), "in")
    top.run(max_chunks=4, chunk_size=1 << 12, device="cpu")
    rec = json.loads(out.getvalue())
    assert bench.total_count == 4 << 12
    assert rec["samples_per_second"] > 0
    assert rec["bytes_per_second"] == rec["samples_per_second"] * 8
