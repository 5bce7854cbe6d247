"""The README receiver graph through CompositeBlock.run() in the port,
against the JAX package's graph on the same capture: optimizer on and off,
with the opt-in K2 rule (LUARADIO_TPU_FORCE_WBFM_KERNEL), at two chunk
sizes, for the f32 and the u8 wire."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.blocks.signal.modem import \
    DiscriminatorDecimatingFIRBlock  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402

RATE = 1102500
TONE = 3e3


def _capture(tmp_path, n=1 << 16):
    """An FM station 250 kHz above the tuning, modulated by a 3 kHz tone;
    written as f32 and u8 I/Q."""
    rng = np.random.default_rng(21)
    t = np.arange(n) / RATE
    ph = 2 * np.pi * np.cumsum(250e3 + 50e3 * np.cos(2 * np.pi * TONE * t)
                               ) / RATE
    z = 0.7 * np.exp(1j * ph) + 0.02 * (rng.standard_normal(n)
                                        + 1j * rng.standard_normal(n))
    z = z.astype(np.complex64)
    f32 = str(tmp_path / "x.f32.iq")
    z.view(np.float32).tofile(f32)
    u8 = str(tmp_path / "x.u8.iq")
    raw = np.clip(np.round(z.view(np.float32) * 127.5 + 127.5), 0, 255)
    raw.astype(np.uint8).tofile(u8)
    return {"f32le": f32, "u8": u8}


def _collector(mod):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", mod.Float32)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _top(mod, path, fmt):
    sink = _collector(mod)
    top = mod.CompositeBlock()
    top.connect(mod.IQFileSource(path, fmt, RATE),
                mod.TunerBlock(-250e3, 200e3, 5), mod.WBFMMonoDemodulator(),
                mod.DownsamplerBlock(5), sink)
    return top, sink


def _run(mod, path, fmt, chunk, optimize, **kw):
    top, sink = _top(mod, path, fmt)
    top.run(chunk_size=chunk, optimize=optimize, **kw)
    return np.concatenate(sink.got)


def _close(got, exp):
    assert got.shape == exp.shape
    scale = max(1.0, float(np.max(np.abs(exp))))
    assert np.max(np.abs(got - exp)) < 2e-5 * scale


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return _capture(tmp_path_factory.mktemp("graph"))


@pytest.fixture(scope="module")
def jax_audio(capture):
    return {fmt: _run(jl, capture[fmt], fmt, 1 << 14, True)
            for fmt in ("f32le", "u8")}


@pytest.mark.parametrize("fmt", ["f32le", "u8"])
@pytest.mark.parametrize("chunk", [1 << 14, 5 * 3000])
@pytest.mark.parametrize("mode", ["optimized", "unoptimized", "k2"])
def test_readme_graph_matches_jax(capture, jax_audio, monkeypatch, fmt,
                                  chunk, mode):
    if mode == "k2":
        monkeypatch.setenv("LUARADIO_TPU_FORCE_WBFM_KERNEL", "1")
    got = _run(tl, capture[fmt], fmt, chunk, mode != "unoptimized",
               device="cpu")
    _close(got, jax_audio[fmt])


def test_audio_carries_the_tone(jax_audio):
    a = jax_audio["f32le"]
    a = a[len(a) // 4:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    peak = (np.argmax(spec[1:]) + 1) * (RATE / 25) / len(a)
    assert abs(peak - TONE) < 50


def test_k2_rule_puts_the_fused_block_in(capture, monkeypatch):
    top, _ = _top(tl, capture["f32le"], "f32le")
    monkeypatch.setenv("LUARADIO_TPU_FORCE_WBFM_KERNEL", "1")
    r = Runner(top, chunk_size=1 << 14, device="cpu")
    fused = [b for b in r.graph.order
             if isinstance(b, DiscriminatorDecimatingFIRBlock)]
    assert len(fused) == 1
    assert len(fused[0].taps) == 512 and fused[0].decimation == 5
    monkeypatch.delenv("LUARADIO_TPU_FORCE_WBFM_KERNEL")
    top, _ = _top(tl, capture["f32le"], "f32le")
    r = Runner(top, chunk_size=1 << 14, device="cpu")
    assert not any(isinstance(b, DiscriminatorDecimatingFIRBlock)
                   for b in r.graph.order)


@pytest.mark.parametrize("chunk", [1 << 14, 5 * 3000])
def test_u8_wire_ingest(capture, tmp_path, chunk):
    """u8 I/Q ships its raw bytes to the device and converts there; the
    audio equals that of the f32 graph fed the host conversion
    (format.bytes_to_complex) of the same bytes."""
    from luaradio_tpu_torch.utils import format as fu
    top, sink = _top(tl, capture["u8"], "u8")
    r = Runner(top, chunk_size=chunk, device="cpu")
    assert r.feeds[0].route == "wire"
    r.run()
    out = np.concatenate(sink.got)
    with open(capture["u8"], "rb") as f:
        z = fu.bytes_to_complex(f.read(), fu.get_format("u8"))
    f32 = str(tmp_path / "u8_as.f32.iq")
    z.astype(np.complex64).view(np.float32).tofile(f32)
    top, sink = _top(tl, f32, "f32le")
    r = Runner(top, chunk_size=chunk, device="cpu")
    assert r.feeds[0].route == "host"
    r.run()
    assert np.array_equal(out, np.concatenate(sink.got))


def test_wire_ingest_matches_host_conversion(tmp_path):
    from luaradio_tpu_torch.utils import format as fu

    def conv(fmt):
        path = tmp_path / fmt.name
        path.touch()
        return tl.IQFileSource(str(path), fmt.name, 1e6).device_ingest()
    raw = np.arange(256, dtype=np.uint8).repeat(2)
    for name in ("u8", "s8"):
        fmt = fu.get_format(name)
        r = raw.view(fmt.dtype)
        got = conv(fmt)(torch.from_numpy(r)).numpy()
        exp = fu.bytes_to_complex(r.tobytes(), fmt)
        assert np.array_equal(got, exp)
    r16 = np.arange(0, 65536, 7, dtype=np.uint16)[:9000]
    fmt = fu.get_format("u16le")
    got = conv(fmt)(torch.from_numpy(r16.view(np.int16))).numpy()
    assert np.array_equal(got, fu.bytes_to_complex(r16.tobytes(), fmt))


def _route_files(tmp_path):
    """Small captures of every wire format the route table names."""
    from luaradio_tpu_torch.utils import format as fu
    x = np.random.default_rng(5).uniform(-0.9, 0.9, 2 * 3000)
    paths = {}
    for name in ("f32le", "u8", "s8", "u16le", "s16le"):
        paths[name] = str(tmp_path / f"x.{name}")
        with open(paths[name], "wb") as f:
            f.write(fu.real_to_bytes(x.astype(np.float32),
                                     fu.get_format(name)))
    return paths


def _sdr(cls):
    src = cls(104.3e6, 2.4e6)
    src.initialize = lambda: None       # no radio: only the route is read
    return src


#: each row of the route table: the source (from the captures), whether a
#: host block consumes it, and its route and copy (or the error it raises)
ROUTE_TABLE = {
    "f32_file": (lambda p: tl.IQFileSource(p["f32le"], "f32le", RATE),
                 False, ("host", True)),
    "u8_iq_file": (lambda p: tl.IQFileSource(p["u8"], "u8", RATE),
                   False, ("wire", True)),
    "s8_iq_file": (lambda p: tl.IQFileSource(p["s8"], "s8", RATE),
                   False, ("wire", True)),
    "u16_real_file": (lambda p: tl.RealFileSource(p["u16le"], "u16le", RATE),
                      False, ("wire", True)),
    "s16_real_file": (lambda p: tl.RealFileSource(p["s16le"], "s16le", RATE),
                      False, ("wire", True)),
    "repeating_file": (lambda p: tl.IQFileSource(p["u8"], "u8", RATE,
                                                 repeat_on_eof=True),
                       False, ("resident", False)),
    "repeating_file_resident_false": (
        lambda p: tl.IQFileSource(p["u8"], "u8", RATE, repeat_on_eof=True,
                                  resident=False),
        False, ("wire", True)),
    "repeating_file_to_a_host_block": (
        lambda p: tl.IQFileSource(p["u8"], "u8", RATE, repeat_on_eof=True),
        True, ("host", False)),
    "resident_true_not_eligible": (
        lambda p: tl.IQFileSource(p["u8"], "u8", RATE, resident=True),
        False, ValueError),
    "bank_of_one_wire_format": (
        lambda p: tl.BankSource([tl.IQFileSource(p["u8"], "u8", RATE)
                                 for _ in range(2)]),
        False, ("wire", True)),
    "bank_of_mixed_formats": (
        lambda p: tl.BankSource([tl.IQFileSource(p["u8"], "u8", RATE),
                                 tl.IQFileSource(p["s8"], "s8", RATE)]),
        False, ("host", True)),
    "sdr_with_a_wire_ring": (lambda p: _sdr(tl.RtlSdrSource),
                             False, ("wire", True)),
    "sdr_without_a_wire_ring": (lambda p: _sdr(tl.AirspyHFSource),
                                False, ("host", True)),
    "wire_file_to_a_host_block": (lambda p: tl.IQFileSource(p["u8"], "u8",
                                                            RATE),
                                  True, ("host", False)),
}


@pytest.mark.parametrize("mode", ["fused", "eager"])
@pytest.mark.parametrize("case", sorted(ROUTE_TABLE))
def test_route_table(tmp_path, case, mode):
    """Each host source takes its route once, when the Runner is built
    (core/ingest.py), and keeps to it: the feed's route and copy, one
    host-to-device copy a chunk on a copied route and none otherwise, and
    the thread that reads: in fused mode the read-ahead thread, or the
    pump where every source is resident (no read-ahead thread starts); in
    eager mode the pump.  ``resident=True`` where the ring cannot be had
    raises."""
    make, to_host, want = ROUTE_TABLE[case]
    src = make(_route_files(tmp_path))
    top = tl.CompositeBlock()
    if to_host:
        top.connect(src, tl.IQFileSink(str(tmp_path / "out.iq"), "f32le"))
    else:
        top.connect(src, tl.MultiplyConstantBlock(2.0), tl.NopSink())
    if want is ValueError:
        with pytest.raises(ValueError, match="resident=True"):
            Runner(top, mode=mode, chunk_size=1024, device="cpu")
        return
    r = Runner(top, mode=mode, chunk_size=1024, trace=True, device="cpu")
    (feed,) = r.feeds
    assert feed.source is src and (feed.route, feed.copied) == want
    assert (feed.ingest is not None) == (feed.route == "wire")
    if case.startswith("sdr"):
        return
    r.run(max_chunks=2)
    assert r.h2d_copies == (2 if feed.copied else 0)
    reads = {e.thread for e in r.tracer.events() if e.name == "sources.read"}
    assert reads == ({"MainThread"} if feed.route == "resident"
                     or mode == "eager" else {"read-ahead"})


def test_start_wait_with_timeout(capture):
    top, sink = _top(tl, capture["f32le"], "f32le")
    top.start(chunk_size=1 << 14, device="cpu")
    top.wait(timeout=120)
    assert sum(len(g) for g in sink.got) > 0
    assert top.status()["running"] is False


def test_block_error_surfaces_from_run(capture):
    class Boom(tl.SinkBlock):
        def __init__(self):
            super().__init__()
            self.add_type_signature([tl.Input("in", tl.Float32)], [])

        def process(self, x):
            raise RuntimeError("boom")
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(capture["f32le"], "f32le", RATE),
                tl.TunerBlock(-250e3, 200e3, 5), tl.WBFMMonoDemodulator(),
                Boom())
    with pytest.raises(RuntimeError, match="boom"):
        top.run(chunk_size=1 << 14, device="cpu")


def test_graph_defaults_to_cuda(capture):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    top, _ = _top(tl, capture["f32le"], "f32le")
    with pytest.raises(RuntimeError, match="CUDA"):
        top.run()


def test_host_block_feeding_device_runs_in_lockstep(capture):
    """A host block between the source and the device blocks forces the
    lockstep pump (host output copied to the card per chunk); the audio
    is the same as without it."""
    class HostPass(tl.HostBlock):
        def __init__(self):
            super().__init__()
            self.add_type_signature([tl.Input("in", tl.ComplexFloat32)],
                                    [tl.Output("out", tl.ComplexFloat32)])

        def process(self, x):
            assert isinstance(x, np.ndarray)
            return x.copy()

    sink = _collector(tl)
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(capture["f32le"], "f32le", RATE),
                HostPass(), tl.TunerBlock(-250e3, 200e3, 5),
                tl.WBFMMonoDemodulator(), tl.DownsamplerBlock(5), sink)
    r = Runner(top, chunk_size=1 << 14, device="cpu")
    assert not r.pipelined
    r.run()
    got = np.concatenate(sink.got)
    ref = _run(tl, capture["f32le"], "f32le", 1 << 14, True, device="cpu")
    assert np.array_equal(got, ref)
