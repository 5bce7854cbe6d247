"""The port's file sources and sinks against the JAX package: RealFileSource
and RealFileSink in several wire formats (host and on-card conversion, the
resident ring), RawFileSource and RawFileSink, WAVFileSource (u8, s16,
s32, f32, f64; 1 and 2 channels; repeat_on_eof), JSONSource, the
``realfile`` output through both CLIs, and the two example modules at a
small size (tests/blocks/test_sources_sinks.py:41-110 are the JAX
package's round trips)."""

import json
import struct
import wave

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.cli import main as jax_main  # noqa: E402
from luaradio_tpu_torch.cli import main as port_main  # noqa: E402
from luaradio_tpu_torch.core.ingest import Feed  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.utils import format as fu  # noqa: E402

RNG = np.random.default_rng(2024)


def _kw(mod):
    return {"device": "cpu"} if mod is tl else {}


def _collector(mod, t=None):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature(
                [mod.Input("in", t or (lambda _: True))], [])

        def process(self, x):
            self.got.append(list(x) if isinstance(x, list) else np.array(x))
    return Collect()


def _array_source(mod, data, t, rate=1e6):
    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate = rate
            self.pos = 0
            self.add_type_signature([], [mod.Output("out", t)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            c = data[self.pos:self.pos + n]
            self.pos += len(c)
            return c
    return ArraySource()


# -- RealFileSink / RealFileSource ----------------------------------------------

@pytest.mark.parametrize("fmt", ["u8", "s16le", "u16be", "s32be", "f32be",
                                 "f64le"])
def test_realfile_round_trip_matches_jax(fmt, tmp_path):
    """The two packages' RealFileSinks write the same samples (within one
    wire step of an integer format: the JAX package's native conversion
    and numpy may round a value between two steps either way, as
    test_torch_io.py's IQ round trip allows); both RealFileSources read
    the JAX file back to the same samples at chunk boundaries
    (test_sources_sinks.py:41-55): the port exactly as the host
    conversion, the JAX package within 1.2e-7 of it."""
    x = RNG.uniform(-0.99, 0.99, 4000).astype(np.float32)
    written = {}
    for mod in (jl, tl):
        path = str(tmp_path / f"{mod.__name__}.{fmt}")
        top = mod.CompositeBlock()
        top.connect(_array_source(mod, x, mod.Float32),
                    mod.RealFileSink(path, fmt))
        top.run(chunk_size=1000, **_kw(mod))
        written[mod] = open(path, "rb").read()
    f = fu.get_format(fmt)
    a, b = (fu.bytes_to_real(written[m], f) for m in (tl, jl))
    tol = 0.0 if fmt[0] == "f" else 1.001 / f.scale
    assert a.shape == b.shape == x.shape
    assert np.max(np.abs(a - b)) <= tol
    got = {}
    for mod in (jl, tl):
        sink = _collector(mod, mod.Float32)
        top = mod.CompositeBlock()
        top.connect(mod.RealFileSource(str(tmp_path / f"luaradio_tpu.{fmt}"),
                                       fmt, 1e6), sink)
        top.run(chunk_size=1500, **_kw(mod))
        got[mod] = np.concatenate(sink.got)
    host = fu.bytes_to_real(written[jl], f)
    assert np.array_equal(got[tl], host)
    assert np.max(np.abs(got[tl] - got[jl])) <= 1.2e-7
    eps = 1e-2 if fmt == "u8" else 1e-4
    assert np.max(np.abs(got[tl] - x)) < eps


@pytest.mark.parametrize("fmt", ["u8", "s16le", "f32le"])
@pytest.mark.parametrize("resident", [False, None])
def test_realfile_source_feeds_device_blocks(fmt, resident, tmp_path):
    """A RealFileSource feeding a device block: the 8- and 16-bit wire
    converts on the device (the wire ingest), a repeating file is read
    from its device-resident ring with no host-to-device copy; each
    equals the host conversion through the same FIR, and the JAX graph
    within 2e-5 * scale."""
    x = RNG.uniform(-0.99, 0.99, 3000).astype(np.float32)
    path = str(tmp_path / f"r.{fmt}")
    with open(path, "wb") as f:
        f.write(fu.real_to_bytes(x, fu.get_format(fmt)))
    taps = RNG.standard_normal(17).astype(np.float32)
    outs = {}
    for mod in (jl, tl):
        sink = _collector(mod)
        top = mod.CompositeBlock()
        top.connect(mod.RealFileSource(path, fmt, 1e6, repeat_on_eof=True,
                                       resident=resident),
                    mod.FIRFilterBlock(taps, use_fft=False), sink)
        if mod is tl:
            r = Runner(top, chunk_size=1024, device="cpu")
            r.run(max_chunks=5)
            src = r.sources[0]
            (feed,) = r.feeds
            assert feed.source is src and feed.route == (
                "resident" if resident is None
                else "host" if fmt == "f32le" else "wire")
            assert (r.h2d_copies == 0) == (resident is None)
        else:
            top.run(max_chunks=5, chunk_size=1024)
        outs[mod] = np.concatenate(sink.got)
    host = fu.bytes_to_real(open(path, "rb").read(), fu.get_format(fmt))
    ring = np.resize(host, 5 * 1024)
    from scipy.signal import lfilter
    exp = lfilter(taps.astype(np.float64), [1.0], ring.astype(np.float64))
    assert outs[tl].shape == (5 * 1024,)
    assert np.max(np.abs(outs[tl] - exp)) < 1e-4 * np.abs(exp).max()
    assert np.max(np.abs(outs[tl] - outs[jl])) < 2e-5 * max(
        1.0, np.abs(outs[jl]).max())


# -- RawFileSink / RawFileSource --------------------------------------------------

def test_wire_feed_chunks_read_ahead_keep_their_contents(tmp_path):
    """A u8 IQFileSource's wire feed as a CPU Runner plans it (not
    pinned): four chunks read before any is consumed keep their own
    items, each equal after conversion to the host route's samples bit
    for bit.  The file ends mid-sample; the short last chunk's tail, the
    stray I item included, is zero and its nvalid the whole samples.  A
    run stages nothing pinned and gives the host conversion times 2."""
    raw = RNG.integers(0, 256, 2 * (3 * 1024 + 300) + 1).astype(np.uint8)
    path = str(tmp_path / "x.u8")
    raw.tofile(path)

    def graph():
        top, sink = tl.CompositeBlock(), _collector(tl)
        src = tl.IQFileSource(path, "u8", 1e6)
        top.connect(src, tl.MultiplyConstantBlock(2.0), sink)
        return top, src, sink

    top, src, _ = graph()
    (feed,) = Runner(top, chunk_size=1024, device="cpu").feeds
    assert feed.route == "wire" and not feed.pinned and feed.want == 1024
    host = tl.IQFileSource(path, "u8", 1e6)
    for s in (src, host):
        s.differentiate([])
        s.initialize()
    pinned = Feed.pinned_chunks
    chunks = []
    for _ in range(4):
        values, nvalid = {}, {}
        short = feed.read(values, nvalid)
        chunks.append((values[feed.keys[0]], nvalid[feed.keys[0]], short))
    assert feed.read({}, {}) is None
    assert [(nv, short) for _, nv, short in chunks] == [
        (1024, False)] * 3 + [(300, True)]
    exp = []
    for w, nv, _ in chunks:
        assert w.shape == (2 * 1024,) and not w[2 * nv:].any()
        exp.append(host.read(1024))
        assert np.array_equal(feed.ingest(torch.from_numpy(w[:2 * nv]))
                              .numpy().view(np.uint8),
                              exp[-1].view(np.uint8))
    top, _, sink = graph()
    Runner(top, chunk_size=1024, device="cpu").run()
    assert Feed.pinned_chunks == pinned
    np.testing.assert_array_equal(np.concatenate(sink.got),
                                  2 * np.concatenate(exp))


@pytest.mark.parametrize("kind", ["complex", "real", "bit"])
def test_rawfile_round_trip_matches_jax(kind, tmp_path):
    """The native stream: written as its bytes in both packages, read back
    exactly (test_sources_sinks.py:58-72)."""
    if kind == "complex":
        x = (RNG.standard_normal(3000) + 1j * RNG.standard_normal(3000)
             ).astype(np.complex64)
    elif kind == "real":
        x = RNG.standard_normal(3000).astype(np.float32)
    else:
        x = RNG.integers(0, 2, 3000).astype(np.uint8)

    def typ(mod):
        return {"complex": mod.ComplexFloat32, "real": mod.Float32,
                "bit": mod.Bit}[kind]
    written = {}
    for mod in (jl, tl):
        path = str(tmp_path / f"{mod.__name__}.raw")
        top = mod.CompositeBlock()
        top.connect(_array_source(mod, x, typ(mod)), mod.RawFileSink(path))
        top.run(chunk_size=512, **_kw(mod))
        written[mod] = open(path, "rb").read()
    assert written[tl] == written[jl] == x.tobytes()
    got = {}
    for mod in (jl, tl):
        sink = _collector(mod)
        top = mod.CompositeBlock()
        top.connect(mod.RawFileSource(str(tmp_path / "luaradio_tpu.raw"),
                                      typ(mod), 1e6), sink)
        top.run(chunk_size=512, **_kw(mod))
        got[mod] = np.concatenate(sink.got)
    assert got[tl].dtype == x.dtype
    assert np.array_equal(got[tl], x) and np.array_equal(got[jl], x)


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_rawfile_resident_ring_feeds_device_blocks(kind, tmp_path):
    """A repeating RawFileSource into a device block reads its ring on the
    device: no host-to-device copy, the file's samples in order."""
    x = RNG.standard_normal(1000).astype(np.float32)
    t = tl.Float32
    if kind == "complex":
        x = (x + 1j * RNG.standard_normal(1000)).astype(np.complex64)
        t = tl.ComplexFloat32
    path = str(tmp_path / "r.raw")
    x.tofile(path)
    sink = _collector(tl)
    top = tl.CompositeBlock()
    top.connect(tl.RawFileSource(path, t, 1e6, repeat_on_eof=True),
                tl.NopBlock(), sink)
    r = Runner(top, chunk_size=768, device="cpu")
    r.run(max_chunks=4)
    assert r.h2d_copies == 0 and r.feeds[0].route == "resident"
    assert np.array_equal(np.concatenate(sink.got), np.resize(x, 4 * 768))


# -- WAVFileSource ------------------------------------------------------------

def _write_wav(path, chans, rate, tag, bits):
    """A RIFF/WAVE file with an extra chunk before the data."""
    data = np.stack(chans, axis=-1)
    if tag == 3:
        raw = data.astype("<f4" if bits == 32 else "<f8")
    elif bits == 8:
        raw = np.clip(np.round(data * 127.5 + 127.5), 0, 255).astype("u1")
    else:
        scale = 2 ** (bits - 1) - 0.5
        raw = np.round(data * scale).astype("<i2" if bits == 16 else "<i4")
    body = raw.tobytes()
    nch = len(chans)
    fmt = struct.pack("<HHIIHH", tag, nch, rate, rate * nch * bits // 8,
                      nch * bits // 8, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + 3 + 1
                                      + 8 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"LIST" + struct.pack("<I", 3) + b"abc\x00")
        f.write(b"data" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("tag,bits", [(1, 8), (1, 16), (1, 32), (3, 32),
                                      (3, 64)])
def test_wav_source_matches_jax(tag, bits, nch, tmp_path):
    """Every sample format, mono and stereo: the port's WAVFileSource reads
    the JAX package's samples exactly, in a graph at a chunk that does not
    divide the file."""
    n = 5000
    chans = [np.clip(RNG.standard_normal(n) * 0.4, -0.99, 0.99) for _ in
             range(nch)]
    path = str(tmp_path / "in.wav")
    _write_wav(path, chans, 8000, tag, bits)
    got = {}
    for mod in (jl, tl):
        src = mod.WAVFileSource(path, nch)
        sinks = [_collector(mod, mod.Float32) for _ in range(nch)]
        top = mod.CompositeBlock()
        for i, s in enumerate(sinks):
            top.connect(src, "out" if nch == 1 else f"out{i + 1}", s, "in")
        top.run(chunk_size=1500, **_kw(mod))
        assert src.get_rate() == 8000.0
        got[mod] = [np.concatenate(s.got) for s in sinks]
    eps = {8: 1e-2, 16: 1e-4, 32: 1e-6, 64: 1e-7}[bits]
    for p, j, c in zip(got[tl], got[jl], chans):
        assert p.dtype == np.float32 and len(p) == n
        assert np.array_equal(p, j)
        assert np.max(np.abs(p - c)) < eps


def test_wav_sink_to_source_round_trip_and_repeat(tmp_path):
    """WAVFileSink -> WAVFileSource in the port (test_sources_sinks.py:
    75-104), and repeat_on_eof reading the data chunk again."""
    x = np.clip(RNG.standard_normal(3000) * 0.3, -1, 1).astype(np.float32)
    path = str(tmp_path / "t.wav")
    top = tl.CompositeBlock()
    top.connect(_array_source(tl, x, tl.Float32, rate=8000.0),
                tl.WAVFileSink(path, 1, bits_per_sample=16))
    top.run(chunk_size=1000, device="cpu")
    src = tl.WAVFileSource(path, 1, repeat_on_eof=True)
    src.initialize()
    assert src.get_rate() == 8000.0
    first = src.read(3000)
    again = src.read(1000)
    assert np.max(np.abs(first - x)) < 1e-4
    assert np.array_equal(again, first[:1000])
    src.cleanup()


def test_wav_source_rejects_a_channel_mismatch(tmp_path):
    path = str(tmp_path / "s.wav")
    _write_wav(path, [np.zeros(10), np.zeros(10)], 8000, 1, 16)
    with pytest.raises(ValueError, match="channels"):
        tl.WAVFileSource(path, 1).initialize()


# -- JSONSource ---------------------------------------------------------------

def test_json_source_round_trip_matches_jax(tmp_path):
    """JSONSource -> JSONSink: the objects come back as written, in both
    packages (test_sources_sinks.py:107-110)."""
    objs = [{"i": i, "s": "x" * (i % 3), "v": [i, i / 2]} for i in range(25)]
    path = tmp_path / "in.json"
    path.write_text("\n".join(json.dumps(o) for o in objs) + "\n\n")
    outs = {}
    for mod in (jl, tl):
        out = str(tmp_path / f"{mod.__name__}.json")
        top = mod.CompositeBlock()
        src = mod.JSONSource(str(path), 1000.0)
        top.connect(src, mod.JSONSink(out))
        top.run(chunk_size=7, **_kw(mod))
        outs[mod] = [json.loads(line) for line in open(out)]
        assert src.get_output_type().name == "JSONObject"
    assert outs[tl] == outs[jl] == objs


# -- the realfile output ----------------------------------------------------------

def test_realfile_output_through_both_clis(tmp_path):
    """rx_ssb with ``-o realfile:...``: the port's float32 audio equals the
    JAX package's within 2e-5 * scale and its own wavfile output within
    one 16-bit step."""
    rate = 1102500
    n = int(0.2 * rate)
    t = np.arange(n) / rate
    z = 0.5 * np.exp(2j * np.pi * 1.2e3 * t) + 0.03 * (
        RNG.standard_normal(n) + 1j * RNG.standard_normal(n))
    cap = str(tmp_path / "usb.iq")
    z.astype(np.complex64).view(np.float32).tofile(cap)
    spec = ["-a", "rx_ssb", "-i", f"iqfile:{cap},rate={rate}"]
    outs = {}
    for name, main, kw in (("jax", jax_main, {}),
                           ("port", port_main, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.f32")
        assert main(spec + ["-o", f"realfile:{out}", "0", "usb"], **kw) == 0
        outs[name] = np.fromfile(out, np.float32)
    wav = str(tmp_path / "port.wav")
    assert port_main(spec + ["-o", f"wavfile:{wav}", "0", "usb"],
                     device="cpu") == 0
    with wave.open(wav) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    got, exp = outs["port"], outs["jax"]
    assert got.shape == exp.shape == pcm.shape and len(got) > 8000
    assert np.max(np.abs(got - exp)) < 2e-5 * max(1.0, np.abs(exp).max())
    assert np.max(np.abs(np.round(got.astype(np.float64) * 32767.5)
                         - pcm)) <= 1
    s16 = str(tmp_path / "port.s16")
    assert port_main(spec + ["-o", f"realfile:{s16},s16le", "0", "usb"],
                     device="cpu") == 0
    assert np.max(np.abs(np.fromfile(s16, "<i2") / 32767.5 - got)) < 1e-4


# -- the example modules --------------------------------------------------------

def test_fm_roundtrip_selftest_at_small_size(tmp_path):
    """The port's FM self test on the CPU over two 2^16-sample chunks: the
    tone within 50 Hz at the corrected peak bin, and the audio within
    2e-5 * scale of the JAX example's two stages run the same way."""
    from luaradio_tpu_torch.examples import fm_roundtrip_selftest as ex
    peak, audio, sr = ex.run(str(tmp_path), chunks=2, chunk_size=1 << 16,
                             device="cpu")
    assert sr == 32000 and len(audio) == 2 * (1 << 16) // 8
    assert abs(peak - ex.TONE_HZ) <= ex.LIMIT_HZ
    cap, wav = str(tmp_path / "jax.iq"), str(tmp_path / "jax.wav")
    top = jl.CompositeBlock()
    top.connect(jl.SignalSource("cosine", ex.TONE_HZ, rate=ex.RATE),
                jl.FrequencyModulatorBlock(ex.DEVIATION),
                jl.IQFileSink(cap, "f32le"))
    top.run(max_chunks=2, chunk_size=1 << 16)
    top = jl.CompositeBlock()
    top.connect(jl.IQFileSource(cap, "f32le", ex.RATE),
                jl.FrequencyDiscriminatorBlock(ex.DEVIATION),
                jl.LowpassFilterBlock(128, 10e3, use_fft=False),
                jl.FMDeemphasisFilterBlock(75e-6), jl.DownsamplerBlock(8),
                jl.WAVFileSink(wav, 1))
    top.run(chunk_size=1 << 16)
    exp, _ = ex.read_audio(wav)
    assert exp.shape == audio.shape
    # int16 audio: one step where the two packages' rounding straddles it
    assert np.max(np.abs(audio - exp)) <= 1


def test_fm_roundtrip_main_runs(tmp_path, monkeypatch, capsys):
    from luaradio_tpu_torch.examples import fm_roundtrip_selftest as ex
    monkeypatch.setattr(ex, "CHUNKS", 2)
    real_run = ex.run
    monkeypatch.setattr(ex, "run", lambda tmp, **kw: real_run(
        tmp, chunks=2, chunk_size=1 << 15, device=kw.get("device")))
    assert ex.main(["--cpu"]) == 0
    assert "OK: tone in == tone out" in capsys.readouterr().out


def _tone_wav(path, rate, seconds, tone):
    t = np.arange(int(rate * seconds)) / rate
    pcm = np.round(0.5 * np.sin(2 * np.pi * tone * t) * 32767.5).astype(
        np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_wavfile_ssb_modulator_matches_jax(sideband, tmp_path):
    """The port's SSB modulator module against the JAX example's graph on a
    1.2 kHz tone at 44.1 kHz: the IQ files within 2e-5 * scale, the tone on
    its sideband (power above 1/20 on one side of DC and below on the
    other)."""
    from luaradio_tpu_torch.examples import wavfile_ssb_modulator as ex
    wav = str(tmp_path / "tone.wav")
    _tone_wav(wav, 44100, 0.5, 1200.0)
    got = str(tmp_path / "port.iq")
    assert ex.main([wav, got, "3000", sideband, "--cpu"]) == 0
    exp = str(tmp_path / "jax.iq")
    top = jl.CompositeBlock()
    src = jl.WAVFileSource(wav, 1)
    blocks = [jl.LowpassFilterBlock(128, 3000.0, use_fft=False),
              jl.HilbertTransformBlock(129)]
    if sideband == "lsb":
        blocks.append(jl.ComplexConjugateBlock())
    blocks.append(jl.ComplexBandpassFilterBlock(
        129, (-3000.0, 0) if sideband == "lsb" else (0, 3000.0),
        use_fft=False))
    top.connect(src, *blocks, jl.IQFileSink(exp, "f32le"))
    top.run()
    a, b = np.fromfile(got, np.complex64), np.fromfile(exp, np.complex64)
    assert a.shape == b.shape == (22050,)
    assert np.max(np.abs(a - b)) < 2e-5 * max(1.0, np.abs(b).max())
    spec = np.abs(np.fft.fft(a[len(a) // 2:])) ** 2
    f = np.fft.fftfreq(len(spec), 1 / 44100)
    pos, neg = spec[f > 0].sum(), spec[f < 0].sum()
    if sideband == "usb":
        assert neg * 20 < pos
    else:
        assert pos * 20 < neg


def test_wavfile_ssb_modulator_usage():
    from luaradio_tpu_torch.examples import wavfile_ssb_modulator as ex
    assert ex.main([]) == 1
    with pytest.raises(ValueError, match="sideband"):
        ex.build("a.wav", "b.iq", 3000.0, "dsb")
