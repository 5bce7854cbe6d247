"""Channel banks in the port against the JAX package on the same numpy
inputs: ChannelizerBlock, BankSource, ``run(channels=C)`` (the one-card
form of the JAX package's ``run(mesh=<channel mesh>, channels=C)``), and
the bank classes WBFMMonoBank, WBFMStereoBank and RDSBank against the JAX
classes, both on the same ("channel", "time") mesh (the port's on its
own mesh, parallel/mesh.py), against the port's own block chains run
banked, and resumed from a JAX bank's state.

Tolerances: 2e-5 * scale where the two packages compute the same chain
on one time shard (the (1, 1) meshes, the banked graphs); 2e-4 * scale
where each stream's time is in 4 shards (the distributed recurrences and
halo FIRs round differently; the JAX package's own bound,
tests/parallel/test_stereo_bank.py:69 and test_rds_bank.py:89) and where
a bank class is held against a block chain; the channelizer at 1e-5.
The PLL-pilot stereo graph is held under the derived L-R bound of
tests/test_torch_stereo.py.
"""

import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.parallel import rds as jax_rds  # noqa: E402
from luaradio_tpu.parallel import wbfm as jax_wbfm  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.interop import bank_state_from_jax  # noqa: E402
from luaradio_tpu_torch.parallel import rds as port_rds  # noqa: E402
from luaradio_tpu_torch.parallel import wbfm as port_wbfm  # noqa: E402
from luaradio_tpu_torch.parallel.channel import ChannelBank  # noqa: E402
from luaradio_tpu_torch.parallel.mesh import Mesh as PortMesh  # noqa: E402
from tests.core.test_receivers import make_pocsag_iq  # noqa: E402
from tests.parallel.test_rds_bank import make_rds_fm  # noqa: E402
from tests.test_torch_stereo import (  # noqa: E402
    _hold_stereo, stereo_mpx)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = {"device": "cpu"}


def _close(got, exp, tol):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got.astype(np.complex128) - exp)))
    assert err < tol * scale, (err, tol * scale)


def _mesh(*shape, axes=("channel",)):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _source(mod, data, rate):
    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate, self.pos = rate, 0
            self.add_type_signature(
                [], [mod.Output("out", mod.ComplexFloat32)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            chunk = data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk
    return ArraySource()


def _collector(mod, t=None):
    """Keeps each call's input: an array, or one channel's list of
    objects (a bank's host tail calls it once per channel, in order)."""
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature(
                [mod.Input("in", t or (lambda _: True))], [])

        def process(self, x):
            self.got.append(list(x) if isinstance(x, list) else np.array(x))
    return Collect()


def _rows(sink):
    return np.concatenate(sink.got, axis=-1)


def _run(mod, top, chunk, channels=None, **kw):
    if mod is tl:
        top.run(chunk_size=chunk, device="cpu", channels=channels, **kw)
    elif channels:
        top.run(chunk_size=chunk, mesh=_mesh(1), channels=channels, **kw)
    else:
        top.run(chunk_size=chunk, **kw)


def _setup(mod, block, types, rate):
    if mod is tl:
        block.device = torch.device("cpu")
    block.differentiate(types)
    block.input_rate = rate
    block.initialize()
    return block


# -- ChannelizerBlock ---------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("c,q", [(4, 8), (8, 6), (16, 4)])
def test_channelizer_matches_jax(c, q, split):
    """The polyphase branch FIRs and the inverse FFT scaled by C, whole
    and split into four chunks carrying the last C q inputs, within 1e-5;
    the rate ratio, batch shape and chunk multiple as in the JAX block."""
    rng = np.random.default_rng(c * 10 + q)
    x = (rng.standard_normal(c * 256) + 1j * rng.standard_normal(c * 256)
         ).astype(np.complex64)
    jb = _setup(jl, jl.ChannelizerBlock(c, q), [jl.ComplexFloat32], 1e6)
    tb = _setup(tl, tl.ChannelizerBlock(c, q), [tl.ComplexFloat32], 1e6)
    assert tb.get_rate_ratio() == jb.get_rate_ratio()
    assert tb.chunk_multiple() == jb.chunk_multiple() == c
    assert tb.out_batch_shape([()]) == jb.out_batch_shape([()]) == (c,)
    js, ts = jb.init_state(), tb.init_state()
    assert tuple(ts.shape) == tuple(js.shape) == (c * q,)
    got, exp = [], []
    for part in (np.split(x, 4) if split else [x]):
        js, jy = jb.process(js, jnp.asarray(part))
        ts, ty = tb.process(ts, torch.from_numpy(part))
        got.append(ty.numpy())
        exp.append(np.asarray(jy))
    _close(np.concatenate(got, -1), np.concatenate(exp, -1), 1e-5)
    _close(ts.numpy(), np.asarray(js), 1e-6)


def test_channelizer_in_a_graph_matches_jax():
    """ChannelizerBlock(8) in a graph (chunk 8 x 512): the [8, T] batch of
    both packages within 1e-5, channel c centred at c rate / 8."""
    rate, n = 8e6, 8 * 2048
    t = np.arange(n)
    x = (np.exp(1j * 2 * np.pi * 3e6 / rate * t)
         + 0.5 * np.exp(1j * 2 * np.pi * -2e6 / rate * t)).astype(
        np.complex64)
    rows = {}
    for mod in (jl, tl):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(_source(mod, x, rate), mod.ChannelizerBlock(8), sink)
        _run(mod, top, 8 * 512)
        rows[mod] = _rows(sink)
    _close(rows[tl], rows[jl], 1e-5)
    power = np.mean(np.abs(rows[tl][:, 64:]) ** 2, axis=-1)
    assert list(np.argsort(power)[::-1][:2]) == [3, 6]


# -- BankSource ---------------------------------------------------------------

def test_bank_source_rows_and_eof_match_jax():
    """Children of 1000, 700 and 1200 samples read 256 at a time: the same
    [3, n] rows in both packages, short at 700 and then EOF (the earliest
    child's)."""
    rng = np.random.default_rng(4)
    data = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) for n in (1000, 700, 1200)]
    reads = {}
    for mod in (jl, tl):
        bank = mod.BankSource([_source(mod, d, 1e3) for d in data])
        assert bank.n_channels == 3 and bank.rate == 1e3
        bank.device = torch.device("cpu")
        bank.differentiate([])
        bank.initialize()
        reads[mod] = []
        while (r := bank.read(256)) is not None:
            reads[mod].append(r)
        bank.cleanup()
    assert [r.shape for r in reads[tl]] == [(3, 256)] * 2 + [(3, 188)]
    for a, b in zip(reads[tl], reads[jl]):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="rate"):
        tl.BankSource([_source(tl, data[0], 1e3), _source(tl, data[1], 2e3)])


# -- BankSource wire ingest ---------------------------------------------------

#: (format, numpy dtype of the file's items) of the wire-ingest cases
_WIRE = {"u8": "u1", "s8": "i1", "u16le": "<u2", "s16be": ">i2"}


def _every_code(dtype, count, rng):
    """``count`` items of ``dtype`` holding every code of the type (those
    first, shuffled, then random ones)."""
    info = np.iinfo(np.dtype(dtype))
    codes = rng.permutation(np.arange(info.min, info.max + 1))
    assert count >= codes.size
    rest = rng.integers(info.min, info.max + 1, count - codes.size)
    return np.concatenate([codes, rest]).astype(dtype)


def _wire_files(tmp_path, fmt, kind, lengths, rng):
    """One file of ``fmt`` items a child, ``lengths`` samples each."""
    k = 2 if kind == "iq" else 1
    paths = []
    for i, n in enumerate(lengths):
        path = tmp_path / f"{fmt}_{kind}_{i}.bin"
        _every_code(_WIRE[fmt], k * n, rng).tofile(path)
        paths.append(str(path))
    return paths


def _file_bank(paths, fmt, kind, repeat=False, mapped=True):
    """A BankSource of IQ or real file sources, initialized on the CPU;
    ``mapped`` False hands each child an open file object it cannot map
    (its bytes in memory), so it reads through ``file.read``."""
    cls = tl.IQFileSource if kind == "iq" else tl.RealFileSource
    files = [p if mapped else io.BytesIO(pathlib.Path(p).read_bytes())
             for p in paths]
    bank = tl.BankSource([cls(f, fmt, 1e3, repeat_on_eof=repeat)
                          for f in files])
    bank.device = torch.device("cpu")
    bank.differentiate([])
    bank.initialize()
    return bank


@pytest.mark.parametrize("mapped", [True, False])
@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("kind", ["iq", "real"])
@pytest.mark.parametrize("fmt", sorted(_WIRE))
def test_wire_bank_equals_host_read(tmp_path, fmt, kind, repeat, mapped):
    """The bank's wire_read through its device_ingest (on CPU tensors)
    equals BankSource.read bit for bit, chunk by chunk: children of
    unequal length holding every code of the format, then a short chunk
    and EOF at the earliest child, or (repeat_on_eof) the seams of every
    child crossed mid-chunk."""
    rng = np.random.default_rng(sorted(_WIRE).index(fmt))
    n0 = 1 << 16 if _WIRE[fmt][-1] == "2" else 1 << 9
    lengths = (n0 + 300, n0, n0 + 700)
    paths = _wire_files(tmp_path, fmt, kind, lengths, rng)
    host = _file_bank(paths, fmt, kind, repeat, mapped)
    wire = _file_bank(paths, fmt, kind, repeat, mapped)
    conv = wire.device_ingest()
    assert conv is not None
    want = n0 // 3 + 1
    shapes = []
    for _ in range(2 * max(lengths) // want + 2):
        exp, got = host.read(want), wire.wire_read(want)
        if exp is None:
            assert got is None
            break
        raw, nv = got
        assert raw.dtype.kind in "iu" and raw.shape == (3, nv * (
            2 if kind == "iq" else 1))
        y = conv(torch.from_numpy(raw)).numpy()
        assert y.dtype == exp.dtype and y.shape == exp.shape
        assert np.array_equal(y.view(np.uint8), exp.view(np.uint8))
        shapes.append(nv)
    host.cleanup()
    wire.cleanup()
    if repeat:
        assert shapes == [want] * len(shapes)
        assert len(shapes) * want > 2 * max(lengths)
    else:   # short at the earliest child's end, then EOF
        full = n0 // want
        assert shapes == [want] * full + [n0 - full * want]


def _u8_iq(x):
    w = np.round(x.view(np.float32) * 127.5 + 127.5)
    return np.clip(w, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("children", ["f32le", "s32le", "mixed_formats",
                                      "iq_and_real", "arrays",
                                      "files_and_arrays"])
def test_wire_bank_falls_back_to_the_host_path(tmp_path, children):
    """A bank whose children do not all offer one exact wire format and
    one wire factor has no device_ingest: the host path, unchanged."""
    x = _iq_bank(64, c=2)
    u8 = tmp_path / "x.u8"
    _u8_iq(x[0]).tofile(u8)
    f32 = tmp_path / "x.f32"
    x[0].tofile(f32)
    s32 = tmp_path / "x.s32"
    np.zeros(128, "<i4").tofile(s32)
    u8f = tl.IQFileSource(str(u8), "u8", 1e3)
    srcs = {
        "f32le": [tl.IQFileSource(str(f32), "f32le", 1e3)] * 2,
        "s32le": [tl.IQFileSource(str(s32), "s32le", 1e3)] * 2,
        "mixed_formats": [u8f, tl.IQFileSource(str(u8), "s8", 1e3)],
        "iq_and_real": [u8f, tl.RealFileSource(str(u8), "u8", 1e3)],
        "arrays": [_source(tl, r, 1e3) for r in x],
        "files_and_arrays": [u8f, _source(tl, x[1], 1e3)],
    }[children]
    assert tl.BankSource(srcs).device_ingest() is None
    assert tl.BankSource([u8f, u8f]).device_ingest() is not None


def _u8_bank_graph(mod, paths, rate):
    return _mono_graph(mod, mod.BankSource(
        [mod.IQFileSource(p, "u8", rate) for p in paths]))


@pytest.mark.parametrize("mode", ["fused", "eager"])
def test_u8_bank_runner_takes_wire_ingest(tmp_path, monkeypatch, mode):
    """A Runner over a BankSource of u8 IQFileSources with channels=C
    ships the bank as wire items (its feed's route ``"wire"``,
    ``BankSource.wire_reads`` one a chunk, the short last one included):
    its rows equal bit for bit the same run with the bank forced onto the
    host path, and lie within 2e-5 * scale of the JAX channel-mesh run."""
    rate, n, chunk = 256e3, 4 * 4096 + 1000, 4096
    paths = []
    for i, x in enumerate(_iq_bank(n)):
        paths.append(str(tmp_path / f"row{i}.u8"))
        _u8_iq(x).tofile(paths[-1])

    def run():
        top, sink = _u8_bank_graph(tl, paths, rate)
        r = Runner(top, mode=mode, chunk_size=chunk, channels=3, **CPU)
        before = tl.BankSource.wire_reads
        r.run()
        return r, tl.BankSource.wire_reads - before, _rows(sink)

    r, reads, wire = run()
    (src,) = r.sources
    assert [(f.source, f.route, f.keys) for f in r.feeds] == [
        (src, "wire", [f"{r.bid[id(src)]}.0"])]
    assert reads == 5
    assert wire.shape == (3, n // 8)
    with monkeypatch.context() as mp:
        mp.setattr(tl.BankSource, "device_ingest", lambda self: None)
        r, reads, host = run()
    assert [f.route for f in r.feeds] == ["host"] and reads == 0
    assert np.array_equal(wire, host)
    top, sink = _u8_bank_graph(jl, paths, rate)
    top.run(chunk_size=chunk, mesh=_mesh(1), channels=3)
    _close(wire, _rows(sink), 2e-5)


@pytest.mark.parametrize("mesh_shape", [(3, 1), (1, 4), (3, 4)])
def test_u8_bank_on_a_mesh_equals_the_unsharded_run(tmp_path, mesh_shape):
    """The wire bank under a ("channel", "time") mesh: the conversion
    runs before the time shards are split, so the rows equal the
    unsharded wire run's within 1e-5 * scale (the time-sharded
    recurrences' bound, tests/test_torch_time_runner.py) and the same
    mesh's run on the host path bit for bit."""
    rate, n, chunk = 256e3, 4 * 4096, 4096
    paths = []
    for i, x in enumerate(_iq_bank(n)):
        paths.append(str(tmp_path / f"row{i}.u8"))
        _u8_iq(x).tofile(paths[-1])

    def run(mesh=None, wire=True):
        top, sink = _u8_bank_graph(tl, paths, rate)
        with pytest.MonkeyPatch.context() as mp:
            if not wire:
                mp.setattr(tl.BankSource, "device_ingest",
                           lambda self: None)
            r = Runner(top, chunk_size=chunk, mesh=mesh, channels=3, **CPU)
        assert (r.feeds[0].route == "wire") is wire
        r.run()
        return _rows(sink)

    ref = run()
    mesh = PortMesh(mesh_shape, ("channel", "time"))
    got = run(mesh)
    assert np.array_equal(got, run(mesh, wire=False))
    _close(got, ref, 1e-5)


# -- run(channels=C) ----------------------------------------------------------

def test_banked_device_source_graph_matches_jax():
    """A graph with only device sources, run with channels=4: replicated
    over the bank, each row the JAX mesh run's within 2e-5."""
    ys = {}
    for mod in (jl, tl):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(mod.SignalSource("cosine", 1000.0, 48000.0),
                    mod.LowpassFilterBlock(33, 5000.0), sink)
        _run(mod, top, 2048, channels=4, max_chunks=3)
        ys[mod] = _rows(sink)
    assert ys[tl].shape == (4, 3 * 2048)
    for c in range(1, 4):
        assert np.array_equal(ys[tl][c], ys[tl][0])
    _close(ys[tl], ys[jl], 2e-5)


def _iq_bank(n, c=3, seed=11):
    rng = np.random.default_rng(seed)
    return [(np.exp(1j * np.cumsum(0.5 * rng.standard_normal(n)))
             + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64) for _ in range(c)]


def _mono_graph(mod, src):
    top, sink = mod.CompositeBlock(), _collector(mod)
    top.connect(src, mod.WBFMMonoDemodulator(tau=75e-6),
                mod.DownsamplerBlock(8), sink)
    return top, sink


@pytest.mark.parametrize("optimize", [True, False])
def test_banked_wbfm_mono_graph_matches_jax(optimize):
    """BankSource -> WBFMMonoDemodulator -> Downsampler(8), channels taken
    from the BankSource: within 2e-5 * scale of the JAX channel-mesh run
    and of each channel run alone."""
    rate, xs = 256e3, _iq_bank(16384)
    rows = {}
    for mod in (jl, tl):
        top, sink = _mono_graph(mod, mod.BankSource(
            [_source(mod, x, rate) for x in xs]))
        if mod is tl:
            top.run(chunk_size=4096, optimize=optimize, **CPU)
        else:
            top.run(chunk_size=4096, optimize=optimize, mesh=_mesh(1),
                    channels=len(xs))
        rows[mod] = _rows(sink)
    assert rows[tl].shape == (3, 16384 // 8)
    _close(rows[tl], rows[jl], 2e-5)
    for c, x in enumerate(xs):
        top, sink = _mono_graph(tl, _source(tl, x, rate))
        top.run(chunk_size=4096, optimize=optimize, **CPU)
        _close(rows[tl][c], _rows(sink), 2e-5)


def test_banked_stereo_pll_graph_matches_jax():
    """BankSource -> WBFMStereoDemodulator(pilot="pll") on two stations
    (their own phases) and a noise row, with sinks on the PLL's output and
    the delayed signal: L+R within 2e-5 * scale of the JAX channel-mesh
    run, L-R under the derived PLL bound, row by row."""
    rate, n = 220500.0, 1 << 15
    rng = np.random.default_rng(9)
    xs = [stereo_mpx(n, rate) * np.exp(1j * p) for p in (0.3, 2.1)]
    xs.append(0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    xs = [x.astype(np.complex64) for x in xs]
    runs = {}
    for mod in (jl, tl):
        top = mod.CompositeBlock()
        demod = mod.WBFMStereoDemodulator(pilot="pll")
        sinks = {"left": _collector(mod), "right": _collector(mod)}
        top.connect(mod.BankSource([_source(mod, x, rate) for x in xs]),
                    demod)
        top.connect(demod, "left", sinks["left"], "in")
        top.connect(demod, "right", sinks["right"], "in")
        inner = {type(b).__name__: b for b in demod._blocks}
        for name, block in (("pll", inner["PLLBlock"]),
                            ("delayed", inner["DelayBlock"])):
            sinks[name] = _collector(mod)
            top.connect(block, "out", sinks[name], "in")
        _run(mod, top, 8192, channels=3)
        runs[mod] = {k: _rows(s) for k, s in sinks.items()}
        if mod is tl:
            tiers = inner["PLLBlock"].tier_counts
    assert runs[tl]["left"].shape == (3, n)
    assert sum(tiers.values()) == 3 * (n // 8192) and tiers[3] >= 4
    for c in range(3):
        _hold_stereo({k: v[c] for k, v in runs[tl].items()},
                     {k: v[c] for k, v in runs[jl].items()}, True)


def test_banked_pocsag_graph_decodes_each_row_as_jax():
    """The POCSAG receiver's host tail (framer, decoder, the demoted
    duals behind the masked Sampler) runs one clone per channel: rows
    carrying the message (one delayed, one scaled) decode it, the noise
    row decodes nothing, and every row's messages equal the JAX package's
    channel-mesh run's.  A BenchmarkSink beside the port's sink counts
    every channel's messages."""
    iq, rate, baud, address, func, text = make_pocsag_iq()
    rng = np.random.default_rng(12)
    n = len(iq) + 3000
    rows = [np.concatenate([iq, np.zeros(3000, np.complex64)]),
            0.2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)),
            np.concatenate([np.zeros(3000, np.complex64), iq]),
            0.5 * np.concatenate([iq, np.zeros(3000, np.complex64)])]
    rows = [r.astype(np.complex64) for r in rows]
    per_row = {}
    for mod in (jl, tl):
        top, sink = mod.CompositeBlock(), _collector(mod)
        rx = mod.POCSAGReceiver(baud)
        top.connect(mod.BankSource([_source(mod, r, rate) for r in rows]),
                    rx, sink)
        if mod is tl:                    # a sink that only counts, too
            counter = tl.BenchmarkSink(use_json=True, file=io.StringIO())
            top.connect(rx, "out", counter, "in")
        _run(mod, top, 1 << 15, channels=4)
        assert len(sink.got) % 4 == 0
        per_row[mod] = [[m.to_json() for call in sink.got[c::4]
                         for m in call] for c in range(4)]
    assert per_row[tl] == per_row[jl]
    got = per_row[tl]
    assert [len(r) for r in got] == [1, 0, 1, 1]
    assert counter.total_count == 3
    assert got[0] == got[2] == got[3]
    msg = json.loads(got[0][0])
    assert (msg["address"], msg["func"], msg["alphanumeric"]) == (
        address, func, text)


def test_host_block_feeding_a_device_block_raises_in_a_bank():
    """As in the JAX runtime: a host block whose output re-enters a device
    block has no common per-channel length to batch."""
    class HostPass(tl.HostBlock):
        def __init__(self):
            super().__init__()
            self.add_type_signature([tl.Input("in", tl.ComplexFloat32)],
                                    [tl.Output("out", tl.ComplexFloat32)])

        def process(self, x):
            return x
    x = np.zeros(4096, np.complex64)
    top = tl.CompositeBlock()
    top.connect(tl.BankSource([_source(tl, x, 1e6)] * 2), HostPass(),
                tl.MultiplyConstantBlock(2.0), _collector(tl))
    with pytest.raises(NotImplementedError, match="HostPass"):
        Runner(top, chunk_size=1024, device="cpu")


def test_bank_width_must_match_the_bank_source():
    x = np.zeros(4096, np.complex64)
    top = tl.CompositeBlock()
    top.connect(tl.BankSource([_source(tl, x, 1e6)] * 2),
                tl.MultiplyConstantBlock(2.0), _collector(tl))
    with pytest.raises(ValueError, match="channels=3"):
        Runner(top, chunk_size=1024, device="cpu", channels=3)
    top = tl.CompositeBlock()
    top.connect(_source(tl, x, 1e6), tl.MultiplyConstantBlock(2.0),
                _collector(tl))
    with pytest.raises(ValueError, match="BankSource"):
        Runner(top, chunk_size=1024, device="cpu", channels=2)


def test_channel_bank_steps_a_block_chain():
    """ChannelBank: the blocks' states broadcast to [C, ...] and the chain
    stepped over [C, T], each row what the chain gives that row alone."""
    rate, xs = 256e3, np.stack(_iq_bank(8192, c=2))
    blocks = [tl.FrequencyDiscriminatorBlock(1.25),
              tl.LowpassFilterBlock(64, 15e3)]
    _setup(tl, blocks[0], [tl.ComplexFloat32], rate)
    _setup(tl, blocks[1], [tl.Float32], rate)
    bank = ChannelBank(blocks, 2)
    states = bank.init_states()
    assert tuple(states[1].shape) == (2, 63)
    outs = []
    for part in np.split(xs, 2, axis=-1):
        states, y = bank.step(states, torch.from_numpy(part.copy()))
        outs.append(y.numpy())
    got = np.concatenate(outs, -1)
    for c in range(2):
        st = [b.init_state() for b in blocks]
        y1 = []
        for part in np.split(xs[c], 2):
            v = torch.from_numpy(part.copy())
            for i, b in enumerate(blocks):
                st[i], v = b.process(st[i], v)
            y1.append(v.numpy())
        _close(got[c], np.concatenate(y1), 1e-6)


# -- the bank classes ---------------------------------------------------------

N_CH, T_CHUNK, N_CHUNKS = 2, 8192, 3
CLASSES = {
    "mono": (jax_wbfm.WBFMMonoBank, port_wbfm.WBFMMonoBank, 256e3),
    "stereo": (jax_wbfm.WBFMStereoBank, port_wbfm.WBFMStereoBank, 256e3),
    "rds": (jax_rds.RDSBank, port_rds.RDSBank, 228e3),
}


def _bank_input(kind, n=T_CHUNK * N_CHUNKS):
    rng = np.random.default_rng(5)
    if kind == "rds":
        groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
                  for _ in range(2)]
        base = make_rds_fm(n, groups)
    else:                              # broadcast FM at 75 kHz deviation
        base = stereo_mpx(n, CLASSES[kind][2])
    return np.stack([base * np.exp(1j * rng.uniform(0, 2 * np.pi))
                     for _ in range(N_CH)]).astype(np.complex64)


def _outs(kind, y):
    if kind == "stereo":
        return np.concatenate([np.asarray(v) for v in y], axis=-1)
    return np.asarray(y)


def _jax_bank(kind, mesh_shape, x, chunks=N_CHUNKS, state=None):
    jcls, _, rate = CLASSES[kind]
    mesh = _mesh(*mesh_shape, axes=("channel", "time"))
    bank = jcls(mesh, if_rate=rate) if kind == "rds" else \
        jcls(mesh, if_rate=rate, decimation=8)
    step = bank.jit_step()
    state = bank.init_state(x.shape[0]) if state is None else state
    outs = []
    for k in range(chunks):
        state, y = step(state, x[:, k * T_CHUNK:(k + 1) * T_CHUNK])
        outs.append(_outs(kind, y))
    return state, outs


def _port_bank(kind, x, chunks=N_CHUNKS, state=None, start=0,
               mesh_shape=(1, 1)):
    _, pcls, rate = CLASSES[kind]
    mesh = PortMesh(mesh_shape, ("channel", "time"))
    bank = pcls(mesh, if_rate=rate, **CPU) if kind == "rds" else \
        pcls(mesh, if_rate=rate, decimation=8, **CPU)
    state = bank.init_state(x.shape[0]) if state is None else state
    outs = []
    for k in range(start, start + chunks):
        state, y = bank.step(state, torch.from_numpy(
            x[:, k * T_CHUNK:(k + 1) * T_CHUNK].copy()))
        outs.append(_outs(kind, [v.numpy() for v in y] if kind == "stereo"
                          else y.numpy()))
    return state, outs


@pytest.mark.parametrize("mesh_shape,tol", [((1, 1), 2e-5),
                                            ((2, 4), 2e-4)])
@pytest.mark.parametrize("kind", ["mono", "stereo", "rds"])
def test_bank_class_matches_jax(kind, mesh_shape, tol):
    """Three chunks of streaming state against the JAX class, both on the
    same mesh: on a (1, 1) mesh within 2e-5 * scale, on a (2, 4) mesh
    (each stream's time in 4 shards) within 2e-4 * scale; the carried
    state leaf for leaf at the same bound."""
    x = _bank_input(kind)
    jstate, jout = _jax_bank(kind, mesh_shape, x)
    tstate, tout = _port_bank(kind, x, mesh_shape=mesh_shape)
    for a, b in zip(tout, jout):
        _close(a, b, tol)
    assert len(tstate) == len(jstate)
    for a, b in zip(tstate, jstate):
        assert tuple(a.shape) == np.shape(b)
        _close(a.numpy(), np.asarray(b), tol)


@pytest.mark.parametrize("kind", ["mono", "stereo", "rds"])
def test_bank_class_resumes_a_jax_bank(kind):
    """A stream started in the JAX class and resumed in the port from its
    state (interop.bank_state_from_jax): the port's next chunk against the
    JAX class's own next chunk, within 2e-5 * scale."""
    x = _bank_input(kind)
    jstate, _ = _jax_bank(kind, (1, 1), x, chunks=2)
    tstate = bank_state_from_jax(jstate, **CPU)   # the JAX step donates it
    _, jnext = _jax_bank(kind, (1, 1), x[:, 2 * T_CHUNK:], chunks=1,
                         state=jstate)
    assert tstate[0].dtype == torch.complex64
    _, tnext = _port_bank(kind, x, chunks=1, state=tstate, start=2)
    _close(tnext[0], jnext[0], 2e-5)


def _chain_graph(kind, x, rate):
    """The port's block chain the class stands for, run banked: the WBFM
    demodulators (stereo with the vector pilot) -> Downsampler(8), or the
    RDS front end up to the RRC filter (tests/parallel/test_rds_bank.py
    _serial_front)."""
    top = tl.CompositeBlock()
    src = tl.BankSource([_source(tl, r, rate) for r in x])
    if kind == "rds":
        disc, hilb = tl.FrequencyDiscriminatorBlock(1.25), \
            tl.HilbertTransformBlock(129)
        delay, mixer = tl.DelayBlock(64), tl.MultiplyConjugateBlock()
        pilot = tl.PilotRecoveryBlock(129, (18e3, 20e3), multiplier=3)
        sink = _collector(tl)
        top.connect(src, disc, hilb, delay)
        top.connect(hilb, pilot)
        top.connect(delay, "out", mixer, "in1")
        top.connect(pilot, "out", mixer, "in2")
        top.connect(mixer, tl.LowpassFilterBlock(128, 4e3),
                    tl.RootRaisedCosineFilterBlock(101, 1, 1187.5), sink)
        sinks = [sink]
    elif kind == "mono":
        sink = _collector(tl)
        top.connect(src, tl.WBFMMonoDemodulator(), tl.DownsamplerBlock(8),
                    sink)
        sinks = [sink]
    else:
        demod = tl.WBFMStereoDemodulator(pilot="vector")
        sinks = [_collector(tl), _collector(tl)]
        top.connect(src, demod)
        for port, sink in zip(("left", "right"), sinks):
            ds = tl.DownsamplerBlock(8)
            top.connect(demod, port, ds, "in")
            top.connect(ds, "out", sink, "in")
    top.run(chunk_size=T_CHUNK, optimize=False, **CPU)
    return np.concatenate([_rows(s) for s in sinks], axis=-1)


@pytest.mark.parametrize("kind", ["mono", "stereo", "rds"])
def test_bank_class_matches_the_banked_block_chain(kind):
    """Each class against the port's ordinary blocks for the same
    receiver, run banked over the same rows: within 2e-4 * scale (the
    JAX package's bound for its classes against its block graph)."""
    x = _bank_input(kind)
    _, outs = _port_bank(kind, x)
    if kind == "stereo":
        half = [np.split(o, 2, axis=-1) for o in outs]
        got = np.concatenate([np.concatenate([h[0] for h in half], -1),
                              np.concatenate([h[1] for h in half], -1)], -1)
    else:
        got = np.concatenate(outs, -1)
    _close(got, _chain_graph(kind, x, CLASSES[kind][2]), 2e-4)


# -- the wideband channelizer example -----------------------------------------

def test_wideband_channelizer_example_graph_matches_jax(tmp_path):
    """examples/wideband_channelizer_bank.py's graph at 16 channels over
    its 2^18-sample synthesized capture (tests/test_examples.py): the
    port's [16, 8192] audio within 2e-5 * scale of the JAX package's, and
    the carrier-bearing channels on top of the RMS ranking."""
    spec = importlib.util.spec_from_file_location(
        "wideband_example", ROOT / "examples" / "wideband_channelizer_bank.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    path, rate, channels = str(tmp_path / "wideband.iq"), 4.096e6, 16
    example.synth_capture(path, rate=rate, channels=channels)
    audio = {}
    for mod in (jl, tl):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(mod.IQFileSource(path, "f32le", rate),
                    mod.ChannelizerBlock(channels, taps_per_branch=8),
                    mod.WBFMMonoDemodulator(), mod.DownsamplerBlock(2), sink)
        _run(mod, top, channels * 16384)
        audio[mod] = _rows(sink)
    assert audio[tl].shape == (16, 8192)
    _close(audio[tl], audio[jl], 2e-5)
    rms = np.sqrt((audio[tl] ** 2).mean(axis=-1))
    active = {int(c) for c in np.argsort(rms)[::-1][:4]}
    assert {1, 3, 7} <= active and active & {12, 13}, active


def test_bank_modules_import_without_jax():
    """The new modules are among those test_torch_imports.py imports
    with jax blocked."""
    from tests.test_torch_imports import MODULES
    for name in ("blocks.signal.channelizer", "blocks.sources.bank",
                 "parallel.channel", "parallel.wbfm", "parallel.rds"):
        assert f"luaradio_tpu_torch.{name}" in MODULES
