"""Time sharding through the port's Runner (``Runner(top, mesh=...)``,
core/runtime.py) against the JAX package on the same numpy-seeded inputs:
each case of tests/parallel/test_time_runner.py and
tests/parallel/test_receiver_capstones.py, run through the port on the
mesh shape of the JAX test, against the port's serial run and against the
JAX run on the same mesh shape.  (The cases of
tests/parallel/test_pll_sharded.py are helper tests: they are in
tests/test_torch_time.py.)

Bounds are the matching JAX test's, for the port's mesh run against its
serial run: the WBFM graphs and the (channel, time) bank 1e-5
(test_time_runner.py:66, :222), the device sources and recurrences 2e-5
(:111), the FFT FIR and Hilbert 1e-4 (:139), chunk boundaries 1e-6
(:88), the clock recovery, the masked sampler and the decoded packets
exactly.  Against the JAX package's mesh run the bound is the same
number times max(1, peak), plus the distance of the two packages'
serial runs where those differ at all (measured below the bound of
tests/test_torch_graph.py's mono graph, 2e-5 * scale): so 3e-5 * scale
for the float graphs, exact for bits and packets.

The port carries one global state per block (no ``shard0_state``): a run
sharded for k chunks and resumed serially from its carried states must
equal the all-serial run.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.core.runtime import Runner as JaxRunner  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests.core.test_receivers import (make_ax25_iq,  # noqa: E402
                                       make_bpsk31_iq, make_pocsag_iq,
                                       make_scm_iq)
from tests.parallel.test_rds_bank import make_rds_fm  # noqa: E402

RNG = np.random.default_rng(31)
TIME8 = ((8,), ("time",))
TIME4 = ((4,), ("time",))


def _source(mod, data, rate):
    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate, self.pos = rate, 0
            out_t = (mod.ComplexFloat32 if np.iscomplexobj(data)
                     else mod.Float32)
            self.add_type_signature([], [mod.Output("out", out_t)])

        def read(self, n):
            if self.pos >= data.shape[-1]:
                return None
            chunk = data[..., self.pos:self.pos + n]
            self.pos += chunk.shape[-1]
            return chunk
    return ArraySource()


def _collector(mod):
    """Each call's input: an array, or a list of decoded objects."""
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            self.got.append(list(x) if isinstance(x, (list, tuple))
                            else np.array(x))
    return Collect()


def _stream(sink):
    return np.concatenate([np.asarray(g).reshape(-1) for g in sink.got])


def _items(sink):
    """Decoded objects as their JSON forms (plain values as they are)."""
    return [json.loads(i.to_json()) if hasattr(i, "to_json") else i
            for g in sink.got for i in g]


def _run(mod, top, mesh=None, chunk=1 << 13, max_chunks=None, **kw):
    """Run ``top`` in package ``mod`` on a mesh given as (shape, names),
    or serially."""
    if mod is tl:
        m = Mesh(*mesh) if mesh else None
        r = Runner(top, chunk_size=chunk, mesh=m, device="cpu", **kw)
    else:
        m = None
        if mesh:
            shape, names = mesh
            devs = jax.devices("cpu")[:int(np.prod(shape))]
            m = JaxMesh(np.asarray(devs).reshape(shape), names)
        r = JaxRunner(top, mode="fused", chunk_size=chunk, mesh=m, **kw)
    r.run(max_chunks=max_chunks)
    return r


def _three(build, mesh, chunk=1 << 13, max_chunks=None, **kw):
    """(port serial, port on ``mesh``, JAX on ``mesh``): the sink of each
    run of ``build(mod) -> (top, sink)``."""
    out = []
    for mod, m in ((tl, None), (tl, mesh), (jl, mesh)):
        top, sink = build(mod)
        _run(mod, top, m, chunk, max_chunks, **kw)
        out.append(sink)
    return out


def _close(got, exp, tol):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got.astype(np.complex128) - exp)))
    assert err < tol * scale, (err, tol * scale)


# -- tests/parallel/test_time_runner.py ---------------------------------------

def _wbfm(mod, x, rate=256e3):
    """The rx_wbfm mono chain out of ordinary blocks."""
    top, sink = mod.CompositeBlock(), _collector(mod)
    top.connect(_source(mod, x, rate), mod.FrequencyTranslatorBlock(-50e3),
                mod.LowpassFilterBlock(64, 100e3),
                mod.FrequencyDiscriminatorBlock(1.25),
                mod.LowpassFilterBlock(32, 15e3, use_fft=False),
                mod.FMDeemphasisFilterBlock(75e-6), mod.DownsamplerBlock(8),
                sink)
    return top, sink


def _fm_capture(n, seed=31):
    rng = np.random.default_rng(seed)
    return np.exp(1j * 0.3 * np.cumsum(rng.standard_normal(n))).astype(
        np.complex64)


def test_wbfm_mono_time_sharded_equals_serial():
    x = _fm_capture(1 << 16)
    serial, mesh, jax_mesh = _three(lambda m: _wbfm(m, x), TIME8,
                                    chunk=1 << 14)
    _close(_stream(mesh), _stream(serial), 1e-5)
    _close(_stream(mesh), _stream(jax_mesh), 3e-5)


def test_time_sharded_chunk_boundaries_match():
    """Carried state across chunk boundaries survives sharding: two chunk
    sizes give the same stream (sample 0, the discriminator's atan2 of
    zeros, excepted as in the JAX test)."""
    n = 1 << 15
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64)
    taps = RNG.standard_normal(33).astype(np.float32)

    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(_source(mod, x, 1e6), mod.FIRFilterBlock(taps,
                                                             use_fft=False),
                    mod.FrequencyDiscriminatorBlock(2.0), sink)
        return top, sink
    outs = {}
    for cs in (1 << 13, 1 << 15):
        for mod in (tl, jl):
            top, sink = build(mod)
            _run(mod, top, TIME8, chunk=cs)
            outs[mod, cs] = _stream(sink)
    _close(outs[tl, 1 << 13][1:], outs[tl, 1 << 15][1:], 1e-6)
    _close(outs[tl, 1 << 13][1:], outs[jl, 1 << 13][1:], 3e-5)


def _recurrences(mod):
    top, sink = mod.CompositeBlock(), _collector(mod)
    top.connect(mod.SignalSource("cosine", 1200.0, 48e3, amplitude=0.4),
                mod.FMPreemphasisFilterBlock(75e-6),
                mod.FrequencyModulatorBlock(0.1), mod.AGCBlock("fast"),
                mod.ComplexToRealBlock(), sink)
    return top, sink


def test_time_sharded_device_sources_and_recurrences():
    """Oscillator phase offsets per shard, the IIR prefix, the AGC's
    data-dependent scans and the FM modulator's cumulative sum."""
    serial, mesh, jax_mesh = _three(_recurrences, TIME8, max_chunks=6)
    _close(_stream(mesh), _stream(serial), 2e-5)
    _close(_stream(mesh), _stream(jax_mesh), 3e-5)


def test_time_sharded_fft_fir_and_hilbert():
    x = RNG.standard_normal(1 << 16).astype(np.float32)
    taps = RNG.standard_normal(129).astype(np.float32)

    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(_source(mod, x, 1e6), mod.FIRFilterBlock(taps,
                                                             use_fft=True),
                    mod.HilbertTransformBlock(65),
                    mod.ComplexMagnitudeBlock(), sink)
        return top, sink
    serial, mesh, jax_mesh = _three(build, TIME8, chunk=1 << 15)
    _close(_stream(mesh), _stream(serial), 1e-4)
    _close(_stream(mesh), _stream(jax_mesh), 1e-4)


def test_unsupported_block_raises_clearly():
    """A per-sample feedback loop (PLL) cannot time-shard: the Runner says
    so by the block's name."""
    top = tl.CompositeBlock()
    top.connect(tl.UniformRandomSource(tl.ComplexFloat32, 1e6),
                tl.PLLBlock(100.0, 1e3, 2e3), tl.NopSink())
    with pytest.raises(NotImplementedError, match="PLLBlock"):
        _run(tl, top, TIME8, max_chunks=1)


def test_tail_longer_than_a_shard_raises():
    """A carried tail longer than the per-shard chunk raises with the JAX
    package's message (its core/block.py:283-287)."""
    top, sink = tl.CompositeBlock(), _collector(tl)
    top.connect(_source(tl, _fm_capture(4096), 1e6),
                tl.FIRFilterBlock(np.ones(300, np.float32)), sink)
    with pytest.raises(NotImplementedError, match="exceeds the per-shard"):
        _run(tl, top, TIME8, chunk=1024)


def test_random_source_shards_deterministically():
    """UniformRandomSource under time sharding: one stream a shard, the
    same for a seed and a shard count, the shards' streams different.
    Its streams are the port's own (a seeded torch.Generator), not JAX's
    rbg keys: a stated departure (ROADMAP queue 3)."""
    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(mod.UniformRandomSource(mod.Float32, 1e6, seed=7),
                    mod.MultiplyConstantBlock(2.0), sink)
        return top, sink
    runs = []
    for _ in range(2):
        top, sink = build(tl)
        _run(tl, top, TIME8, max_chunks=3)
        runs.append(_stream(sink))
    assert runs[0].shape[0] >= 3 * (1 << 13)
    assert np.array_equal(runs[0], runs[1])
    seg = runs[0][:1 << 13].reshape(8, -1)
    assert not np.allclose(seg[0], seg[1])
    assert np.all(np.abs(runs[0]) <= 2.0)
    top, sink = build(tl)
    _run(tl, top, TIME4, max_chunks=1)
    assert not np.array_equal(_stream(sink), runs[0][:1 << 13])


def _bank_graph(mod, src, sink):
    top = mod.CompositeBlock()
    top.connect(src, mod.FrequencyTranslatorBlock(-20e3),
                mod.LowpassFilterBlock(48, 60e3, use_fft=False),
                mod.FrequencyDiscriminatorBlock(1.25),
                mod.FMDeemphasisFilterBlock(75e-6), mod.DownsamplerBlock(4),
                sink)
    return top


def test_combined_channel_time_mesh_equals_serial():
    """A 2-channel bank with each stream's time in 4 shards on a
    ("channel", "time") mesh against per-channel serial runs and the JAX
    package on the same mesh."""
    n = 1 << 14
    chans = [(RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64) for _ in range(2)]
    refs = []
    for z in chans:
        sink = _collector(tl)
        _run(tl, _bank_graph(tl, _source(tl, z, 256e3), sink))
        refs.append(_stream(sink))
    got = {}
    for mod in (tl, jl):
        sink = _collector(mod)
        src = mod.BankSource([_source(mod, z, 256e3) for z in chans])
        _run(mod, _bank_graph(mod, src, sink), ((2, 4), ("channel", "time")),
             channels=2)
        got[mod] = np.concatenate(sink.got, axis=-1)
    assert got[tl].shape == (2, refs[0].shape[0])
    for c in range(2):
        _close(got[tl][c], refs[c], 1e-5)
    _close(got[tl], got[jl], 3e-5)


def _clock_bits(n_bits, noise, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits)
    return (np.repeat(bits * 2.0 - 1.0, 16)
            + noise * rng.standard_normal(n_bits * 16)).astype(np.float32)


def test_zero_crossing_clock_recovery_time_sharded():
    """The hysteresis prefix, the distributed cummax and the halos give
    the serial clock exactly, and the JAX package's."""
    x = _clock_bits(2048, 0.05, 1)

    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(_source(mod, x, 16.0),
                    mod.ZeroCrossingClockRecoveryBlock(1.0), sink)
        return top, sink
    serial, mesh, jax_mesh = _three(build, TIME8)
    assert np.array_equal(_stream(mesh), _stream(serial))
    assert np.array_equal(_stream(mesh), _stream(jax_mesh))


def _bit_tail(mod, src, sink):
    """Clock recovery -> masked sampler -> slicer (the RDS bit tail)."""
    top = mod.CompositeBlock()
    zccr, sampler = mod.ZeroCrossingClockRecoveryBlock(1.0), \
        mod.SamplerBlock()
    top.connect(src, zccr)
    top.connect(src, "out", sampler, "data")
    top.connect(zccr, "out", sampler, "clock")
    top.connect(sampler, mod.SlicerBlock(), sink)
    return top


def test_sampler_masked_output_time_sharded():
    x = _clock_bits(1024, 0.01, 2)

    def build(mod):
        sink = _collector(mod)
        return _bit_tail(mod, _source(mod, x, 16.0), sink), sink
    serial, mesh, jax_mesh = _three(build, TIME8, chunk=1 << 12)
    assert _stream(mesh).size >= 1000
    assert np.array_equal(_stream(mesh), _stream(serial))
    assert np.array_equal(_stream(mesh), _stream(jax_mesh))


def test_rds_tail_blocks_channel_time_mesh():
    """The bit tail on a ("channel", "time") mesh: [C] states against
    [C, T] streams, masked outputs compacted per channel; the (uncloned)
    sink takes one call a channel a chunk, rows alternating."""
    xs = [_clock_bits(768, 0.01, 10 + c) for c in range(2)]
    refs = []
    for x in xs:
        sink = _collector(tl)
        _run(tl, _bit_tail(tl, _source(tl, x, 16.0), sink), chunk=1 << 12)
        refs.append(_stream(sink))
    got = {}
    for mod in (tl, jl):
        sink = _collector(mod)
        src = mod.BankSource([_source(mod, x, 16.0) for x in xs])
        _run(mod, _bit_tail(mod, src, sink), ((2, 4), ("channel", "time")),
             chunk=1 << 12, channels=2)
        got[mod] = [np.concatenate([np.asarray(g).reshape(-1)
                                    for g in sink.got[c::2]])
                    for c in range(2)]
    for c in range(2):
        assert got[tl][c].size >= 700
        assert np.array_equal(got[tl][c], refs[c])
        assert np.array_equal(got[tl][c], got[jl][c])


def test_full_rds_receiver_time_sharded():
    """The whole RDSReceiver (vector pilot) on one stream in 4 time shards
    decodes the serial run's groups and the JAX package's."""
    rng = np.random.default_rng(53)
    groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
              for _ in range(6)]
    iq = make_rds_fm(1 << 18, groups)

    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        top.connect(_source(mod, iq, 228000.0),
                    mod.RDSReceiver(pilot="vector"), sink)
        return top, sink
    serial, mesh, jax_mesh = _three(build, TIME4, chunk=1 << 21)

    def raw(sink):
        return {tuple(p["data"]["frame"]) for p in _items(sink)
                if p["data"].get("type") == "raw"}
    assert len([g for g in groups if g in raw(serial)]) >= 3
    assert raw(mesh) == raw(serial) == raw(jax_mesh)
    assert _items(mesh) == _items(serial)


# -- the carried state --------------------------------------------------------

@pytest.mark.parametrize("graph", ["wbfm", "recurrences"])
def test_sharded_run_resumed_serially_equals_serial(graph):
    """Two chunks on an 8-shard mesh, then the rest serially from the
    states the sharded run carried: the stream equals the all-serial run
    within 1e-5 * scale, and each carried state the serial run's after
    the same two chunks (the port's one global state a block; the JAX
    package's shard0_state has no counterpart)."""
    chunk, k = 1 << 13, 2
    x = _fm_capture(5 * chunk, seed=9)

    def build(mod, data=x):
        return _wbfm(mod, data) if graph == "wbfm" else _recurrences(mod)
    top, all_serial = build(tl)
    _run(tl, top, chunk=chunk, max_chunks=5)

    top, first = build(tl)
    sharded = _run(tl, top, TIME8, chunk=chunk, max_chunks=k)
    top, ref = build(tl)
    ref_run = _run(tl, top, chunk=chunk, max_chunks=k)
    top, rest = build(tl, x[k * chunk:])
    resumed = Runner(top, chunk_size=chunk, device="cpu")
    for (seg, _), (sh, _), (rf, _) in zip(resumed.stage_plan,
                                          sharded.stage_plan,
                                          ref_run.stage_plan):
        if seg is None:
            continue
        for key, st in sh.states.items():
            exp = rf.states[key]
            for a, b in zip(*(s if isinstance(s, tuple) else (s,)
                              for s in (st, exp))):
                if isinstance(a, torch.Tensor):
                    _close(a.numpy(), b.numpy(), 1e-5)
        seg.states = dict(sh.states)
    resumed.run(max_chunks=5 - k)
    _close(np.concatenate([_stream(first), _stream(rest)]),
           _stream(all_serial), 1e-5)


# -- tests/parallel/test_receiver_capstones.py --------------------------------

def _capstone(make_rx, iq, rate, chunk, out="out"):
    def build(mod):
        top, sink = mod.CompositeBlock(), _collector(mod)
        rx = make_rx(mod)
        top.connect(_source(mod, iq, rate), "out", rx, "in")
        top.connect(rx, out, sink, "in")
        return top, sink
    serial, mesh, jax_mesh = _three(build, TIME4, chunk=chunk)
    assert len(_items(serial)) >= 1
    assert _items(mesh) == _items(serial) == _items(jax_mesh)
    return _items(mesh)


def test_ax25_receiver_time_sharded():
    iq, rate = make_ax25_iq()
    frames = _capstone(lambda m: m.AX25Receiver(), iq, rate, 1 << 15)
    assert frames[0]["addresses"][0]["callsign"] == "NOCALL"
    assert frames[0]["payload"] == "hello from tpu radio"


def test_pocsag_receiver_time_sharded():
    iq, rate, baud, address, func, text = make_pocsag_iq()
    msgs = _capstone(lambda m: m.POCSAGReceiver(baud), iq, rate, 1 << 15)
    assert (msgs[0]["address"], msgs[0]["func"],
            msgs[0]["alphanumeric"]) == (address, func, text)


def test_ert_scm_receiver_time_sharded():
    iq, rate, ert_id, consumption = make_scm_iq()
    frames = _capstone(lambda m: m.ERTReceiver(("scm",)), iq, rate, 1 << 17,
                       out="out1")
    assert (frames[0]["ert_id"], frames[0]["consumption"]) == (ert_id,
                                                                consumption)


def test_bpsk31_receiver_time_sharded():
    iq, rate, text = make_bpsk31_iq()
    chars = _capstone(lambda m: m.BPSK31Receiver(), iq, rate, 1 << 15)
    assert text in bytes(int(v) for v in chars).decode(errors="replace")


def test_combined_channel_time_receiver():
    """A 2-channel POCSAG bank with each channel's time in 2 shards, on a
    (2, 2) ("channel", "time") mesh: both channels decode the serial
    message, as in the JAX package."""
    iq, rate, baud, *_ = make_pocsag_iq()
    sink = _collector(tl)
    top = tl.CompositeBlock()
    top.connect(_source(tl, iq, rate), tl.POCSAGReceiver(baud), sink)
    _run(tl, top, chunk=1 << 14)
    serial = _items(sink)
    assert len(serial) >= 1
    got = {}
    for mod in (tl, jl):
        sink = _collector(mod)
        top = mod.CompositeBlock()
        top.connect(mod.BankSource([_source(mod, iq, rate),
                                    _source(mod, iq * np.complex64(1.0),
                                            rate)]),
                    mod.POCSAGReceiver(baud), sink)
        _run(mod, top, ((2, 2), ("channel", "time")), chunk=1 << 14,
             channels=2)
        got[mod] = _items(sink)
    assert got[tl].count(serial[0]) >= 2, got[tl]
    assert got[tl] == got[jl]
