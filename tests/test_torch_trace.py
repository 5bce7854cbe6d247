"""The runtime's span records (luaradio_tpu_torch/core/trace.py): chunk
ids and parents on every span of the pump and the read-ahead thread, the
pipelined hold, the PLL's host reads as children of its dispatch span
and that of its segment's, the PLL's device span and row counters, the
channelizer's dispatch span and its device span (resolved from CUDA
events, here fakes), the same spans as torch.profiler annotations on the
records' clock, nothing made with tracing off, and the bounded buffer
(CPU)."""

import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.core import trace  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.ops.pll_linear import pll_hybrid  # noqa: E402

RATE = 220500.0
PUMP = ("sources.wait", "host.d2h_wait")


class _Collect(tl.SinkBlock):
    def __init__(self):
        super().__init__()
        self.got = []
        self.add_type_signature([tl.Input("in", tl.Float32)], [])

    def process(self, x):
        self.got.append(np.array(x))


def _iq_file(tmp_path, x):
    path = str(tmp_path / "in.iq")
    x.astype(np.complex64).view(np.float32).tofile(path)
    return path


def _fm_graph(tmp_path, n=20000):
    """IQ file -> discriminator -> downsampler -> a host sink."""
    rng = np.random.default_rng(21)
    x = np.exp(1j * np.cumsum(rng.uniform(-0.3, 0.3, n)))
    top = tl.CompositeBlock()
    sink = _Collect()
    top.connect(tl.IQFileSource(_iq_file(tmp_path, x), "f32le", 1e6),
                tl.FrequencyDiscriminatorBlock(5.0), tl.DownsamplerBlock(5),
                sink)
    return top


def _stereo_graph(tmp_path, seconds=0.08):
    """WBFMStereoDemodulator (pilot PLL) over broadcast FM stereo at
    baseband: L a 1 kHz tone, R 400 Hz, pilot 0.1 cos 19 kHz."""
    t = np.arange(int(RATE * seconds)) / RATE
    left = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    right = 0.4 * np.sin(2 * np.pi * 400.0 * t)
    mpx = (left + right) + 0.1 * np.cos(2 * np.pi * 19e3 * t) \
        + (left - right) * np.cos(2 * np.pi * 38e3 * t)
    x = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(mpx) / RATE)
    top = tl.CompositeBlock()
    demod = tl.WBFMStereoDemodulator(pilot="pll")
    top.connect(tl.IQFileSource(_iq_file(tmp_path, x), "f32le", RATE), demod)
    top.connect(demod, "left", _Collect(), "in")
    top.connect(demod, "right", _Collect(), "in")
    return top


def _by(events, **kw):
    return [e for e in events
            if all(getattr(e, k) == v for k, v in kw.items())]


def _one(events, name, chunk):
    got = _by(events, name=name, chunk=chunk)
    assert len(got) == 1, (name, chunk, got)
    return got[0]


def _inside(child, parent):
    return parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


def _parents_hold(events):
    """Every record with a parent lies inside one record of that parent
    on its thread and chunk."""
    for e in events:
        if e.parent is None:
            continue
        assert any(_inside(e, p) for p in _by(
            events, name=e.parent, thread=e.thread, chunk=e.chunk)), e


def test_pipelined_run_joins_every_chunk_on_its_id(tmp_path):
    """Fused and pipelined: each chunk id has one read and one copy on the
    read-ahead thread, one wait, one dispatch a segment, one copy-back wait
    and one host span a stage with host blocks on the pump, and a hold
    (except the last) that contains the next chunk's wait and dispatch and
    the previous chunk's host tail; the aggregates count the records."""
    r = Runner(_fm_graph(tmp_path), chunk_size=4096, trace=True,
               device="cpu")
    assert r.pipelined
    r.run()
    ev = r.tracer.events()
    segs = [f"segment[{i}].dispatch" for i, (seg, _) in
            enumerate(r.stage_plan) if seg is not None]
    hosts = [f"host[{i}].process" for i, (_, hb) in
             enumerate(r.stage_plan) if hb]
    ids = sorted({e.chunk for e in ev if e.name == segs[0]})
    assert ids == list(range(r.chunks_processed)) and len(ids) >= 4
    for k in ids:
        for name in ("sources.read", "sources.h2d"):
            assert _one(ev, name, k).thread == "read-ahead"
        for name in ("sources.wait", "host.d2h_wait", *segs):
            rec = _one(ev, name, k)
            assert rec.thread != "read-ahead" and rec.parent is None
        holds = _by(ev, name="chunk.hold", chunk=k)
        if k == ids[-1]:
            assert holds == []
            continue
        (hold,) = holds
        for name in ("sources.wait", *segs):
            assert _inside(_one(ev, name, k + 1), hold)
        if k:       # and the previous chunk's host tail
            for name in ("host.d2h_wait", *hosts):
                assert _inside(_one(ev, name, k - 1), hold)
    _parents_hold(ev)
    counts = {}
    for e in ev:
        counts[e.name] = counts.get(e.name, 0) + 1
    assert {k: v["count"] for k, v in r.tracer.report().items()} == counts
    # the host tail's span is opened only for stages with host blocks
    assert {e.name for e in ev if e.name.startswith("host[")} == set(hosts)
    for k in ids:
        for name in hosts:
            _one(ev, name, k)


def test_eager_run_reads_on_the_pump(tmp_path):
    """Eager mode: read and copy on the pump, no wait and no hold, a
    copy-back wait once a stage."""
    r = Runner(_fm_graph(tmp_path), mode="eager", chunk_size=4096,
               trace=True, device="cpu")
    r.run()
    ev = r.tracer.events()
    assert {e.thread for e in ev} == {"MainThread"}
    assert not _by(ev, name="sources.wait") and not _by(ev, name="chunk.hold")
    for k in range(r.chunks_processed):
        _one(ev, "sources.h2d", k)
        assert len(_by(ev, name="host.d2h_wait", chunk=k)) \
            == len(r.stage_plan)


def test_pll_host_reads_are_children_of_their_dispatch(tmp_path):
    """Each of pll_hybrid's host reads is one ``pll.host_read`` record,
    inside the PLL's dispatch (``pll.dispatch``, one a chunk) of its
    chunk, itself inside the dispatch of its segment."""
    r = Runner(_stereo_graph(tmp_path), chunk_size=4096, trace=True,
               device="cpu")
    before = pll_hybrid.host_reads
    r.run()
    reads = pll_hybrid.host_reads - before
    ev = r.tracer.events()
    got = _by(ev, name="pll.host_read")
    assert reads >= r.chunks_processed and len(got) == reads
    assert all(e.parent == "pll.dispatch" and e.chunk is not None
               for e in got)
    for k in range(r.chunks_processed):
        assert _one(ev, "pll.dispatch", k).parent.startswith("segment[")
    _parents_hold(ev)
    assert r.tracer.report()["pll.host_read"]["count"] == reads


def test_profiler_annotations_lie_on_the_records_clock(tmp_path):
    """torch.profiler around Runner.run() on this thread (the pump) holds
    each pump span as a user_annotation, within 1 ms of its record mapped
    through ``wall_offset_ns``."""
    r = Runner(_fm_graph(tmp_path), chunk_size=4096, trace=True,
               device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    ann = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ann.setdefault(e["name"], []).append(
                (float(e["ts"]) + base_us, float(e["dur"])))
    ev = r.tracer.events()
    names = {e.name for e in ev if e.thread == "MainThread"} - {"chunk.hold"}
    assert set(PUMP) <= names and names <= set(ann)
    off_us = r.tracer.wall_offset_ns / 1e3
    for name in set(ann) & {e.name for e in ev}:
        recs = sorted(_by(ev, name=name), key=lambda e: e.t0_ns)
        got = sorted(ann[name])
        assert len(got) == len(recs), name
        for (ts, dur), e in zip(got, recs):
            t0 = e.t0_ns / 1e3 + off_us
            t1 = e.t1_ns / 1e3 + off_us
            assert abs(ts - t0) < 1e3 and abs(ts + dur - t1) < 1e3, \
                (name, ts - t0, ts + dur - t1)


def test_tracing_off_makes_no_record(tmp_path, monkeypatch):
    """With tracing off no tracer is made, no record is added and
    ``record_function`` is never entered, the PLL's reads included."""
    def boom(*a, **k):
        raise AssertionError("entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(trace.Tracer, "_add", boom)
    before = pll_hybrid.host_reads
    r = Runner(_stereo_graph(tmp_path), chunk_size=4096, trace=False,
               device="cpu")
    r.run()
    assert r.tracer is None and trace.current() is None
    assert pll_hybrid.host_reads > before and r.chunks_processed > 1


def test_events_stay_at_their_bound():
    """The buffer keeps the newest ``RECORDS``; the aggregates count
    all."""
    t = trace.Tracer()
    n = t.RECORDS + 10
    for i in range(n):
        t.record("x", i, i + 1, chunk=i)
    ev = t.events()
    assert len(ev) == t.RECORDS == 65536
    assert ev[0].chunk == 10 and ev[-1].chunk == n - 1
    assert t.report()["x"]["count"] == n


def test_module_span_follows_the_current_tracer():
    """``trace.span`` is a no-op without a current tracer; with one it
    records a child of the open span, carrying its chunk."""
    assert trace.current() is None
    with trace.span("free"):
        pass
    t = trace.Tracer()
    prev = trace.set_current(t)
    try:
        with t.span("outer", 7) as sp:
            assert sp.chunk == 7
            with trace.span("inner"):
                pass
        t.record("derived", 5, 9)
    finally:
        assert trace.set_current(prev) is t
    assert trace.current() is prev is None
    inner, outer, derived = t.events()
    assert (inner.name, inner.parent, inner.chunk) == ("inner", "outer", 7)
    assert (outer.parent, outer.chunk) == (None, 7)
    assert _inside(inner, outer)
    assert (derived.t0_ns, derived.t1_ns, derived.chunk) == (5, 9, None)
    assert set(t.report()) == {"inner", "outer", "derived"}


def _band_graph(tmp_path, n=8 * 4096):
    """IQ file -> ChannelizerBlock(8) -> discriminator -> a host sink."""
    rng = np.random.default_rng(23)
    x = np.exp(1j * np.cumsum(rng.uniform(-0.3, 0.3, n)))
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(_iq_file(tmp_path, x), "f32le", 8e5),
                tl.ChannelizerBlock(8, 4), tl.FrequencyDiscriminatorBlock(1.0),
                _Collect())
    return top


def test_channelizer_dispatch_once_a_chunk(tmp_path):
    """With a tracer on the CPU: one ``channelizer.dispatch`` a chunk,
    inside its segment's dispatch and of its chunk; no
    ``channelizer.device`` (no card); the rows counter counts C a
    chunk."""
    from luaradio_tpu_torch.blocks.signal.channelizer import ChannelizerBlock
    before = ChannelizerBlock.rows_emitted
    r = Runner(_band_graph(tmp_path), chunk_size=8 * 512, trace=True,
               device="cpu")
    r.run()
    ev = r.tracer.events()
    rep = r.tracer.report()
    assert r.chunks_processed == 8
    assert rep["channelizer.dispatch"]["count"] == r.chunks_processed
    assert "channelizer.device" not in rep
    for k in range(r.chunks_processed):
        rec = _one(ev, "channelizer.dispatch", k)
        assert rec.parent.startswith("segment[")
        assert _inside(rec, _one(ev, rec.parent, k))
    assert ChannelizerBlock.rows_emitted - before == 8 * r.chunks_processed


def test_channelizer_untraced_records_nothing(tmp_path, monkeypatch):
    """With no tracer the channelizer opens no span and makes no device
    span: ``Tracer.device_span`` is never entered."""
    def boom(*a, **k):
        raise AssertionError("entered with tracing off")
    monkeypatch.setattr(trace.Tracer, "device_span", boom)
    monkeypatch.setattr(trace.Tracer, "_add", boom)
    r = Runner(_band_graph(tmp_path), chunk_size=8 * 512, trace=False,
               device="cpu")
    r.run()
    assert r.tracer is None and r.chunks_processed == 8


class _FakeEvent:
    """A CUDA event: recorded on a stream, done when ``done`` is set, the
    time between two events in ms."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.at = False, None

    def record(self, stream=None):
        _FakeEvent.clock += 1.5
        self.at = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.at - self.at


def test_device_span_resolved_after_its_chunk(monkeypatch):
    """A device span's pair of events is kept until ``resolve_device``
    reaches its chunk and its end event is done, then recorded as a child
    of its host span with the events' time; a chunk not yet reached, or
    an end not yet done, stays pending, and reading them never waits."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    t = trace.Tracer()
    cuda = torch.device("cuda")
    pairs = []
    prev = trace.set_current(t)
    try:
        for k in (3, 4):
            with t.span("segment[1].dispatch", k):
                with trace.device_span("a.dispatch", "a.device", cuda):
                    pass
                pairs.append(t._device[-1][3:])
    finally:
        trace.set_current(prev)
    t.resolve_device(3)
    assert "a.device" not in t.report()     # chunk 3's end not yet done
    for start, end in pairs:
        start.done = end.done = True
    t.resolve_device(3)
    assert t.report()["a.device"]["count"] == 1
    t.resolve_device()
    rep = t.report()["a.device"]
    assert rep["count"] == 2 and math.isclose(rep["total_s"], 3e-3)
    recs = _by(t.events(), name="a.device")
    assert [(e.chunk, e.parent) for e in recs] == [(3, "a.dispatch"),
                                                  (4, "a.dispatch")]
    assert all(e.t1_ns - e.t0_ns == 1500000 for e in recs)
    assert t._device == []
    assert _one(t.events(), "a.dispatch", 4).parent == "segment[1].dispatch"


@pytest.mark.parametrize("name", ["Runner", "Prefetcher"])
def test_run_sets_the_current_tracer_on_its_threads(tmp_path, name):
    """``Runner.run`` makes its tracer current on the pump thread (and
    restores the one before); the read-ahead thread makes it current on
    its own."""
    seen = {}
    orig = Runner._read_sources if name == "Prefetcher" else \
        Runner._run_segment

    def spy(self, *a):
        seen.setdefault("t", trace.current())
        return orig(self, *a)
    mp = pytest.MonkeyPatch()
    mp.setattr(Runner, orig.__name__, spy)
    try:
        r = Runner(_fm_graph(tmp_path), chunk_size=4096, trace=True,
                   device="cpu")
        r.run()
    finally:
        mp.undo()
    assert seen["t"] is r.tracer and trace.current() is None


def _am_graph(tmp_path, seconds=0.2, rate=40000.0):
    """AMSynchronousDemodulator over a 1 kHz tone on a carrier 12 Hz off
    the channel's centre, with noise: its carrier PLL leaves the linear
    tier."""
    rng = np.random.default_rng(29)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = (1 + 0.6 * np.cos(2 * np.pi * 1000.0 * t)) \
        * np.exp(1j * (2 * np.pi * 12.0 * t + 0.3)) \
        + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(_iq_file(tmp_path, x), "f32le", rate),
                tl.AMSynchronousDemodulator(0.0, 4500.0), _Collect())
    return top


def test_pll_dispatch_once_a_chunk(tmp_path):
    """With a tracer on the CPU: one ``pll.dispatch`` a chunk, inside its
    segment's dispatch and of its chunk, holding the chunk's
    ``pll.host_read`` records; no ``pll.device`` (no card)."""
    r = Runner(_am_graph(tmp_path), chunk_size=2048, trace=True,
               device="cpu")
    r.run()
    ev = r.tracer.events()
    rep = r.tracer.report()
    assert r.chunks_processed == 4
    assert rep["pll.dispatch"]["count"] == r.chunks_processed
    assert "pll.device" not in rep
    for k in range(r.chunks_processed):
        rec = _one(ev, "pll.dispatch", k)
        assert rec.parent.startswith("segment[")
        assert _inside(rec, _one(ev, rec.parent, k))
        reads = _by(ev, name="pll.host_read", chunk=k)
        assert reads and all(_inside(e, rec) for e in reads)
    _parents_hold(ev)


def test_pll_opens_its_device_span_once_a_chunk(tmp_path, monkeypatch):
    """PLLBlock asks the tracer for the pair ``pll.dispatch`` /
    ``pll.device`` on its input's device once a chunk, and opens nothing
    else of its own."""
    asked = []
    orig = trace.Tracer.device_span

    def spy(self, name, device_name, device):
        asked.append((name, device_name, device.type))
        return orig(self, name, device_name, device)
    monkeypatch.setattr(trace.Tracer, "device_span", spy)
    r = Runner(_am_graph(tmp_path), chunk_size=2048, trace=True,
               device="cpu")
    r.run()
    assert asked == [("pll.dispatch", "pll.device", "cpu")] \
        * r.chunks_processed


def test_pll_untraced_records_nothing(tmp_path, monkeypatch):
    """With no tracer the PLL opens no span and makes no device span; its
    row counters still count."""
    def boom(*a, **k):
        raise AssertionError("entered with tracing off")
    monkeypatch.setattr(trace.Tracer, "device_span", boom)
    monkeypatch.setattr(trace.Tracer, "_add", boom)
    before = pll_hybrid.scan_rows + pll_hybrid.k3_rows
    r = Runner(_am_graph(tmp_path), chunk_size=2048, trace=False,
               device="cpu")
    r.run()
    assert r.tracer is None and r.chunks_processed == 4
    assert pll_hybrid.scan_rows + pll_hybrid.k3_rows > before


def test_pll_row_counters_follow_the_tiers():
    """``pll_hybrid.scan_rows`` and ``k3_rows`` count the row-chunks the
    overlap scan and K3 solved: on a bank of a locked carrier, a weak
    carrier from a cold start, noise and zeros (tiers 1, 2, 3, 3), each
    grows by what ``PLLBlock.tier_counts`` gives its tier."""
    blk = tl.PLLBlock(1e3, 200e3, 220e3)
    blk.device = torch.device("cpu")
    blk.differentiate([tl.ComplexFloat32])
    blk.input_rate = 1e6
    blk.initialize()
    rng = np.random.default_rng(41)
    n = 8192
    t = np.arange(n)
    w = 2 * np.pi * 0.208
    noise = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    x = np.stack([np.exp(1j * (w * t + 0.4)) + 0.01 * noise[0],
                  0.4 * np.exp(1j * (w * t + 1.1)) + 0.4 * noise[1],
                  noise[2], np.zeros(n)]).astype(np.complex64)
    f0 = float((blk._freq_min + blk._freq_max) / 2)
    st = (torch.tensor([0.4, 0.0, 0.0, 0.0]),
          torch.tensor([0.4, 0.0, 0.0, 0.0]),
          torch.tensor([float(np.float32(w)), f0, f0, f0]))
    scan0, k30 = pll_hybrid.scan_rows, pll_hybrid.k3_rows
    for _ in range(2):
        st, _ = blk.process(st, torch.from_numpy(x))
    assert blk.row_tiers == [1, 2, 3, 3]
    assert pll_hybrid.scan_rows - scan0 == blk.tier_counts[2] >= 1
    assert pll_hybrid.k3_rows - k30 == blk.tier_counts[3] >= 2
