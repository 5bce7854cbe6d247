"""The port's public surface against the JAX package's: every exported name
(except the submodule attributes), the positional parameters of every name both export and of
CompositeBlock.run/start, the version names, eager mode (bit for bit the
fused run, both against the JAX package's six-block graph of
tests/core/test_runtime.py:30), the runtime's span tracer and the debug
logger.

Departures the signature check allows, by name: ``device`` (the port's
keyword-only entry-point parameter) and ``ingest`` (left out of the
port's run/start/Runner).  ``mesh``, ``channel_axis`` and ``time_axis``
bind as the JAX package's, on run, start, the Runner and the bank
classes."""

import inspect
import types

import numpy as np
import pytest
import scipy.signal
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.core import debug, trace  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402

#: parameters the port adds (keyword-only) or leaves out, by name
PORT_ONLY = {"device"}
JAX_ONLY = {"ingest"}


def _exported(mod):
    return {n for n in dir(mod) if not n.startswith("__")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_the_port_exports_every_name_of_the_jax_package():
    missing = _exported(jl) - _exported(tl)
    assert not missing, sorted(missing)


def test_version_names_equal_the_jax_package():
    for n in ("version", "_VERSION", "version_info", "version_number",
              "__version__"):
        assert getattr(tl, n) == getattr(jl, n), n


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _callables():
    out = []
    for n in sorted(_exported(jl) & _exported(tl)):
        a, b = getattr(jl, n), getattr(tl, n)
        if not callable(a) or not callable(b):
            continue
        try:
            inspect.signature(a), inspect.signature(b)
        except (TypeError, ValueError):
            continue
        out.append(n)
    return out


@pytest.mark.parametrize("name", _callables())
def test_positional_parameters_match(name):
    """Equal positional parameter names in order: ``use_fft`` on the FIR
    blocks cannot go missing again."""
    a = [p for p in _positional(getattr(jl, name)) if p not in JAX_ONLY]
    b = [p for p in _positional(getattr(tl, name))
         if p not in PORT_ONLY or p in a]     # UHD's own ``device`` stays
    assert a == b


@pytest.mark.parametrize("method", ["run", "start"])
def test_run_and_start_bind_as_the_jax_package(method):
    """``mode`` first, then the JAX package's parameters in its order up to
    ``channels``; ``device`` keyword-only."""
    a = getattr(jl.CompositeBlock, method)
    b = getattr(tl.CompositeBlock, method)
    ja = [p for p in _positional(a) if p not in JAX_ONLY]
    assert _positional(b) == ja
    assert ja[:2] == ["self", "mode"] and "mesh" in ja
    dev = inspect.signature(b).parameters["device"]
    assert dev.kind is dev.KEYWORD_ONLY and dev.default is None


@pytest.mark.parametrize("name", ["core.runtime.Runner",
                                  "parallel.wbfm.WBFMMonoBank",
                                  "parallel.wbfm.WBFMStereoBank",
                                  "parallel.rds.RDSBank"])
def test_runner_and_bank_classes_bind_as_the_jax_package(name):
    """The Runner and the bank classes take the JAX package's positional
    parameters in its order (``mesh`` first on the bank classes);
    ``device`` is keyword-only."""
    import importlib
    path, cls = name.rsplit(".", 1)
    a = getattr(importlib.import_module(f"luaradio_tpu.{path}"), cls)
    b = getattr(importlib.import_module(f"luaradio_tpu_torch.{path}"), cls)
    assert _positional(b) == [p for p in _positional(a)
                              if p not in JAX_ONLY]
    dev = inspect.signature(b).parameters["device"]
    assert dev.kind is dev.KEYWORD_ONLY and dev.default is None


def test_fir_blocks_take_use_fft():
    blk = tl.LowpassFilterBlock(128, 15e3, use_fft=False)
    assert blk.use_fft is False
    for name in ("FIRFilterBlock", "LowpassFilterBlock",
                 "HighpassFilterBlock", "BandpassFilterBlock",
                 "BandstopFilterBlock", "ComplexBandpassFilterBlock",
                 "ComplexBandstopFilterBlock",
                 "RootRaisedCosineFilterBlock"):
        assert "use_fft" in inspect.signature(getattr(tl, name)).parameters


def test_iir_filter_block_runs_at_order_four():
    b, a = scipy.signal.butter(4, 0.1)
    blk = tl.IIRFilterBlock(b, a)
    blk.device = torch.device("cpu")
    blk.differentiate([tl.Float32])
    blk.input_rate = 1e6
    blk.initialize()
    st, y = blk.process(blk.init_state(), torch.ones(256))
    assert st.shape == (4,) and y.shape == (256,)


# -- eager mode ---------------------------------------------------------------

def _write_iq(path, x):
    x.astype(np.complex64).view(np.float32).tofile(path)


def _six_block(mod, f1, f2, fout, taps):
    top = mod.CompositeBlock()
    src1 = mod.IQFileSource(f1, "f32le", 1e6)
    src2 = mod.IQFileSource(f2, "f32le", 1e6)
    mult = mod.MultiplyConjugateBlock()
    fir = mod.FIRFilterBlock(taps, use_fft=False)
    disc = mod.FrequencyDiscriminatorBlock(5.0)
    ds = mod.DownsamplerBlock(5)
    sink = mod.RealFileSink(fout, "f32le")
    top.connect(src1, "out", mult, "in1")
    top.connect(src2, "out", mult, "in2")
    top.connect(mult, fir, disc, ds, sink)
    return top


def _wrap_dist(a, b, period):
    d = np.mod(a.astype(np.float64) - b + period / 2, period) - period / 2
    return float(np.max(np.abs(d)))


@pytest.fixture
def six_block_inputs(tmp_path):
    rng = np.random.default_rng(30)
    n = 50000
    xs = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
          for _ in range(2)]
    paths = [str(tmp_path / f"{k}.iq") for k in "ab"]
    for p, x in zip(paths, xs):
        _write_iq(p, x)
    taps = scipy.signal.firwin(31, 0.4).astype(np.float32)
    return xs, paths, taps


def test_eager_equals_fused_and_the_jax_graph(six_block_inputs, tmp_path):
    """The six-block graph of tests/core/test_runtime.py:30 in both modes:
    eager gives the fused run's file byte for byte, and both equal the
    JAX package's (both modes) and the float64 oracle within 1e-4, the
    JAX test's bound, modulo the discriminator's period 1/5 (an output
    on the branch cut may land on either side)."""
    xs, (f1, f2), taps = six_block_inputs
    outs = {}
    for mode in ("fused", "eager"):
        for mod in (jl, tl):
            fout = str(tmp_path / f"{mod.__name__}.{mode}.f32")
            kw = {"device": "cpu"} if mod is tl else {}
            _six_block(mod, f1, f2, fout, taps).run(mode, chunk_size=8192,
                                                    **kw)
            outs[mod, mode] = open(fout, "rb").read()
    assert outs[tl, "eager"] == outs[tl, "fused"]
    m = xs[0] * np.conj(xs[1])
    filt = scipy.signal.lfilter(taps.astype(np.float64), [1.0], m)
    prev = np.concatenate([[0j], filt[:-1]])
    exp = (np.angle(filt * np.conj(prev)) / (2 * np.pi * 5.0))[::5]
    got = np.frombuffer(outs[tl, "eager"], np.float32)
    assert got.shape == exp.shape
    assert _wrap_dist(got, exp, 0.2) < 1e-4
    for mode in ("fused", "eager"):
        ja = np.frombuffer(outs[jl, mode], np.float32)
        assert _wrap_dist(got, ja, 0.2) < 1e-4


def test_eager_mode_reads_sources_in_the_pump(six_block_inputs, tmp_path):
    """Eager mode starts no read-ahead thread and never pipelines; the
    same graph in fused mode does both."""
    _, (f1, f2), taps = six_block_inputs
    for mode, threaded in (("eager", False), ("fused", True)):
        top = _six_block(tl, f1, f2, str(tmp_path / "o.f32"), taps)
        r = Runner(top, mode=mode, chunk_size=8192, device="cpu")
        assert r.pipelined is threaded
        chunk = r._next_chunk()
        assert chunk is not None
        assert (r._prefetcher is not None) is threaded
        r._cleanup_once()


def test_run_binds_mode_positionally(tmp_path):
    """``run("eager")`` and ``run("fused")`` take the mode, as the JAX
    package's do; an unknown mode raises, and so do a mesh in eager mode
    and a mesh with neither a channel nor a time axis, with the JAX
    package's messages."""
    def graph():
        top = tl.CompositeBlock()
        sink = tl.BenchmarkSink()
        top.connect(tl.ZeroSource(tl.Float32, 1e3), tl.NopBlock(), sink)
        return top, sink
    for mode in ("eager", "fused"):
        top, sink = graph()
        top.run(mode, 3, 1000, device="cpu")
        assert sink.total_count == 3000
    top, _ = graph()
    with pytest.raises(ValueError, match="mode"):
        top.run("bogus", 1, device="cpu")
    from luaradio_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="requires mode='fused'"):
        top.run("eager", 1, mesh=Mesh((2,), ("time",)), device="cpu")
    with pytest.raises(ValueError, match="nothing to shard over"):
        top.run(max_chunks=1, mesh=Mesh((2,), ("beam",)), device="cpu")
    top, sink = graph()
    top.start("eager", 1000, device="cpu")
    top.stop(timeout=30)
    assert top.status()["running"] is False


# -- tracing and debug ------------------------------------------------------------

def test_trace_records_the_four_span_names(six_block_inputs, tmp_path):
    """Runner(trace=True): sources.read, sources.wait (fused: the pump's
    wait on the read-ahead thread), segment[i].dispatch and
    host[i].process, each counted once a chunk; eager mode has no
    sources.wait; with tracing off there is no tracer."""
    _, (f1, f2), taps = six_block_inputs
    for mode in ("fused", "eager"):
        top = _six_block(tl, f1, f2, str(tmp_path / f"{mode}.f32"), taps)
        r = Runner(top, mode=mode, chunk_size=8192, trace=True,
                   device="cpu")
        r.run()
        rep = r.tracer.report()
        names = set(rep)
        assert "sources.read" in names
        assert ("sources.wait" in names) is (mode == "fused")
        assert any(n.startswith("segment[") and n.endswith("].dispatch")
                   for n in names)
        assert any(n.startswith("host[") and n.endswith("].process")
                   for n in names)
        assert rep["sources.read"]["count"] >= r.chunks_processed
        for s in rep.values():
            assert s["count"] > 0 and s["min_s"] <= s["mean_s"] <= s["max_s"]
    top = _six_block(tl, f1, f2, str(tmp_path / "off.f32"), taps)
    assert Runner(top, chunk_size=8192, trace=False, device="cpu").tracer \
        is None


def test_trace_is_enabled_by_the_environment(monkeypatch):
    for value, on in (("1", True), ("0", False), ("", False),
                      ("false", False), ("yes", True)):
        monkeypatch.setenv("LUARADIO_TPU_TRACE", value)
        assert trace.enabled_by_env() is on
    monkeypatch.setenv("LUARADIO_TPU_TRACE", "1")
    top = tl.CompositeBlock()
    top.connect(tl.ZeroSource(tl.Float32, 1e3), tl.BenchmarkSink())
    r = Runner(top, chunk_size=100, device="cpu")
    r.run(max_chunks=2)
    assert r.tracer is not None
    assert any(n.endswith("].dispatch") for n in r.tracer.report())


def test_tracer_counts_spans_from_many_threads():
    """The read-ahead thread and the pump record spans at once: no count
    may be lost (a short switch interval makes a lost update likely
    without the tracer's lock)."""
    import sys
    import threading
    t = trace.Tracer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                with t.span("s"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.report()["s"]["count"] == 16000


def test_debug_logger_is_gated(monkeypatch, capsys):
    monkeypatch.setattr(debug, "enabled", False)
    debug.print_("hidden")
    debug.printf("%s", "hidden")
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(debug, "enabled", True)
    debug.print_("shown", 1)
    debug.printf("%d!", 2)
    assert capsys.readouterr().err == "shown 1\n2!"
