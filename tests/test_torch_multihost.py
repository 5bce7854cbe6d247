"""Multi-process execution of the port (parallel/multihost.py,
parallel/mesh.py, core/runtime.py): two real processes joined over gloo,
each holding two stacked time shards or two channel rows, against the
port's serial run and the JAX package's 4-device CPU mesh in this process.

The worker group starts once for the module (a FileStore rendezvous under
the test's temporary directory, one thread each) and runs every scenario
in turn, writing its sinks' per-chunk blocks; each worker is joined with a
hard timeout and killed when it runs out, so a hung rendezvous fails here
instead of stalling the suite.  Scenarios, as the JAX package's
tests/parallel/test_multihost.py and bench_multihost.py:

* time, on a ("time",) mesh of 4 spanning both processes: the mono chain
  from an f32 file, from a u8 file (raw wire items, converted on the
  device) and from a device-resident ring; each process's sink gets its
  contiguous block of every chunk, and the blocks reassembled must equal
  the port's serial run within 1e-5 (the JAX test's bound) and the JAX
  package's 4-device time mesh within 3e-5 * scale (tests/
  test_torch_time_runner.py's bound between the packages);
* a mid-graph host block under that mesh raises, with the JAX package's
  guidance;
* channel, on a ("channel",) mesh of 4 rows, two a process: the clock
  recovery -> sampler -> slicer -> Manchester bank (host clones for the
  local channels only) and the full RDSReceiver bank; every channel's
  output equals its serial run and the JAX package's channel mesh
  exactly;
* a bank of four u8 files (raw wire items of all rows in one array,
  converted on the device) on that channel mesh and on a ("time",
  "channel") mesh whose time axis spans both processes: each process's
  rows, or its block of every row, equal the serial bank run within 1e-5.

Run as a script, this file is one worker: ``python
tests/test_torch_multihost.py RANK DIR``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.parallel import multihost  # noqa: E402
from luaradio_tpu_torch.parallel.mesh import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NPROC, SHARDS = 2, 4
CHUNK, N_CHUNKS, DECIM = 1 << 14, 4, 8
CHANNELS = 4
WORKER_TIMEOUT = 240.0


def _collector(mod):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            self.got.append([p.to_json() for p in x]
                            if isinstance(x, list) else np.array(x))
    return Collect()


def _chain(mod, src, sink):
    """The rx_wbfm mono chain of bench_multihost.py."""
    top = mod.CompositeBlock()
    top.connect(src, mod.FrequencyTranslatorBlock(-50e3),
                mod.LowpassFilterBlock(64, 100e3, use_fft=False),
                mod.FrequencyDiscriminatorBlock(1.25),
                mod.FMDeemphasisFilterBlock(75e-6),
                mod.DownsamplerBlock(DECIM), sink)
    return top


def _time_source(mod, d, kind):
    if kind == "f32":
        return mod.IQFileSource(str(d / "x.iq"), "f32le", 256e3)
    if kind == "u8":
        return mod.IQFileSource(str(d / "x.u8"), "u8", 256e3)
    return mod.IQFileSource(str(d / "x.iq"), "f32le", 256e3,
                            repeat_on_eof=True, resident=True)


def _bit_bank(mod, src, sink):
    top = mod.CompositeBlock()
    zccr, sampler = mod.ZeroCrossingClockRecoveryBlock(1.0), \
        mod.SamplerBlock()
    top.connect(src, zccr)
    top.connect(src, "out", sampler, "data")
    top.connect(zccr, "out", sampler, "clock")
    top.connect(sampler, mod.SlicerBlock(), mod.ManchesterDecoderBlock(),
                sink)
    return top


def _bank_source(mod, d, kind, chans):
    if kind == "bits":
        return [mod.RealFileSource(str(d / f"c{c}.f32"), "f32le", 16.0)
                for c in chans]
    return [mod.IQFileSource(str(d / f"rds{c}.iq"), "f32le", 228e3)
            for c in chans]


def _bank_graph(mod, kind, src, sink):
    if kind == "bits":
        return _bit_bank(mod, src, sink)
    top = mod.CompositeBlock()
    top.connect(src, mod.RDSReceiver(), sink)
    return top


def _u8_bank(mod, d):
    return mod.BankSource([mod.IQFileSource(str(d / f"b{c}.u8"), "u8", 256e3)
                           for c in range(CHANNELS)])


def _u8_bank_meshes(group):
    return (("u8bank_channel", Mesh((CHANNELS,), ("channel",), group=group)),
            ("u8bank_time", Mesh((SHARDS, CHANNELS), ("time", "channel"),
                                 group=group)))


# -- the worker ---------------------------------------------------------------

def _worker(rank: int, d: Path):
    group = multihost.initialize(f"file://{d / 'rendezvous'}", NPROC, rank)
    out = {}
    time_mesh = Mesh((SHARDS,), ("time",), group=group)
    assert multihost.is_multihost(time_mesh)
    for kind in ("f32", "u8", "resident"):
        sink = _collector(tl)
        r = Runner(_chain(tl, _time_source(tl, d, kind), sink),
                   chunk_size=CHUNK, mesh=time_mesh, device="cpu")
        out[kind + "_ingest"] = (r.feeds[0].route == "wire",
                                 r.feeds[0].route == "resident")
        r.run(max_chunks=N_CHUNKS)
        out[kind] = sink.got
    top = tl.CompositeBlock()
    top.connect(_time_source(tl, d, "f32"), tl.ThrottleBlock(),
                tl.FrequencyDiscriminatorBlock(1.25), tl.NopSink())
    try:
        Runner(top, chunk_size=CHUNK, mesh=time_mesh, device="cpu")
        out["guard"] = None
    except NotImplementedError as exc:
        out["guard"] = str(exc)

    chan_mesh = Mesh((CHANNELS,), ("channel",), group=group)
    for kind in ("bits", "rds"):
        sink = _collector(tl)
        src = tl.BankSource(_bank_source(tl, d, kind, range(CHANNELS)))
        r = Runner(_bank_graph(tl, kind, src, sink), chunk_size=CHUNK,
                   mesh=chan_mesh, device="cpu")
        r.run()
        out[kind] = (r._chan_local, sink.got)
    for name, mesh in _u8_bank_meshes(group):
        sink = _collector(tl)
        r = Runner(_chain(tl, _u8_bank(tl, d), sink), chunk_size=CHUNK,
                   mesh=mesh, device="cpu")
        wire = r.feeds[0].route == "wire"
        r.run()
        out[name] = (wire, r._chan_local, sink.got)
    with open(d / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


# -- the parent ---------------------------------------------------------------

def _inputs(d: Path):
    rng = np.random.default_rng(11)
    n = CHUNK * N_CHUNKS
    x = np.exp(1j * 0.3 * np.cumsum(rng.standard_normal(n))).astype(
        np.complex64)
    x.tofile(d / "x.iq")
    w = np.round(x.view(np.float32) * 127.5 + 127.5)
    np.clip(w, 0, 255).astype(np.uint8).tofile(d / "x.u8")
    for c in range(CHANNELS):
        bits = rng.integers(0, 2, 2 * CHUNK // 16)
        data = (np.repeat(bits * 2.0 - 1.0, 16)
                + 0.01 * rng.standard_normal(2 * CHUNK)).astype(np.float32)
        data.tofile(d / f"c{c}.f32")
    from tests.parallel.test_rds_bank import make_rds_fm
    for c in range(CHANNELS):
        groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
                  for _ in range(4)]
        make_rds_fm(6 * CHUNK, groups).astype(np.complex64).tofile(
            d / f"rds{c}.iq")
    brng = np.random.default_rng(12)
    for c in range(CHANNELS):
        b = np.exp(1j * 0.3 * np.cumsum(brng.standard_normal(n)))
        w = np.round(b.astype(np.complex64).view(np.float32) * 127.5 + 127.5)
        np.clip(w, 0, 255).astype(np.uint8).tofile(d / f"b{c}.u8")


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Start the two workers once, join them with a hard timeout, and
    return (directory, [each rank's results])."""
    d = tmp_path_factory.mktemp("multihost")
    _inputs(d)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(d)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(NPROC)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"multihost workers still running after "
                    f"{WORKER_TIMEOUT} s: killed")
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * NPROC, b"\n".join(
        lg[-3000:] for lg in logs).decode(errors="replace")
    res = []
    for r in range(NPROC):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return d, res


def _serial(kind, d, mod=tl, mesh=None):
    """The mono chain's audio, serially (or, for the JAX package, on a
    4-device time mesh)."""
    sink = _collector(mod)
    top = _chain(mod, _time_source(mod, d, kind), sink)
    if mod is tl:
        Runner(top, chunk_size=CHUNK, device="cpu").run(max_chunks=N_CHUNKS)
    else:
        from luaradio_tpu.core.runtime import Runner as JaxRunner
        JaxRunner(top, mode="fused", chunk_size=CHUNK,
                  mesh=mesh).run(max_chunks=N_CHUNKS)
    return np.concatenate(sink.got)


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh as JaxMesh
    return JaxMesh(np.asarray(jax.devices("cpu")[:int(np.prod(shape))])
                   .reshape(shape), names)


@pytest.mark.parametrize("kind", ["f32", "u8", "resident"])
def test_time_split_over_two_processes_equals_serial(workers, kind):
    d, res = workers
    ingest = {"f32": (False, False), "u8": (True, False),
              "resident": (False, True)}[kind]
    assert all(r[kind + "_ingest"] == ingest for r in res)
    # each process's sink received its contiguous block of every chunk
    lchunk = CHUNK // DECIM // NPROC
    for r in res:
        assert [len(g) for g in r[kind]] == [lchunk] * N_CHUNKS
    got = np.concatenate([res[p][kind][i] for i in range(N_CHUNKS)
                          for p in range(NPROC)])
    ref = _serial(kind, d)
    assert got.shape == ref.shape == (N_CHUNKS * CHUNK // DECIM,)
    assert float(np.max(np.abs(got - ref))) < 1e-5
    import luaradio_tpu as jl
    jax_ref = _serial(kind, d, jl, _jax_mesh((SHARDS,), ("time",)))
    scale = max(1.0, float(np.max(np.abs(jax_ref))))
    assert float(np.max(np.abs(got - jax_ref))) < 3e-5 * scale


def test_mid_graph_host_block_under_a_process_time_split_raises(workers):
    _, res = workers
    for r in res:
        assert r["guard"] is not None
        assert "needs the global stream on one host" in r["guard"]


def _bank_refs(kind, d):
    """Each channel's serial output (port), and the JAX package's run on
    a 4-device ("channel",) mesh, as per-channel lists of per-chunk
    outputs."""
    refs = []
    for c in range(CHANNELS):
        sink = _collector(tl)
        src = _bank_source(tl, d, kind, [c])[0]
        Runner(_bank_graph(tl, kind, src, sink), chunk_size=CHUNK,
               device="cpu").run()
        refs.append(sink.got)
    import luaradio_tpu as jl
    from luaradio_tpu.core.runtime import Runner as JaxRunner
    sink = _collector(jl)
    src = jl.BankSource(_bank_source(jl, d, kind, range(CHANNELS)))
    JaxRunner(_bank_graph(jl, kind, src, sink), mode="fused",
              chunk_size=CHUNK, mesh=_jax_mesh((CHANNELS,), ("channel",)),
              channels=CHANNELS).run()
    jax_rows = [sink.got[c::CHANNELS] for c in range(CHANNELS)]
    return refs, jax_rows


def _flat(calls):
    out = []
    for g in calls:
        out.extend(g if isinstance(g, list) else np.asarray(g).tolist())
    return out


@pytest.mark.parametrize("kind", ["bits", "rds"])
def test_channel_split_over_two_processes_equals_serial(workers, kind):
    """Each process runs its two channels (host clones for those only);
    every channel's output equals its serial run and the JAX package's
    channel mesh."""
    d, res = workers
    refs, jax_rows = _bank_refs(kind, d)
    seen = []
    for p, r in enumerate(res):
        (lo, hi), got = r[kind]
        assert (lo, hi) == (2 * p, 2 * p + 2)
        for i, c in enumerate(range(lo, hi)):
            mine = _flat(got[i::hi - lo])
            assert mine == _flat(refs[c]) == _flat(jax_rows[c])
            seen.append(c)
    assert seen == list(range(CHANNELS))
    if kind == "rds":
        assert all(len(_flat(refs[c])) >= 3 for c in range(CHANNELS))
    else:
        assert all(len(_flat(refs[c])) >= 100 for c in range(CHANNELS))


@pytest.mark.parametrize("name", ["u8bank_channel", "u8bank_time"])
def test_u8_bank_split_over_two_processes_equals_serial(workers, name):
    """A u8 bank takes wire ingest across processes too: over channels
    each process converts and runs its two rows, over time its half of
    every row's chunk; reassembled, the rows equal the serial bank run
    within 1e-5 (the time split's bound above)."""
    d, res = workers
    sink = _collector(tl)
    r = Runner(_chain(tl, _u8_bank(tl, d), sink), chunk_size=CHUNK,
               channels=CHANNELS, device="cpu")
    assert r.feeds[0].route == "wire"
    r.run()
    ref = np.concatenate(sink.got, axis=-1)
    assert ref.shape == (CHANNELS, N_CHUNKS * CHUNK // DECIM)
    blocks = []
    for p, out in enumerate(res):
        wire, (lo, hi), got = out[name]
        assert wire
        if name == "u8bank_channel":
            assert (lo, hi) == (2 * p, 2 * p + 2)
        else:
            assert (lo, hi) == (0, CHANNELS)
        blocks.append(np.concatenate(got, axis=-1))
    if name == "u8bank_channel":
        got = np.concatenate(blocks, axis=0)
    else:   # each process's half of every chunk, chunk by chunk
        half = CHUNK // DECIM // NPROC
        got = np.concatenate([b[:, i * half:(i + 1) * half]
                              for i in range(N_CHUNKS) for b in blocks],
                             axis=-1)
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) < 1e-5


def test_a_single_process_mesh_is_not_multihost():
    """The guards arm only across processes: a mesh without a process
    group is not multihost, and its local ranges are the whole axes."""
    mesh = Mesh((SHARDS,), ("time",))
    assert multihost.is_multihost(mesh) is False
    assert multihost.is_multihost(None) is False
    assert multihost.local_slices(mesh, (3, 16), (None, "time")) == (
        slice(0, 3), slice(0, 16))
    x = np.arange(32).reshape(2, 16)
    block, start = multihost.local_block(mesh, x, (None, "time"))
    assert start == 0 and np.array_equal(block, x)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
