"""Multi-process execution: N processes, joined over gloo by the port's
parallel/multihost.py, run ONE flow graph over a mesh that spans them (the
JAX system's bench_multihost.py, on the port).  Each scenario is held
against its serial run in this process:

* ``wbfm_time`` — the rx_wbfm mono chain with its time axis split over
  every shard of every process: halos and prefix summaries cross
  processes; each process reads the whole file and keeps its block, and
  its sink gets its contiguous block of every chunk (reassembled here);
* ``wbfm_resident`` — the same chain from a repeating file held as a
  device-resident ring, which each process decodes from its own copy;
* ``wbfm_wire`` — the same chain from a u8 I/Q file shipped as raw wire
  bytes and converted on the device;
* ``channel_bank`` — a clock recovery -> sampler -> slicer -> Manchester
  bank on a ("channel",) mesh, each process running the host blocks for
  its own channels;
* ``rds_bank`` — the full RDSReceiver on a ("channel",) mesh, every
  channel's packets equal to its serial run;
* ``overhead`` — the wbfm chain on 4 time shards, one process against two
  processes of two shards: the steady-state pump time's added fraction.

    python -m luaradio_tpu_torch.benchmarks.bench_multihost [--out PATH]

Workers are this module run as ``--worker RANK DIR`` (a job file in DIR),
meeting through a file under DIR; they are joined with a hard limit and
killed past it.  On one card every process shares it (gloo stages the
halos and summaries through host memory): this shows the mechanics, not a
link between hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import luaradio_tpu_torch as lr
from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.blocks.protocol import rds as rds_proto
from luaradio_tpu_torch.core.runtime import Runner
from luaradio_tpu_torch.parallel import multihost
from luaradio_tpu_torch.parallel.mesh import Mesh
from luaradio_tpu_torch.types import number_to_bits

CHUNK = 1 << 14
N_CHUNKS = 4
DECIM = 8
TIMED_CHUNKS = 16
RDS_RATE = 228e3
SCENARIOS = ("wbfm_time", "wbfm_resident", "wbfm_wire", "channel_bank",
             "rds_bank", "overhead")
WORKER_TIMEOUT = 600.0
_ROOT = Path(__file__).resolve().parents[2]


class _Collect(lr.SinkBlock):
    """Keeps each call's input on the host: an array, or a channel's list
    of packets as JSON."""

    def __init__(self):
        super().__init__()
        self.got = []
        self.add_type_signature([lr.Input("in", lambda t: True)], [])

    def process(self, x):
        self.got.append([p.to_json() for p in x] if isinstance(x, list)
                        else np.array(x))


# -- graphs and inputs --------------------------------------------------------

def wbfm_chain(src, sink) -> lr.CompositeBlock:
    top = lr.CompositeBlock()
    top.connect(src, lr.FrequencyTranslatorBlock(-50e3),
                lr.LowpassFilterBlock(64, 100e3, use_fft=False),
                lr.FrequencyDiscriminatorBlock(1.25),
                lr.FMDeemphasisFilterBlock(75e-6),
                lr.DownsamplerBlock(DECIM), sink)
    return top


def bit_bank(src, sink) -> lr.CompositeBlock:
    top = lr.CompositeBlock()
    zccr, sampler = lr.ZeroCrossingClockRecoveryBlock(1.0), lr.SamplerBlock()
    top.connect(src, zccr)
    top.connect(src, "out", sampler, "data")
    top.connect(zccr, "out", sampler, "clock")
    top.connect(sampler, lr.SlicerBlock(), lr.ManchesterDecoderBlock(), sink)
    return top


def rds_graph(src, sink) -> lr.CompositeBlock:
    top = lr.CompositeBlock()
    top.connect(src, lr.RDSReceiver(), sink)
    return top


def _fm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.exp(1j * 0.3 * np.cumsum(rng.standard_normal(n))).astype(
        np.complex64)


def rds_group_bits(blocks4) -> np.ndarray:
    """Four 16-bit words -> the 104 bits of an RDS group, each word with
    its check word and offset word."""
    return np.concatenate([number_to_bits(
        (data << 10) | (rds_proto._poly_mod(data << 10, 26)
                        ^ rds_proto.RDS_OFFSET_WORDS[name]), 26)
        for name, data in zip("ABCD", blocks4)])


def make_rds_fm(n: int, groups, rate: float = RDS_RATE) -> np.ndarray:
    """FM of an MPX baseband at ``rate``: an 800 Hz tone, the 19 kHz pilot
    and the RDS groups as differential Manchester BPSK on 57 kHz."""
    bits = np.concatenate([rds_group_bits(g) for g in groups])
    diff = np.bitwise_xor.accumulate(bits.astype(np.uint8))
    chips = np.empty(2 * len(diff), np.uint8)
    chips[0::2], chips[1::2] = diff, 1 - diff
    t = np.arange(n) / rate
    k = np.minimum((t * 1187.5 * 2).astype(int), len(chips) - 1)
    mpx = (0.2 * np.sin(2 * np.pi * 800.0 * t)
           + 0.1 * np.cos(2 * np.pi * 19e3 * t)
           + 0.06 * (2.0 * chips[k] - 1.0) * np.cos(3 * 2 * np.pi * 19e3 * t))
    return np.exp(1j * 2 * np.pi * np.cumsum(mpx)).astype(np.complex64)


def _inputs(name: str, d: Path, channels: int):
    if name == "wbfm_time":
        _fm(CHUNK * N_CHUNKS, 11).tofile(d / "x.iq")
    elif name == "wbfm_resident":
        _fm(CHUNK, 13).tofile(d / "x_res.iq")
    elif name == "wbfm_wire":
        np.random.default_rng(17).integers(0, 256, 2 * CHUNK * N_CHUNKS
                                           ).astype(np.uint8).tofile(
            d / "x_u8.iq")
    elif name == "channel_bank":
        rng = np.random.default_rng(7)
        n = 2 * CHUNK
        for c in range(channels):
            bits = rng.integers(0, 2, n // 16)
            (np.repeat(bits * 2.0 - 1.0, 16) + 0.01 * rng.standard_normal(
                n)).astype(np.float32).tofile(d / f"c{c}.f32")
    elif name == "rds_bank":
        rng = np.random.default_rng(23)
        for c in range(channels):
            groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
                      for _ in range(4)]
            make_rds_fm(6 * CHUNK, groups).tofile(d / f"rds{c}.iq")
    elif name == "overhead":
        _fm(CHUNK, 29).tofile(d / "x_timed.iq")


def _wbfm_source(name: str, d: Path):
    if name == "wbfm_time":
        return lr.IQFileSource(str(d / "x.iq"), "f32le", 256e3)
    if name == "wbfm_resident":
        return lr.IQFileSource(str(d / "x_res.iq"), "f32le", 256e3,
                               repeat_on_eof=True, resident=True)
    if name == "wbfm_wire":
        return lr.IQFileSource(str(d / "x_u8.iq"), "u8", 256e3)
    return lr.IQFileSource(str(d / "x_timed.iq"), "f32le", 256e3,
                           repeat_on_eof=True)


def _bank_source(name: str, d: Path, chans):
    if name == "channel_bank":
        return [lr.RealFileSource(str(d / f"c{c}.f32"), "f32le", 16.0)
                for c in chans]
    return [lr.IQFileSource(str(d / f"rds{c}.iq"), "f32le", RDS_RATE)
            for c in chans]


def _bank_graph(name, src, sink):
    return (bit_bank if name == "channel_bank" else rds_graph)(src, sink)


def _run_scenario(name: str, d: Path, mesh, dev):
    """One scenario's graph on ``mesh`` (None: serially): what its sink
    got (for a bank, (this process's channel range, its calls))."""
    sink = _Collect()
    if name.startswith("wbfm"):
        r = Runner(wbfm_chain(_wbfm_source(name, d), sink), chunk_size=CHUNK,
                   mesh=mesh, device=dev)
        route = {"wbfm_resident": "resident", "wbfm_wire": "wire"}.get(name)
        if route and r.feeds[0].route != route:
            raise RuntimeError(f"{name}: the {route} route is off")
        r.run(max_chunks=N_CHUNKS)
        return sink.got
    channels = mesh.shape["channel"]
    src = lr.BankSource(_bank_source(name, d, range(channels)))
    r = Runner(_bank_graph(name, src, sink), chunk_size=CHUNK, mesh=mesh,
               device=dev)
    r.run()
    return r._chan_local, sink.got


def _serial(name: str, d: Path, channels: int, dev):
    """The scenario's serial run in this process: the audio, or each
    channel's outputs run alone."""
    if name.startswith("wbfm"):
        return np.concatenate(_run_scenario(name, d, None, dev))
    refs = []
    for c in range(channels):
        sink = _Collect()
        src = _bank_source(name, d, [c])[0]
        Runner(_bank_graph(name, src, sink), chunk_size=CHUNK,
               device=dev).run()
        refs.append(_flat(name, sink.got))
    return refs


def _flat(name, calls):
    if name == "rds_bank":
        return [p for call in calls for p in call]
    return (np.concatenate([np.asarray(c).reshape(-1) for c in calls])
            if calls else np.zeros(0, np.uint8))


def _timed_pump(d: Path, mesh, dev, chunks: int = TIMED_CHUNKS) -> float:
    """Seconds of ``chunks`` chunks of the wbfm chain on ``mesh`` after a
    warm-up chunk, ended by a synchronize."""
    r = Runner(wbfm_chain(_wbfm_source("overhead", d),
                          lr.BenchmarkSink(report_period=1e9)),
               chunk_size=CHUNK, mesh=mesh, device=dev)
    try:
        r._pump_once()
        common.sync(dev)

        def pump():
            for _ in range(chunks):
                r._pump_once()
        return common.timed(pump, dev)
    finally:
        r._cleanup_once()


# -- the worker ---------------------------------------------------------------

def worker(rank: int, d: str) -> None:
    """One process: join the group through a file under ``d``, run each
    scenario of ``d``/job.json on the process-spanning mesh, and write
    what its sinks got to ``d``/rank<RANK>.pkl."""
    d = Path(d)
    job = json.loads((d / "job.json").read_text())
    dev = torch.device(job["device"])
    nproc, n = job["nproc"], job["nproc"] * job["shards_per_process"]
    group = multihost.initialize(f"file://{d / 'rendezvous'}", nproc, rank)
    out = {}
    for name in job["scenarios"]:
        if name == "overhead":
            out[name] = _timed_pump(d, Mesh((n,), ("time",), group=group),
                                    dev)
        elif name.startswith("wbfm"):
            out[name] = _run_scenario(name, d, Mesh((n,), ("time",),
                                                    group=group), dev)
        else:
            out[name] = _run_scenario(name, d, Mesh((n,), ("channel",),
                                                    group=group), dev)
    with open(d / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def spawn(d: Path, scenarios, nproc: int, shards_per_process: int, dev,
          timeout: float = WORKER_TIMEOUT) -> list:
    """Run ``scenarios`` in ``nproc`` worker processes; returns each
    rank's results.  Raises with the workers' output if one fails, and
    kills them all past ``timeout`` seconds."""
    (d / "job.json").write_text(json.dumps({
        "scenarios": list(scenarios), "nproc": nproc,
        "shards_per_process": shards_per_process, "device": str(dev)}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "luaradio_tpu_torch.benchmarks.bench_multihost",
         "--worker", str(r), str(d)], cwd=_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(nproc)]
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"multihost workers still running after "
                           f"{timeout} s: killed")
    if any(p.returncode for p in procs):
        raise RuntimeError(
            f"multihost workers exited {[p.returncode for p in procs]}:\n"
            + b"\n".join(lg[-3000:] for lg in logs).decode(errors="replace"))
    res = []
    for r in range(nproc):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# -- the parent ---------------------------------------------------------------

def _check(name, res, ref, nproc, spp) -> dict:
    rec = {"scenario": name, "n_processes": nproc,
           "shards_per_process": spp}
    if name.startswith("wbfm"):
        blocks = [r[name] for r in res]
        got = np.concatenate([b[i] for i in range(len(blocks[0]))
                              for b in blocks])
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: {got.shape} vs serial "
                                 f"{ref.shape}")
        err = float(np.max(np.abs(got - ref)))
        if err > 1e-5:
            raise AssertionError(f"{name}: max |multihost - serial| {err}")
        return dict(rec, time_shards=nproc * spp, samples=len(ref) * DECIM,
                    max_abs_err_vs_serial=err, ok=True)
    checked = outputs = 0
    for r in res:
        (lo, hi), calls = r[name]
        nloc = hi - lo
        if nloc != spp:
            raise AssertionError(f"{name}: channels {lo}-{hi} in a process")
        for cl in range(nloc):
            got = _flat(name, calls[cl::nloc])
            same = (got == ref[lo + cl] if name == "rds_bank"
                    else np.array_equal(got, ref[lo + cl]))
            if not same or len(got) < 3:
                raise AssertionError(f"{name}: channel {lo + cl}: {len(got)} "
                                     f"outputs, not its serial run's "
                                     f"{len(ref[lo + cl])}")
            checked += 1
            outputs += len(got)
    return dict(rec, channels=len(ref), channels_matching_serial=checked,
                outputs=outputs, ok=checked == len(ref))


def run(scenarios=SCENARIOS, tmpdir=None, nproc: int = 2,
        shards_per_process: int = 2, device=None) -> list:
    """Each of ``scenarios`` over ``nproc`` processes of
    ``shards_per_process`` shards or channels, all in one spawn, each
    held against its serial run (the overhead scenario: against one
    process holding every shard).  Returns one record a scenario."""
    dev, info = common.setup(device)
    with tempfile.TemporaryDirectory(prefix="multihost_",
                                     dir=tmpdir) as tmp:
        d = Path(tmp)
        n = nproc * shards_per_process
        refs = {}
        for name in scenarios:
            _inputs(name, d, n)
            if name == "overhead":
                refs[name] = _timed_pump(d, Mesh((n,), ("time",)), dev)
            else:
                refs[name] = _serial(name, d, n, dev)
        t0 = time.monotonic()
        res = spawn(d, scenarios, nproc, shards_per_process, dev)
        wall = time.monotonic() - t0
    out = []
    for name in scenarios:
        if name == "overhead":
            multi = max(r[name] for r in res)
            rec = {"scenario": "overhead_vs_single_process",
                   "time_shards": n, "steady_state_chunks": TIMED_CHUNKS,
                   "chunk_size": CHUNK,
                   "single_process_seconds": refs[name],
                   "multi_process_seconds": multi, "n_processes": nproc,
                   "overhead_vs_single": multi / refs[name] - 1.0, "ok": True}
        else:
            rec = _check(name, res, refs[name], nproc, shards_per_process)
        rec.update(device=info["device"], power_limit_w=info["power_limit_w"],
                   spawn_wall_s=wall)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "DIR"))
    args = ap.parse_args(argv)
    if args.worker:
        worker(int(args.worker[0]), args.worker[1])
        return 0
    results = run()
    results += run(("wbfm_time",), nproc=4, shards_per_process=1)
    out = {"ok": all(r["ok"] for r in results),
           "transport": "gloo between processes on one host",
           "results": results}
    common.emit(out, args.out, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
