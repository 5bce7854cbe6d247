"""The reference's per-block benchmark on the card (the JAX system's
bench_blocks.py, on the port): each row times ``source -> block under
test -> BenchmarkSink`` through the Runner and reports samples/s at the
block's output, beside the reference's published i5-4570T figure
(BASELINE.md).

    python -m luaradio_tpu_torch.benchmarks.bench_blocks [--out PATH]
        [--only SUBSTR] [--duration SECONDS]

One JSON object a row on standard output; ``--out`` also writes the rows
and their geometric mean against the baseline to PATH.  Method: one
warm-up chunk, then trials of k chunks (k doubled while a trial takes
under 50 ms), each ended by a synchronize, for about ``--duration``
seconds; the best trial's rate, as the reference takes the best of its
trials.  The streamed file rows carry the pageable host-to-device copy
rate measured right after them (``h2d_pageable_MBps``) and the share of
it their wire takes (``fraction_of_h2d``), in place of the JAX script's
link ceiling.

Device rows are fed by UniformRandomSource, not NullSource (bench_blocks
.py:81-86): a zeros input can be folded away.  :data:`OPTIMIZE_OFF` names
the rows the optimizer rewrites (the IIR filters into FIRs, the five FIRs
into one), which chip_smoke.py also runs with ``optimize=False``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import luaradio_tpu_torch as lr
from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.core.composite import PortRef
from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.core.runtime import Runner

CHUNK = 1 << 22
#: rows whose 2^22-sample chunk is done in microseconds run longer
#: chunks, so the row measures the block and not the dispatch
CHUNK_OVERRIDES = {
    "Null Source (Complex)": 1 << 24, "Null Source (Real)": 1 << 24,
    "Downsampler (M = 5), Complex": 5 << 22,
    "Downsampler (M = 5), Real": 5 << 22,
    "Zero Crossing Clock Recovery": 1 << 23,
    "Upsampler (L = 3), Complex": 1 << 23, "Upsampler (L = 3), Real": 1 << 23,
}
#: the file rows' samples (large enough not to end inside a trial)
N_FILE = 4 << 20
FIVE_FIR = "Five Back to Back FIR Filters (FFT, 256 Real taps, Complex input)"
OPTIMIZE_OFF = (FIVE_FIR, "IIR Filter (5 ff 3 fb Real taps, Complex input)",
                "IIR Filter (5 ff 3 fb Real taps, Real input)")
#: the streamed file rows' wire bytes a sample
WIRE_BYTES = {"IQ File Source (f32le)": 8, "Real File Source (f32le)": 4,
              "Raw File Source (float)": 4,
              "IQ File Source (u8, device-side conversion)": 2}


def file_paths(tmp: str) -> dict:
    """The file rows' fixtures in ``tmp``: complex f32 ("iq"), real f32
    ("f32") and u8 I/Q ("u8")."""
    return {k: os.path.join(tmp, f"blocks.{k}") for k in ("iq", "f32", "u8")}


def write_files(tmp: str, n: int = N_FILE, seed: int = 12345) -> dict:
    rng = np.random.default_rng(seed)
    paths = file_paths(tmp)
    (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64).tofile(paths["iq"])
    rng.standard_normal(n).astype(np.float32).tofile(paths["f32"])
    rng.integers(0, 256, 2 * n).astype(np.uint8).tofile(paths["u8"])
    return paths


def benchmarks(tmp: str, n_file: int = N_FILE) -> list:
    """The rows of bench_blocks.py:74-310, built from the port: (name,
    the reference's i5-4570T rate in M samples/s or None, build() ->
    (top, block under test)), in the JAX list's order.  The file rows'
    fixtures are written to ``tmp``."""
    rng = np.random.default_rng(12345)
    c64, f32, rate = lr.ComplexFloat32, lr.Float32, 1e6

    def sink():
        return lr.BenchmarkSink(report_period=1e9)

    def rand_c():
        return lr.UniformRandomSource(c64, rate)

    def rand_f():
        return lr.UniformRandomSource(f32, rate)

    def simple(mk_src, mk_blk):
        def build():
            top, blk = lr.CompositeBlock(), mk_blk()
            top.connect(mk_src(), blk, sink())
            return top, blk
        return build

    def two_in(mk_src, mk_blk, names=("in1", "in2")):
        def build():
            top, blk = lr.CompositeBlock(), mk_blk()
            top.connect(mk_src(), "out", blk, names[0])
            top.connect(mk_src(), "out", blk, names[1])
            top.connect(blk, sink())
            return top, blk
        return build

    def pll_acquire():
        top, blk = lr.CompositeBlock(), lr.PLLBlock(1e3, 200e3, 220e3)
        add, scale = lr.AddBlock(), lr.MultiplyConstantBlock(0.8)
        top.connect(lr.SignalSource("exponential", 210e3, rate), "out", add,
                    "in1")
        top.connect(rand_c(), scale)
        top.connect(scale, "out", add, "in2")
        top.connect(add, blk, sink())
        return top, blk

    taps16 = rng.standard_normal(16).astype(np.float32)
    taps128 = rng.standard_normal(128).astype(np.float32)
    taps256 = rng.standard_normal(256).astype(np.float32)
    taps16c = (rng.standard_normal(16) + 1j * rng.standard_normal(16)
               ).astype(np.complex64)
    taps128c = (rng.standard_normal(128) + 1j * rng.standard_normal(128)
                ).astype(np.complex64)

    def five_fir():
        top = lr.CompositeBlock()
        blocks = [lr.FIRFilterBlock(taps256, use_fft=True) for _ in range(5)]
        top.connect(rand_c(), *blocks, sink())
        return top, blocks[-1]

    def nop(mk_src):
        return simple(mk_src, lr.NopBlock)

    def iir():
        return lr.IIRFilterBlock(np.float32([0.2] * 5),
                                 np.float32([1.0, 0.1, 0.05]))

    paths = write_files(tmp, n_file)
    return [
        (FIVE_FIR, 42.6, five_fir),
        ("IQ File Source (f32le)", 280.1, nop(lambda: lr.IQFileSource(
            paths["iq"], "f32le", rate, repeat_on_eof=True, resident=False))),
        ("Real File Source (f32le)", 506.4, nop(lambda: lr.RealFileSource(
            paths["f32"], "f32le", rate, repeat_on_eof=True,
            resident=False))),
        ("Raw File Source (float)", 1312.4, nop(lambda: lr.RawFileSource(
            paths["f32"], f32, rate, repeat_on_eof=True, resident=False))),
        ("IQ File Source (u8, device-side conversion)", None,
         nop(lambda: lr.IQFileSource(paths["u8"], "u8", rate,
                                     repeat_on_eof=True, resident=False))),
        ("IQ File Source (f32le, HBM-resident loop)", None,
         nop(lambda: lr.IQFileSource(paths["iq"], "f32le", rate,
                                     repeat_on_eof=True))),
        ("Null Source (Complex)", 1357.3, nop(lambda: lr.NullSource(c64,
                                                                    rate))),
        ("Null Source (Real)", 2941.9, nop(lambda: lr.NullSource(f32, rate))),
        ("Uniform Random Source (Complex)", 93.8, nop(rand_c)),
        ("Uniform Random Source (Real)", 176.2, nop(rand_f)),
        ("Signal Source (Complex Exponential)", 43.5, nop(
            lambda: lr.SignalSource("exponential", 200e3, rate))),
        ("Signal Source (Cosine)", 80.6, nop(
            lambda: lr.SignalSource("cosine", 200e3, rate))),
        ("Signal Source (Square)", 97.1, nop(
            lambda: lr.SignalSource("square", 200e3, rate))),
        ("FIR Filter (16 Real taps, Complex input)", 67.5, simple(
            rand_c, lambda: lr.FIRFilterBlock(taps16, use_fft=False))),
        ("FIR Filter (16 Real taps, Real input)", 84.7, simple(
            rand_f, lambda: lr.FIRFilterBlock(taps16, use_fft=False))),
        ("FIR Filter (16 Complex taps, Complex input)", 58.9, simple(
            rand_c, lambda: lr.FIRFilterBlock(taps16c, use_fft=False))),
        ("FIR Filter (FFT, 128 Real taps, Complex input)", 133.9, simple(
            rand_c, lambda: lr.FIRFilterBlock(taps128, use_fft=True))),
        ("FIR Filter (FFT, 128 Real taps, Real input)", 141.5, simple(
            rand_f, lambda: lr.FIRFilterBlock(taps128, use_fft=True))),
        ("FIR Filter (FFT, 128 Complex taps, Complex input)", 132.7, simple(
            rand_c, lambda: lr.FIRFilterBlock(taps128c, use_fft=True))),
        ("IIR Filter (5 ff 3 fb Real taps, Complex input)", 52.2,
         simple(rand_c, iir)),
        ("IIR Filter (5 ff 3 fb Real taps, Real input)", 98.9,
         simple(rand_f, iir)),
        ("FM Deemphasis Filter", 139.9, simple(
            rand_f, lambda: lr.FMDeemphasisFilterBlock(75e-6))),
        ("Downsampler (M = 5), Complex", 144.1, simple(
            rand_c, lambda: lr.DownsamplerBlock(5))),
        ("Downsampler (M = 5), Real", 253.1, simple(
            rand_f, lambda: lr.DownsamplerBlock(5))),
        ("Upsampler (L = 3), Complex", 702.6, simple(
            rand_c, lambda: lr.UpsamplerBlock(3))),
        ("Upsampler (L = 3), Real", 1259.6, simple(
            rand_f, lambda: lr.UpsamplerBlock(3))),
        ("Frequency Translator", 396.7, simple(
            rand_c, lambda: lr.FrequencyTranslatorBlock(200e3))),
        ("Hilbert Transform (65 taps)", 67.7, simple(
            rand_f, lambda: lr.HilbertTransformBlock(65))),
        ("Hilbert Transform (129 taps)", 47.5, simple(
            rand_f, lambda: lr.HilbertTransformBlock(129))),
        ("Frequency Discriminator", 111.6, simple(
            rand_c, lambda: lr.FrequencyDiscriminatorBlock(1.25))),
        ("PLL", 5.5, simple(rand_c, lambda: lr.PLLBlock(1e3, 200e3, 220e3))),
        ("PLL (locked, tone input)", 5.5, simple(
            lambda: lr.SignalSource("exponential", 210e3, rate),
            lambda: lr.PLLBlock(1e3, 200e3, 220e3))),
        ("PLL (acquiring, +3 dB tone in noise)", 5.5, pll_acquire),
        ("Zero Crossing Clock Recovery", 72.0, simple(
            rand_f, lambda: lr.ZeroCrossingClockRecoveryBlock(1200))),
        ("Binary Phase Corrector", 54.8, simple(
            rand_c, lambda: lr.BinaryPhaseCorrectorBlock(3000))),
        ("Add (Complex)", 226.4, two_in(rand_c, lr.AddBlock)),
        ("Subtract (Complex)", 224.0, two_in(rand_c, lr.SubtractBlock)),
        ("Multiply (Complex)", 280.6, two_in(rand_c, lr.MultiplyBlock)),
        ("Multiply (Real)", 608.6, two_in(rand_f, lr.MultiplyBlock)),
        ("Multiply Conjugate", 291.6,
         two_in(rand_c, lr.MultiplyConjugateBlock)),
        ("Multiply Constant (Real constant, Complex input)", 308.6, simple(
            rand_c, lambda: lr.MultiplyConstantBlock(2.5))),
        ("Multiply Constant (Complex constant, Complex input)", 254.5,
         simple(rand_c, lambda: lr.MultiplyConstantBlock(2.5 + 1j))),
        ("Multiply Constant (Real constant, Real input)", 570.7, simple(
            rand_f, lambda: lr.MultiplyConstantBlock(2.5))),
        ("Absolute Value", 647.5, simple(rand_f, lr.AbsoluteValueBlock)),
        ("Complex Conjugate", 383.4, simple(rand_c, lr.ComplexConjugateBlock)),
        ("Complex Magnitude", 297.4, simple(rand_c, lr.ComplexMagnitudeBlock)),
        ("Complex Phase", 130.0, simple(rand_c, lr.ComplexPhaseBlock)),
        ("Delay (N = 3000, Complex input)", 473.4, simple(
            rand_c, lambda: lr.DelayBlock(3000))),
        ("Bit Slicer", 92.6, simple(rand_f, lr.SlicerBlock)),
        ("Differential Decoder", 157.3, simple(
            lambda: lr.UniformRandomSource(lr.Bit, rate),
            lr.DifferentialDecoderBlock)),
        ("Complex to Real", 554.8, simple(rand_c, lr.ComplexToRealBlock)),
        ("Complex to Imaginary", 555.6, simple(rand_c,
                                               lr.ComplexToImagBlock)),
        ("Float to Complex", 397.7, two_in(rand_f, lr.FloatToComplexBlock,
                                           ("real", "imag"))),
    ]


def bench_one(build, chunk: int, device, duration: float = 3.0,
              optimize: bool = True) -> tuple[float, int, str]:
    """One row through the Runner on ``device``: one warm-up chunk, then
    trials of k chunks (k doubled while a trial takes under 50 ms), each
    ended by a synchronize, for about ``duration`` seconds.  Returns (the
    best trial's samples/s at the block's output, or at the sink's input
    where the optimizer fused the block away; chunks run; the output's
    type name)."""
    dev = resolve_device(device)
    top, blk = build()
    runner = Runner(top, chunk_size=chunk, optimize=optimize, device=dev)
    g = runner.graph
    if id(blk) in g.out_chunk:
        n_out, typ = g.out_chunk[id(blk)], blk.get_output_type()
    else:
        sink = next(b for b in g.order if isinstance(b, lr.BenchmarkSink))
        src = g.edges[PortRef(sink, 0)]
        n_out = g.out_chunk[id(src.block)]
        typ = src.block.get_output_type(src.index)
    try:
        if not runner._pump_once():
            raise RuntimeError("bench_blocks: the source ended in the "
                               "warm-up")
        common.sync(dev)
        best, spent, k, chunks = 0.0, 0.0, 1, 1
        while spent < duration:
            t0 = time.perf_counter()
            for _ in range(k):
                if not runner._pump_once():
                    raise RuntimeError("bench_blocks: the source ended in a "
                                       "trial")
            common.sync(dev)
            dt = time.perf_counter() - t0
            spent += dt
            chunks += k
            best = max(best, k * n_out / dt)
            if dt < 0.05:
                k *= 2
    finally:
        runner._cleanup_once()
    return best, chunks, typ.name


def record(name, baseline, sps, chunk, chunks, typ) -> dict:
    rec = {"name": name, "samples_per_second": sps, "msps": sps / 1e6,
           "baseline_i5_msps": baseline, "chunk": chunk, "chunks": chunks,
           "dtype": typ}
    if baseline is not None:
        rec["vs_baseline"] = sps / 1e6 / baseline
    return rec


def run(device=None, only=None, duration: float = 3.0, emit=None,
        chunk=None, n_file: int = N_FILE) -> dict:
    """Every row (those whose name holds ``only``, if given) on
    ``device``; each row's record is passed to ``emit`` as it is made.
    ``chunk`` replaces every row's chunk (the tests' small size).
    Returns the aggregate: rows, counts, the geometric mean against the
    baseline, device and power limit."""
    dev, info = common.setup(device)
    results = []
    with tempfile.TemporaryDirectory(prefix="bench_blocks_") as tmp:
        for name, baseline, build in benchmarks(tmp, n_file):
            if only and only.lower() not in name.lower():
                continue
            size = chunk or CHUNK_OVERRIDES.get(name, CHUNK)
            try:
                sps, chunks, typ = bench_one(build, size, dev, duration)
                rec = record(name, baseline, sps, size, chunks, typ)
            except Exception as exc:  # noqa: BLE001 — record, keep going
                rec = {"name": name, "baseline_i5_msps": baseline,
                       "error": f"{type(exc).__name__}: {exc}"[:300]}
            if name in WIRE_BYTES:
                h2d = common.h2d_pageable_MBps(dev)
                rec["h2d_pageable_MBps"] = h2d
                rec["wire_bytes_per_sample"] = WIRE_BYTES[name]
                if h2d and "msps" in rec:
                    rec["fraction_of_h2d"] = \
                        rec["msps"] * WIRE_BYTES[name] / h2d
            rec.update(device=info["device"],
                       power_limit_w=info["power_limit_w"])
            if emit:
                emit(rec)
            results.append(rec)
    ok = [r for r in results if "error" not in r and "vs_baseline" in r]
    return {"rows": results, "n_rows": len(results),
            "n_ok": len([r for r in results if "error" not in r]),
            "geomean_vs_baseline": (float(np.exp(np.mean(
                [np.log(r["vs_baseline"]) for r in ok]))) if ok else 0.0),
            "device": info["device"], "power_limit_w": info["power_limit_w"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--duration", type=float, default=3.0)
    args = ap.parse_args(argv)
    agg = run(only=args.only, duration=args.duration,
              emit=lambda r: print(json.dumps(r), flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(agg, f, indent=1)
        print(f"wrote {args.out}: {agg['n_ok']}/{agg['n_rows']} rows, "
              f"geomean vs baseline {agg['geomean_vs_baseline']:.2f}x",
              file=sys.stderr)
    return 0 if agg["n_ok"] == agg["n_rows"] else 1


if __name__ == "__main__":
    sys.exit(main())
