"""Where the streamed file rows of the block benchmark spend their time.

    python3 scratch/file_rows_trace.py

Runs chip_smoke.py's streamed file rows (IQ f32le, real f32le, raw float,
IQ u8: 4 Mi-sample repeating files, 2^22-sample chunks, source -> Nop ->
BenchmarkSink) through the Runner with the span tracer on (its spans
over the timed chunks, after a warm-up chunk), then times
the host pieces of one chunk alone: the source's read (file bytes and
conversion), the pageable host-to-device copy of the result, and a copy
of the same bytes from pinned memory.  Prints one JSON object; needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import luaradio_tpu_torch as lr  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.core.trace import Tracer  # noqa: E402

N, CHUNK, CHUNKS = 4 << 20, 1 << 22, 24


def host_ms(fn, reps=9):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("file_rows_trace: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        iq, f32, u8 = (os.path.join(tmp, k) for k in ("iq", "f32", "u8"))
        (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
            np.complex64).tofile(iq)
        rng.standard_normal(N).astype(np.float32).tofile(f32)
        rng.integers(0, 256, 2 * N).astype(np.uint8).tofile(u8)
        rows = {
            "IQ File Source (f32le)": lambda: lr.IQFileSource(
                iq, "f32le", 1e6, repeat_on_eof=True, resident=False),
            "Real File Source (f32le)": lambda: lr.RealFileSource(
                f32, "f32le", 1e6, repeat_on_eof=True, resident=False),
            "Raw File Source (float)": lambda: lr.RawFileSource(
                f32, lr.Float32, 1e6, repeat_on_eof=True, resident=False),
            "IQ File Source (u8)": lambda: lr.IQFileSource(
                u8, "u8", 1e6, repeat_on_eof=True, resident=False),
        }
        for name, make in rows.items():
            top = lr.CompositeBlock()
            top.connect(make(), lr.NopBlock(),
                        lr.BenchmarkSink(report_period=1e9))
            runner = Runner(top, chunk_size=CHUNK, trace=True, device=dev)
            runner._pump_once()
            torch.cuda.synchronize()
            runner.tracer = Tracer()     # spans of the timed chunks only
            t0 = time.perf_counter()
            for _ in range(CHUNKS):
                runner._pump_once()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            runner._cleanup_once()
            spans = {k: round(v["mean_s"] * 1e3, 3)
                     for k, v in runner.tracer.report().items()}
            src = make()
            src.initialize()
            wire = src.device_ingest() is not None
            if wire:
                def read():
                    raw = np.empty(src.wire_shape(CHUNK), src.wire_dtype)
                    src.read_wire_into(raw)
                    return raw
            else:
                def read():
                    return src.read(CHUNK)
            arr = read()
            pinned = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
            out[name] = {
                "msps": CHUNKS * CHUNK / dt / 1e6,
                "span_mean_ms": spans,
                "read_ms": host_ms(read),
                "h2d_pageable_ms": host_ms(lambda: torch.from_numpy(
                    np.ascontiguousarray(arr)).to(dev)),
                "h2d_pinned_ms": host_ms(lambda: pinned.to(
                    dev, non_blocking=True)),
                "chunk_bytes": int(arr.nbytes)}
            src.cleanup()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
