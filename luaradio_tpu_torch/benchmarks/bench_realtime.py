"""Real-time streaming on the card (the JAX system's bench_realtime.py, on
the port): a fake librtlsdr paces u8 I/Q at 2.4 MS/s of wall-clock time
into the rx_wbfm mono chain (RtlSdrSource -> Tuner -> WBFMMonoDemodulator
-> Downsampler) and an audio sink stand-in that consumes at the audio rate,
for 30 s by default.

    python -m luaradio_tpu_torch.benchmarks.bench_realtime [--duration S]
        [--out PATH]

Measured, as the JAX script's keys (:202-217): the sustained input rate
against the radio's, ring overflows after a grace period (must be 0: every
USB buffer kept up) and during it, the end-to-end latency (a sample's
production at the fake USB boundary to its audio leaving the sink) with
its median, maximum and slope (a backlogged chain's latency grows; flat is
real time), the real-time margin (the chain's unpaced rate over the
radio's) and ``ok``.  Also the samples the ring dropped, and ``device``
and ``power_limit_w``.

The fake library is injected through ``RtlSdrSource._injected_lib`` (the
route chip_smoke.py's live phase takes); ``paced=False`` serves every
buffer at once and consumes audio unpaced (the tests' small run).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import threading
import time
from ctypes import POINTER, c_int, c_void_p, cast

import numpy as np

import luaradio_tpu_torch as lr
from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.blocks.sources.sdr import RtlSdrSource
from luaradio_tpu_torch.core.runtime import Runner

RATE = 2.4e6
IF_RATE = 240e3          # tuner decimation 10
AF_RATE = 48e3           # mono audio, downsample 5
CHUNK = 1 << 19          # ~0.22 s of RF a chunk


class PacedFakeRtlSdr:
    """The librtlsdr calls a RtlSdrSource makes, delivering u8 I/Q at
    ``rate`` samples/s of wall-clock time (a dongle's USB stream) for
    ``duration`` seconds, then failing a read (the end); unpaced
    (``paced=False``) a read returns at once.  The payload is an FM
    modulated 1 kHz tone at 75 kHz deviation."""

    def __init__(self, rate: float = RATE, duration: float = 30.0,
                 paced: bool = True):
        self.rate, self.duration, self.paced = rate, duration, paced
        self.t0: float | None = None
        self.produced = 0            # complex samples delivered
        n = 1 << 20                  # recycled modulated block
        t = np.arange(n) / rate
        phi = 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / rate
        iq = np.exp(1j * phi)
        u8 = np.empty(2 * n, np.uint8)
        u8[0::2] = np.round(iq.real * 127.5 + 127.5).clip(0, 255)
        u8[1::2] = np.round(iq.imag * 127.5 + 127.5).clip(0, 255)
        self.block = u8

    def __getattr__(self, name):
        if not name.startswith("rtlsdr_"):
            raise AttributeError(name)
        return lambda *args: 0

    def rtlsdr_open(self, devp, index):
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0x171)
        return 0

    def rtlsdr_read_sync(self, dev, buf, nbytes, gotp):
        n_bytes = nbytes if isinstance(nbytes, int) else nbytes.value
        n = n_bytes // 2
        if self.t0 is None:
            self.t0 = time.monotonic()
        if self.produced / self.rate >= self.duration:
            return -1                # the stream's end
        if self.paced:
            # the buffer's last sample exists only at its production time
            delay = self.t0 + (self.produced + n) / self.rate \
                - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        off = (self.produced * 2) % len(self.block)
        seg = np.take(self.block, np.arange(off, off + 2 * n), mode="wrap")
        ctypes.memmove(buf, seg.ctypes.data, len(seg))
        cast(gotp, POINTER(c_int))[0] = len(seg)
        self.produced += n
        return 0


class AudioStubSink(lr.SinkBlock):
    """An audio sink's stand-in: consumes at the audio rate on an absolute
    schedule (what a sound server's buffer does) when ``paced``, and
    records the latency of the newest sample of every chunk."""

    def __init__(self, fake: PacedFakeRtlSdr, paced: bool = True):
        super().__init__()
        self.fake, self.paced = fake, paced
        self.consumed = 0
        self.records: list[tuple[float, float]] = []
        self._t0 = None
        self.add_type_signature([lr.Input("in", lambda t: True)], [])

    def process(self, x):
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self.consumed += len(x)
        delay = self._t0 + self.consumed / AF_RATE - now
        if self.paced and delay > 0:
            time.sleep(delay)
        if self.fake.t0 is not None:
            produced_at = self.fake.t0 + self.consumed * (RATE / AF_RATE) \
                / RATE
            t = time.monotonic()
            self.records.append((t, t - produced_at))


def build(fake, sink) -> tuple[lr.CompositeBlock, RtlSdrSource]:
    """The chain from a RtlSdrSource on ``fake`` into ``sink``."""
    RtlSdrSource._injected_lib = fake
    src = RtlSdrSource(104.3e6, RATE)
    top = lr.CompositeBlock()
    top.connect(src, lr.TunerBlock(0.0, 100e3, int(RATE / IF_RATE)),
                lr.WBFMMonoDemodulator(),
                lr.DownsamplerBlock(int(IF_RATE / AF_RATE)), sink)
    return top, src


def run_realtime(duration: float = 30.0, grace: float = 2.0,
                 chunk: int = CHUNK, device=None, paced: bool = True,
                 burst_chunks: int = 8) -> dict:
    """The record (module docstring) of a ``duration``-second run on
    ``device`` (the card by default)."""
    dev, info = common.setup(device)
    try:
        # warm-up: an unpaced short run (kernel builds, cuDNN plans)
        warm = PacedFakeRtlSdr(duration=1e12, paced=False)
        top, _ = build(warm, AudioStubSink(warm, paced=False))
        t0 = time.monotonic()
        Runner(top, chunk_size=chunk, device=dev).run(max_chunks=3)
        warmup_s = time.monotonic() - t0

        # unpaced rate: the real-time margin
        burst = PacedFakeRtlSdr(duration=1e12, paced=False)
        top, _ = build(burst, lr.NopSink())
        r = Runner(top, chunk_size=chunk, device=dev)
        t0 = time.monotonic()
        r.run(max_chunks=burst_chunks)
        common.sync(dev)
        burst_sps = burst_chunks * chunk / (time.monotonic() - t0)

        # the real-time run
        fake = PacedFakeRtlSdr(duration=duration, paced=paced)
        sink = AudioStubSink(fake, paced=paced)
        top, src = build(fake, sink)
        r = Runner(top, chunk_size=chunk, device=dev)
        mark = {}

        def snapshot():
            time.sleep(grace)
            mark["post_grace"] = src.ring.overflows if src.ring else 0
        g = threading.Thread(target=snapshot, daemon=True)
        t_start = time.monotonic()
        g.start()
        r.run()
        elapsed = time.monotonic() - t_start
        g.join(timeout=grace + 1.0)
    finally:
        RtlSdrSource._injected_lib = None
    lat = [(t, v) for t, v in sink.records if t - t_start > grace]
    lats = np.array([v for _, v in lat]) if lat else np.zeros(1)
    ts = np.array([t for t, _ in lat]) if lat else np.zeros(1)
    slope = float(np.polyfit(ts - ts[0], lats, 1)[0]) if len(lat) >= 3 \
        else 0.0
    total = src.ring.overflows if src.ring else 0
    steady = total - mark.get("post_grace", 0)
    return {
        "radio_rate_sps": RATE, "paced": paced,
        "duration_s": elapsed, "chunk_rf_samples": chunk,
        "delivered_rf_samples": fake.produced,
        "dropped_rf_samples": src.ring.dropped_samples if src.ring else 0,
        "sustained_input_sps": fake.produced / elapsed,
        "audio_samples_out": sink.consumed,
        "ring_overflows_steady_state": int(steady),
        "ring_overflows_startup": int(mark.get("post_grace", 0)),
        "latency_p50_s": float(np.median(lats)),
        "latency_max_s": float(np.max(lats)),
        "latency_slope_s_per_s": slope,
        "unpaced_throughput_sps": burst_sps,
        "real_time_margin": burst_sps / RATE,
        "compile_warmup_s": warmup_s, "grace_s": grace,
        "device": info["device"], "power_limit_w": info["power_limit_w"],
        "ok": bool(steady == 0 and abs(slope) < 0.05 and burst_sps > RATE),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = run_realtime(duration=args.duration)
    common.emit(rec, args.out, indent=1)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
