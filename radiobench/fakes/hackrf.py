"""A paced fake of libhackrf's receive path, injected into the program's
``HackRFSource`` (through its ``_injected_lib`` hook), adapted from the
port's ``benchmarks/bench_realtime.py`` ``PacedFakeRtlSdr`` to libhackrf's
callback.

``hackrf_start_rx`` starts a thread that plays the capture (s8 I/Q,
looped) as libhackrf's USB thread would: one transfer of
``transfer_bytes`` at a time, each handed to the callback when its last
sample is due on the wall clock (t0 + samples / rate), whether or not the
graph keeps up.  The schedule is the stamp of every sample: sample g is
created at t0 + (g + 1) / rate.  After each transfer the fake reads the
source's ring counters to learn whether the ring dropped it, and records
where in the ring's stream a drop fell.

``make``, ``open_source`` and ``release`` are what the live player
(radiobench/players/live.py) calls of every fake library.
"""

from __future__ import annotations

import threading
import time
from ctypes import (POINTER, Structure, c_int, c_uint8, c_void_p, cast,
                    pointer)

import numpy as np


class _Transfer(Structure):
    """libhackrf's ``hackrf_transfer`` (hackrf.h)."""
    _fields_ = [("device", c_void_p),
                ("buffer", POINTER(c_uint8)),
                ("buffer_length", c_int),
                ("valid_length", c_int),
                ("rx_ctx", c_void_p),
                ("tx_ctx", c_void_p)]


class PacedFakeHackRF:
    def __init__(self, wire: np.ndarray, rate: float,
                 transfer_bytes: int = 262144, clock=time.perf_counter):
        self.rate = float(rate)
        self.transfer = transfer_bytes // 2          # samples a transfer
        # the capture extended by one transfer: no transfer wraps
        w = np.ascontiguousarray(wire, dtype=np.int8)
        self._n = len(w) // 2
        self._block = np.concatenate([w, np.resize(w, transfer_bytes)])
        self._clock = clock
        self.source = None           # the HackRFSource, for its ring
        self.t0: float | None = None
        self.accepted = 0            # samples the ring took
        self.drops: list[tuple[int, int]] = []   # (ring position, samples)
        self.late: list[tuple[float, float]] = []   # (due, seconds late)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the calls HackRFSource makes --------------------------------------
    def __getattr__(self, name):
        if not name.startswith("hackrf_"):
            raise AttributeError(name)
        return lambda *args: 0

    def hackrf_open(self, devp):
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0x4AC7)
        return 0

    @property
    def hackrf_compute_baseband_filter_bw_round_down_lt(self):
        def round_down(bw):      # a function: the caller sets its restype
            return int(getattr(bw, "value", bw) * 3 // 4)
        return round_down

    def hackrf_start_rx(self, dev, cb, ctx):
        self._thread = threading.Thread(target=self._pump, args=(dev, cb),
                                        daemon=True)
        self.t0 = self._clock()
        self._thread.start()
        return 0

    def hackrf_stop_rx(self, dev):
        self.stop()
        return 0

    # -- the USB thread -------------------------------------------------------
    def _pump(self, dev, cb):
        t = self.transfer
        ptr_type = cb.argtypes[0] if cb.argtypes else POINTER(_Transfer)
        k = 0
        while not self._stop.is_set():
            due = self.t0 + (k + 1) * t / self.rate
            wait = due - self._clock()
            if wait > 0 and self._stop.wait(wait):
                break
            off = 2 * ((k * t) % self._n)
            buf = (c_uint8 * (2 * t)).from_buffer(self._block, off)
            tr = _Transfer(device=dev, buffer=cast(buf, POINTER(c_uint8)),
                           buffer_length=2 * t, valid_length=2 * t)
            ring = self.source.ring
            before = ring.dropped_samples
            cb(cast(pointer(tr), ptr_type))
            if ring.dropped_samples != before:
                self.drops.append((self.accepted, t))
            else:
                self.accepted += t
            self.late.append((due, self._clock() - due))
            k += 1

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- stamps -------------------------------------------------------------
    def generator_index(self, ring_pos: int) -> int:
        """The generator's sample index of the ring stream's sample
        ``ring_pos`` (drops shift the two apart)."""
        return ring_pos + sum(n for pos, n in self.drops if pos <= ring_pos)

    def created(self, ring_pos: int) -> float:
        """When the ring stream's sample ``ring_pos`` was created."""
        return self.t0 + (self.generator_index(ring_pos) + 1) / self.rate


def make(wire: np.ndarray, cfg: dict, mix: dict) -> PacedFakeHackRF:
    """The fake playing the capture's wire items at the configuration's
    rate in transfers of the mix's ``transfer_bytes``."""
    return PacedFakeHackRF(wire.view(np.int8), cfg["rate"],
                           mix["transfer_bytes"])


def open_source(fake: PacedFakeHackRF, cfg: dict):
    """The program's ``HackRFSource`` on ``fake``, tuned as rx_wbfm tunes
    it: the station's frequency plus the tune offset."""
    import luaradio_tpu_torch as lr
    lr.HackRFSource._injected_lib = fake
    src = lr.HackRFSource(cfg["frequency"] + cfg["tune_offset"], cfg["rate"])
    fake.source = src
    return src


def release():
    import luaradio_tpu_torch as lr
    lr.HackRFSource._injected_lib = None


__all__ = ["PacedFakeHackRF", "make", "open_source", "release"]
