"""Thread-safe sample ring buffer for asynchronous hardware ingest (the
JAX package's utils/ringbuffer.py, copied: numpy and threading only).

The reference keeps USB streaming lossless by running vendor async read
callbacks that write straight into the flow graph's pipe from a driver
thread (radio/blocks/sources/rtlsdr.lua:214-266, with the
separate-Lua-state callback trick in radio/core/async.lua:74).  Here the
equivalent decoupling is a fixed-capacity numpy ring buffer: the driver
thread (a vendor C callback arriving via ctypes, or a reader thread doing
blocking sync reads) appends converted samples, and the flow-graph pump
thread consumes them in chunk-sized reads.  If the consumer stalls past
the buffer capacity, whole writes are dropped and counted in
``overflows`` — the same failure surface as a real SDR's USB overrun, and
observable instead of silent.
"""

from __future__ import annotations

import threading

import numpy as np


class SampleRingBuffer:
    """Single-producer single-consumer ring of samples (any numpy dtype)."""

    def __init__(self, capacity: int, dtype=np.complex64):
        self.capacity = int(capacity)
        self._buf = np.empty(self.capacity, dtype=dtype)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._rd = 0      # read position (monotonic)
        self._wr = 0      # write position (monotonic)
        self._closed = False
        self.overflows = 0          # dropped writes (producer-side stalls)
        self.dropped_samples = 0

    @property
    def available(self) -> int:
        with self._lock:
            return self._wr - self._rd

    def write(self, samples: np.ndarray) -> bool:
        """Append samples from the producer thread.  A write that does not
        fit is dropped whole (counted), never partially — chunk boundaries
        stay sample-aligned.  Returns False on drop or closed buffer."""
        samples = np.asarray(samples).reshape(-1)
        n = len(samples)
        with self._nonempty:
            if self._closed:
                return False
            if n > self.capacity - (self._wr - self._rd):
                self.overflows += 1
                self.dropped_samples += n
                return False
            pos = self._wr % self.capacity
            first = min(n, self.capacity - pos)
            self._buf[pos:pos + first] = samples[:first]
            if first < n:
                self._buf[:n - first] = samples[first:]
            self._wr += n
            self._nonempty.notify()
            return True

    def write_blocking(self, samples: np.ndarray,
                       timeout: float | None = None) -> bool:
        """Append samples, WAITING for space instead of dropping (producer
        back-pressure, used by TX sinks whose consumer is the hardware).
        Returns False only on close or timeout; never touches the
        overflow/drop counters — those are the lossy-ingest surface."""
        samples = np.asarray(samples).reshape(-1)
        n = len(samples)
        if n > self.capacity:
            raise ValueError(f"write of {n} samples exceeds ring capacity "
                             f"{self.capacity}")
        with self._nonempty:
            if not self._nonempty.wait_for(
                    lambda: self._closed
                    or n <= self.capacity - (self._wr - self._rd),
                    timeout=timeout):
                return False
            if self._closed:
                return False
            pos = self._wr % self.capacity
            first = min(n, self.capacity - pos)
            self._buf[pos:pos + first] = samples[:first]
            if first < n:
                self._buf[:n - first] = samples[first:]
            self._wr += n
            self._nonempty.notify_all()
            return True

    def read(self, n: int, timeout: float | None = None) -> np.ndarray | None:
        """Read up to n samples, blocking until at least one sample is
        available (or timeout / close).  Returns None when the buffer is
        closed and drained (EOF), an empty array on timeout."""
        with self._nonempty:
            if not self._nonempty.wait_for(
                    lambda: self._wr > self._rd or self._closed,
                    timeout=timeout):
                return np.empty(0, dtype=self._buf.dtype)
            avail = self._wr - self._rd
            if avail == 0:
                return None  # closed and drained
            take = min(n, avail)
            pos = self._rd % self.capacity
            first = min(take, self.capacity - pos)
            out = np.empty(take, dtype=self._buf.dtype)
            out[:first] = self._buf[pos:pos + first]
            if first < take:
                out[first:] = self._buf[:take - first]
            self._rd += take
            self._nonempty.notify_all()  # wakes write_blocking producers
            return out

    def read_exact(self, n: int, out: np.ndarray,
                   timeout: float | None = None) -> int | None:
        """Read EXACTLY n samples into ``out`` (at least n long) and return
        their count, blocking until they have accumulated — the
        live-streaming contract: a paced radio fills the ring in real time
        and a short read mid-stream would be misread as EOF by the
        static-chunk runtime.  At close the remaining (< n) samples are
        read, then None is returned (EOF).  ``timeout`` is a NO-PROGRESS
        timeout: while the producer keeps delivering samples (a radio
        sustainedly below the nominal rate — driver round-down, USB
        contention) the wait restarts, so only a genuinely stalled
        producer (dead hardware, paused stream) returns short — whatever
        is available, possibly none."""
        with self._nonempty:
            while True:
                wr_before = self._wr
                if self._nonempty.wait_for(
                        lambda: self._closed or (self._wr - self._rd) >= n,
                        timeout=timeout):
                    break
                if self._wr == wr_before:
                    break  # true stall: no samples in a full window
            avail = self._wr - self._rd
            if avail == 0 and self._closed:
                return None  # closed and drained
            take = min(n, avail)
            pos = self._rd % self.capacity
            first = min(take, self.capacity - pos)
            out[:first] = self._buf[pos:pos + first]
            if first < take:
                out[first:take] = self._buf[:take - first]
            self._rd += take
            self._nonempty.notify_all()  # wakes write_blocking producers
            return take

    def close(self):
        """Producer EOF / shutdown: readers drain the remainder then get
        None."""
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


__all__ = ["SampleRingBuffer"]
