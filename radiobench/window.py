"""The measured window and the sink that sees it.

``BenchSink`` is the graph's sink: a host sink (a ``SinkBlock`` of the
program) that hands every output chunk to a ``Window`` as it arrives.  The
window counts chunks from the first one the graph emits, opens after
``warm_chunks`` of them (everything before that is set-up), and closes
``seconds`` later on the host clock.  Inside it, it records each chunk's
arrival time and keeps a copy of a seeded uniform sample of the chunks
(reservoir sampling, plus the window's first chunk) for the comparison
with the reference.  In a traced run it also calls ``on_slice`` once, at
the start of the window's last ``slice_s`` seconds (the profiled slice),
and ``on_close`` when the first chunk after the window arrives.
"""

from __future__ import annotations

import threading
import time

import numpy as np

import luaradio_tpu_torch as lr


class Window:
    def __init__(self, seconds: float, warm_chunks: int, keep: int,
                 seed: int, slice_s: float | None = None,
                 on_open=None, on_slice=None, on_close=None,
                 clock=time.perf_counter):
        self.seconds = float(seconds)
        self.warm_chunks = int(warm_chunks)
        self.keep = int(keep)
        self.slice_s = slice_s
        self._rng = np.random.default_rng(int(seed) % (1 << 63))
        self._hooks = (on_open, on_slice, on_close)
        self._clock = clock
        self.count = 0                  # chunks the sink has received
        self.t_open = self.t_close = self.t_slice = None
        self.arrivals: list[tuple[int, float]] = []   # (chunk, time)
        self.kept: dict[int, np.ndarray] = {}         # chunk -> audio
        self._slots: list[int] = []                   # the reservoir
        self.slice_chunks = 0
        self.closed = threading.Event()

    def on_chunk(self, xs):
        now = self._clock()
        c = self.count
        self.count += 1
        if self.closed.is_set():
            return
        if self.t_open is None:
            if c == self.warm_chunks - 1:
                self.t_open = now
                self.t_close = now + self.seconds
                if self.slice_s:
                    self.t_slice = self.t_close - self.slice_s
                if self._hooks[0]:
                    self._hooks[0]()
            return
        if now > self.t_close:
            if self._hooks[2]:
                self._hooks[2]()
            self.closed.set()
            return
        if self.t_slice is not None:
            if now >= self.t_slice:
                if self.slice_chunks == 0 and self._hooks[1]:
                    self._hooks[1]()
                self.slice_chunks += 1
        i = len(self.arrivals)
        self.arrivals.append((c, now))
        if i == 0:
            self.kept[c] = _copy(xs)
            return
        # reservoir over the window's other chunks (the first stays)
        n = i - 1
        if n < self.keep:
            self._slots.append(c)
            self.kept[c] = _copy(xs)
        else:
            j = int(self._rng.integers(0, n + 1))
            if j < self.keep:
                del self.kept[self._slots[j]]
                self._slots[j] = c
                self.kept[c] = _copy(xs)

    @property
    def window_chunks(self) -> int:
        return len(self.arrivals)


def _copy(xs) -> np.ndarray:
    """A chunk's audio as [rows, channels, n] (a bank's inputs arrive as
    [rows, n] arrays, one per channel)."""
    arrs = [np.array(x, dtype=np.float32, copy=True) for x in xs]
    if arrs[0].ndim == 1:
        return np.stack(arrs)[None]
    return np.stack(arrs, axis=1)


class BenchSink(lr.SinkBlock):
    """The benchmark's audio sink: ``channels`` float32 inputs (``in`` for
    one, ``in1``, ``in2``, ... for more), each chunk handed to the
    window."""

    def __init__(self, channels: int, window: Window):
        super().__init__()
        self.window = window
        if channels == 1:
            self.add_type_signature([lr.Input("in", lr.Float32)], [])
        else:
            self.add_type_signature(
                [lr.Input(f"in{i + 1}", lr.Float32)
                 for i in range(channels)], [])

    def process(self, *xs):
        self.window.on_chunk(xs)


__all__ = ["Window", "BenchSink"]
