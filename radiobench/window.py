"""The measured window and the sink that sees it.

``BenchSink`` is the graph's audio sink and ``MessageSink`` its sink of
decoded messages (a configuration whose file says ``"output":
"messages"``): host sinks (``SinkBlock``s of the program) that hand every
output chunk to a ``Window`` as it arrives.  The window counts chunks from
the first one the graph emits, opens after ``warm_chunks`` of them
(everything before that is set-up), and closes ``seconds`` later on the
host clock.  Inside it, it records each chunk's arrival time and keeps a
copy of a seeded uniform sample of the chunks (reservoir sampling, plus
the window's first chunk) for the comparison with the reference, and,
for messages, every window chunk's messages.  In a traced run it also
calls ``on_slice`` once, at the start of the window's last ``slice_s``
seconds (the profiled slice), and ``on_close`` when the first chunk after
the window arrives.
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
        self.messages: dict[int, list] = {}           # chunk -> messages
        self._slots: list[int] = []                   # the reservoir
        self.slice_chunks = 0
        self.closed = threading.Event()

    def on_chunk(self, xs, messages: list | None = None):
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
        if messages is not None:
            self.messages[c] = messages
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
    """A chunk's audio (or soft samples) as [rows, channels, n] (a bank's
    inputs arrive as [rows, n] arrays, one per channel)."""
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


class MessageSink(lr.SinkBlock):
    """The benchmark's message sink: one input of any type, as the
    program's ``JSONSink`` takes.  Under a bank the runtime does not clone
    a sink: it calls it once a row a chunk, in row order; without one,
    once a chunk.  Each message is recorded as (chunk, row, its JSON as
    the program prints it).

    Beside it, ``soft`` is a sink of the samples the receiver's slicer
    decides on (the clock recovery's input), one float32 input that the
    configuration's graph connects: it takes a chunk of all rows in one
    call.  Once a chunk's rows of messages and its soft samples are in,
    the window gets one call, with both, so it counts chunks as for
    audio.  ``calls`` and ``soft.calls`` let the harness hold the runtime
    to whole rows a chunk and one soft chunk a chunk."""

    def __init__(self, rows: int, window: Window):
        super().__init__()
        self.rows = int(rows)
        self.window = window
        self.calls = 0
        self.soft = _SoftTap(self)
        self._records: dict[int, list] = {}     # chunk -> its records
        self._soft: dict[int, np.ndarray] = {}  # chunk -> its soft samples
        self.add_type_signature([lr.Input("in", lambda t: True)], [])

    def process(self, x):
        c, row = divmod(self.calls, self.rows)
        self.calls += 1
        self._records.setdefault(c, []).extend(
            (c, row, lr.JSONSink._dump(m)) for m in x)
        self._hand_on(c)

    def _hand_on(self, c: int):
        """Chunk ``c`` to the window once its rows of messages and its
        soft samples are in."""
        if self.calls >= (c + 1) * self.rows and self.soft.calls > c:
            self.window.on_chunk((self._soft.pop(c),),
                                 messages=self._records.pop(c, []))


class _SoftTap(lr.SinkBlock):
    """``MessageSink.soft``: the soft samples of a chunk, [rows, n] under
    a bank, [n] without one."""

    def __init__(self, owner: MessageSink):
        super().__init__()
        self.owner = owner
        self.calls = 0
        self.add_type_signature([lr.Input("in", lr.Float32)], [])

    def process(self, x):
        c = self.calls
        self.calls += 1
        self.owner._soft[c] = x
        self.owner._hand_on(c)


def sink_for(cfg: dict, rows: int, window: Window) -> lr.SinkBlock:
    """The sink of a configuration's graph: a ``MessageSink`` of ``rows``
    rows where its output is messages, else a ``BenchSink`` of its audio
    channels (1 mono, 2 stereo)."""
    if cfg.get("output", "audio") == "messages":
        return MessageSink(rows, window)
    return BenchSink(1 if cfg["mono"] else 2, window)


__all__ = ["Window", "BenchSink", "MessageSink", "sink_for"]
