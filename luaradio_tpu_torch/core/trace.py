"""Per-stage runtime tracing (the JAX package's core/trace.py).

The reference's observability is limited to an in-graph BenchmarkSink and a
debug logger (radio/blocks/sinks/benchmark.lua:88-121, radio/core/debug.lua).
The runtime adds a light span tracer around the pump.  Its spans, with the
thread each runs on, its parent (the innermost span open on that thread)
and the chunk it carries:

    span                    thread      parent                  once a
    sources.read            read-ahead  -                       read
    sources.h2d             read-ahead  -                       chunk
    sources.wait            pump        -                       chunk
    segment[i].dispatch     pump        -                       chunk
    pll.dispatch            pump        segment[i].dispatch     chunk
    pll.host_read           pump        pll.dispatch            host read
    pll.device              pump (card) pll.dispatch            chunk
    channelizer.dispatch    pump        segment[i].dispatch     chunk
    channelizer.device      pump (card) channelizer.dispatch    chunk
    chunk.hold              pump        -                       chunk
    host.d2h_wait           pump        -                       chunk
    host[i].process         pump        -                       chunk

``sources.read`` reads a chunk from the host sources and ``sources.h2d``
copies its payloads to the card; both run on the pump in eager mode and
where every source is device-resident.  ``sources.wait`` is the pump's wait
for the read-ahead thread's next chunk (fused mode only).
``segment[i].dispatch`` queues stage i's device work; it times the host's
queueing, not the card, except where an op reads the card on the host:
``pll.host_read`` is one such read of the PLL's guards (ops/pll_linear.py),
which waits for every kernel queued before it.  ``pll.dispatch`` is a
PLLBlock's work on a chunk, its tiers and their reads, and on a CUDA
device ``pll.device`` its time on the card by a pair of events as below,
which also holds the card's idle gaps while the host reads the tier
flags and picks the next tier's rows (blocks/signal/carrier.py).
``channelizer.dispatch``
queues the polyphase channelizer's work (blocks/signal/channelizer.py),
and on a CUDA device ``channelizer.device`` is that work's time on the
card: a pair of CUDA events recorded on the pump's stream before and after
its launches (:meth:`Tracer.device_span`), from the start event to the end
one, so it also holds any wait of the card for those launches where the
card runs ahead of the host.  The pair is resolved after the chunk's
``host.d2h_wait`` (:meth:`Tracer.resolve_device`): the copies back were
queued after it on the same stream, so both events are done and reading
them waits for nothing.  On the CPU, and with no tracer, there is no
pair.  ``chunk.hold`` is the
pipelined pump's hold of a chunk: from the end of its last dispatch to the
start of its host tail, while the previous chunk's host tail runs and the
next chunk is waited for and dispatched, one pump cycle (a derived
interval, recorded by :meth:`Tracer.record`; the last chunk of a run has
none).  ``host.d2h_wait`` waits on the chunk's copies back to
the host (in lockstep mode once a stage), and ``host[i].process`` runs
stage i's host blocks (only stages that have some).

Each span adds to an aggregate by name (count/total/mean/min/max,
:meth:`Tracer.report`) and appends one record ``Span(name, chunk, parent,
thread, t0_ns, t1_ns)`` to a bounded buffer (the newest ``RECORDS``,
:meth:`Tracer.events`), on ``time.perf_counter_ns()``; a device span's
record is made on the thread that resolves it and ends there, its length
the card's time.  The counter ``ChannelizerBlock.rows_emitted`` counts
the channel rows the channelizer has emitted (C a chunk, times any batch
in front), ``channelize.launches`` (ops/channelizer.py) the launches of
the channelizer's kernel, one a chunk on a card, and
``ChannelizerBlock.stock_chunks`` the chunks a card ran on the stock
path instead (a shape the kernel does not take);
``pll_hybrid.scan_rows`` and ``pll_hybrid.k3_rows`` (ops/pll_linear.py)
the row-chunks the PLL's overlap scan and K3 solved, and
``pll_linear.launches`` the launches of the PLL's linear-tier kernel, one
a PLL chunk on a card (0 on the CPU).  ``chunk`` is the
chunk's sequence number from 0, assigned by the reader in read order; a
span opened without one carries its parent's.  To ask why chunk k was
late, join its records on ``chunk == k``: its read and copy, the pump's
wait for it, its dispatch (and the PLL's reads inside), its hold behind
chunk k+1 and its copy-back wait.  ``wall_offset_ns`` (``time.time_ns()``
minus ``time.perf_counter_ns()``, taken when the tracer is made) places a
record on ``time.time_ns()``'s clock, the clock of a ``torch.profiler``
chrome trace (``ts`` plus ``baseTimeNanoseconds``).

While a tracer is on, every span also enters
``torch.profiler.record_function(name)``: spans on the thread that started
a profiler appear in its timeline as ``user_annotation`` (the profiler
records no range of a thread that was running before it started, such as
the read-ahead thread).

Enable with ``LUARADIO_TPU_TRACE=1`` or ``Runner(top, trace=True)``; read
the result from ``Runner.tracer``.  ``Runner.run`` makes its tracer the
thread's current one (:func:`current`) on the pump thread, and the
read-ahead thread on its own, so an op opens a span with :func:`span`
without a handle to the Runner; with no current tracer that is a no-op.
Nothing prints the report: the JAX package's docstring says its report is
printed at the end of ``run()``, but its code never prints it, and the
port follows the code (it has no printing method).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One span's record (module docstring)."""
    name: str
    chunk: int | None
    parent: str | None
    thread: str
    t0_ns: int
    t1_ns: int


class _Open:
    """A span while it is open: its name and chunk (``sources.wait``
    learns its chunk only when the chunk arrives)."""
    __slots__ = ("name", "chunk")

    def __init__(self, name, chunk):
        self.name, self.chunk = name, chunk


class Tracer:
    #: records kept by :meth:`events`, the newest
    RECORDS = 65536

    def __init__(self):
        import torch.profiler
        self._record_function = torch.profiler.record_function
        # a process's first range takes ~1 ms to enter: take it here, not
        # inside the first span
        with self._record_function("trace.init"):
            pass
        self.spans: dict[str, list[float]] = {}
        self._events: collections.deque = collections.deque(
            maxlen=self.RECORDS)
        # the read-ahead thread records its spans while the pump records
        # the rest
        self._lock = threading.Lock()
        self._local = threading.local()     # each thread's open spans
        #: ``time.time_ns() - time.perf_counter_ns()``: a record's time
        #: plus this is on the clock of a torch.profiler chrome trace
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()
        # device spans (name, chunk, parent, start, end) not yet resolved
        self._device: list = []

    def _stack(self) -> list:
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack = []
            loc.thread = threading.current_thread().name
        return loc.stack

    @contextlib.contextmanager
    def span(self, name: str, chunk: int | None = None):
        """Time the block as span ``name`` of chunk ``chunk`` (the
        parent's chunk if None).  Yields the open span, whose ``chunk``
        the block may set."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if chunk is None and parent is not None:
            chunk = parent.chunk
        sp = _Open(name, chunk)
        stack.append(sp)
        # the record encloses the profiler's range: a thread's first range
        # under a profiler takes ~0.4 ms to enter, after its start time
        t0 = time.perf_counter_ns()
        try:
            with self._record_function(name):
                yield sp
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            self._add(name, sp.chunk, parent and parent.name, t0, t1)

    @contextlib.contextmanager
    def device_span(self, name: str, device_name: str, device):
        """Host span ``name`` around the block; on a CUDA ``device`` also a
        pair of CUDA events on its current stream around the work the block
        queues, kept until :meth:`resolve_device` records it as span
        ``device_name`` (a child of ``name``, of the same chunk)."""
        with self.span(name) as sp:
            if device.type != "cuda":
                yield sp
                return
            import torch
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield sp
            end.record(stream)
            with self._lock:
                self._device.append((device_name, sp.chunk, name, start, end))

    def resolve_device(self, upto: int | None = None):
        """Record each pending device span of a chunk up to ``upto`` (every
        chunk with None) whose end event has completed; the rest stay
        pending.  Never waits on the card."""
        self._stack()
        with self._lock:
            pending, self._device = self._device, []
        keep = []
        for item in pending:
            name, chunk, parent, start, end = item
            if (upto is not None and chunk is not None and chunk > upto) \
                    or not end.query():
                keep.append(item)
                continue
            t1 = time.perf_counter_ns()
            self._add(name, chunk, parent,
                      t1 - round(start.elapsed_time(end) * 1e6), t1)
        with self._lock:
            self._device[:0] = keep

    def record(self, name: str, t0_ns: int, t1_ns: int,
               chunk: int | None = None):
        """Record a derived interval [t0_ns, t1_ns] (perf_counter_ns) as
        span ``name``, a child of the span open on this thread if any."""
        stack = self._stack()
        self._add(name, chunk, stack[-1].name if stack else None,
                  t0_ns, t1_ns)

    def _add(self, name, chunk, parent, t0, t1):
        dt = (t1 - t0) * 1e-9
        rec = Span(name, chunk, parent, self._local.thread, t0, t1)
        with self._lock:
            self._events.append(rec)
            agg = self.spans.setdefault(name, [0, 0.0, float("inf"), 0.0])
            agg[0] += 1
            agg[1] += dt
            agg[2] = min(agg[2], dt)
            agg[3] = max(agg[3], dt)

    def events(self) -> list[Span]:
        """The newest ``RECORDS`` span records, in the order they closed."""
        with self._lock:
            return list(self._events)

    def report(self) -> dict:
        with self._lock:
            return {
                name: {"count": int(c), "total_s": t,
                       "mean_s": t / max(c, 1), "min_s": mn, "max_s": mx}
                for name, (c, t, mn, mx) in self.spans.items()
            }


_current = threading.local()
_NULL = contextlib.nullcontext()


def current() -> Tracer | None:
    """This thread's current tracer (set by the Runner's threads), or
    None."""
    return getattr(_current, "tracer", None)


def set_current(tracer: Tracer | None) -> Tracer | None:
    """Make ``tracer`` this thread's current one; returns the one
    before."""
    prev = getattr(_current, "tracer", None)
    _current.tracer = tracer
    return prev


def span(name: str):
    """Span ``name`` on this thread's current tracer; a no-op context
    where there is none."""
    t = getattr(_current, "tracer", None)
    return _NULL if t is None else t.span(name)


def device_span(name: str, device_name: str, device):
    """Host span ``name`` and device span ``device_name`` on this thread's
    current tracer (:meth:`Tracer.device_span`); a no-op context where
    there is none."""
    t = getattr(_current, "tracer", None)
    return _NULL if t is None else t.device_span(name, device_name, device)


def enabled_by_env() -> bool:
    v = os.environ.get("LUARADIO_TPU_TRACE", "")
    return v not in ("", "0", "false")


__all__ = ["Span", "Tracer", "current", "device_span", "enabled_by_env",
           "set_current", "span"]
