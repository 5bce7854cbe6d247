"""Flow-graph execution.

The reference runs one OS process per block connected by UNIX socketpairs,
with a poll()-based hot loop of read -> deserialize -> process -> serialize
-> write (radio/core/composite.lua:568-636, radio/core/block.lua:556-608).

Port design: each *stage* of device blocks runs as one step function
``step(states, ext_inputs) -> (states, outputs)`` over torch tensors on the
graph's device; block boundaries inside a segment cost one tensor hand-off.
A host "pump" drives chunks: a read-ahead thread reads host sources and
copies each chunk to the card, each by the route its feed chose once
(core/ingest.py), the pump feeds the segments, and boundary outputs are
copied back to the host asynchronously for the host blocks (file sinks).
PyTorch queues the card's work asynchronously, so host I/O for one chunk
overlaps device compute of the previous one.

A channel bank (``Runner(..., channels=C)``, the one-card form of the JAX
package's ``run(mesh=<channel mesh>, channels=C)``) runs the same graph on
C independent channels: every device block's state is broadcast to
(C,) + its shape and its chunks carry a leading [C] axis (device blocks
broadcast over leading axes, as the JAX package's vmap does), BankSource
chunks arrive as [C, n] (or as [C, k n] wire items), device sources are
generated once and replicated C times, and mid-graph host blocks run as
one clone per channel on their row of the boundary arrays.

A mesh (``Runner(..., mesh=...)``, parallel/mesh.py) with a ``"time"``
axis of D shards splits every chunk into D consecutive shards: each
segment reshapes its inputs to ``[D, ..., T/D]`` (the shards on a leading
axis), runs each block's process_sharded (the SignalBlock time-sharding
contract: halos and distributed prefixes over the shards) and joins its
outputs again, so boundary arrays and host blocks see the global stream.
A ``"channel"`` axis is the bank above; both may be present.  With a
process group the processes split the mesh's first axis: over time, each
process reads the whole chunk but keeps its contiguous block of it (the
halos and summaries cross processes) and its sinks receive that block;
over channels, each process runs its own range of channels, host clones
included.

Modes (the JAX package's):
  - "fused": the read-ahead thread and, where no host block feeds a
    device block, the pipelined pump (production path);
  - "eager": sources read synchronously in the pump, never pipelined (for
    debugging; the analog of the reference's single-process scheduler).
    The port has no jit, so the segments are the same and the output is
    the fused run's bit for bit.

With a tracer (``Runner(trace=True)`` or ``LUARADIO_TPU_TRACE=1``,
core/trace.py, which lists each span with its thread and parent) the
read-ahead thread records ``sources.read`` and ``sources.h2d`` (the pump
does, in eager mode or where every source is device-resident), and the
pump ``sources.wait``, ``segment[i].dispatch`` (with the PLL's
``pll.host_read`` inside), ``chunk.hold`` (pipelined mode),
``host.d2h_wait`` and ``host[i].process`` for stages with host blocks;
after a chunk's ``host.d2h_wait`` it resolves the device spans its ops
queued (``channelizer.device``), which then wait for nothing.
Every span carries the sequence number of its chunk, assigned in read
order, so one chunk's records join on it (``Runner.tracer.events()``).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from luaradio_tpu_torch.core.block import (Block, HostSourceBlock,
                                           SignalSourceBlock, SinkBlock)
from luaradio_tpu_torch.core import trace as trace_mod
from luaradio_tpu_torch.core.composite import CompositeBlock, Graph, PortRef
from luaradio_tpu_torch.core.ingest import pad_to, plan_feeds
from luaradio_tpu_torch.ops.complexutil import to_device
from luaradio_tpu_torch.parallel import multihost
from luaradio_tpu_torch.parallel.mesh import join_shards, split_shards

MODES = ("fused", "eager")


def _to_host(value, n_valid=None, masked=False):
    """Host numpy view of an edge value (already copied off the card by
    the pump), trimmed to its valid samples.  Time is the LAST axis.

    A masked edge is a (values, mask) pair: it yields values[mask], with
    the mask cut at ``n_valid`` first so that the padding of the last
    chunk never emits a sample.  Compacting here, after the copy, costs
    the card nothing: on the card the output's size would be one more
    device-to-host sync a chunk."""
    if masked:
        values, mask = (v.numpy() for v in value)
        if n_valid is not None and n_valid < mask.shape[-1]:
            mask = mask.copy()
            mask[..., max(0, n_valid):] = False
        return values[mask]
    if isinstance(value, (list, tuple)):
        return value
    arr = value.numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    if n_valid is not None and n_valid < arr.shape[-1]:
        arr = arr[..., :max(0, n_valid)]
    return arr


def _wants_host(block: Block) -> bool:
    return not (isinstance(block, SinkBlock) and not block.wants_data)


def broadcast_state(state, shape: tuple):
    """A block's state with every leaf broadcast to ``shape`` + its own
    shape (tuples, lists and None kept)."""
    if state is None or not shape:
        return state
    if isinstance(state, (tuple, list)):
        return type(state)(broadcast_state(v, shape) for v in state)
    return state.expand(shape + state.shape).clone()


class _Banked(list):
    """Per-channel host values of a channel bank: element c is channel c's
    output of a host block clone (variable length per channel).  A list
    whose len() is the total, so sinks that only measure length see every
    channel's samples."""

    def __len__(self):
        return sum(len(r) if hasattr(r, "__len__") else 1
                   for r in list.__iter__(self))

    @property
    def rows(self):
        return list(list.__iter__(self))


class Segment:
    """A maximal group of device blocks run as one step function."""

    def __init__(self, graph: Graph, blocks: list[Block], bid: dict[int, str],
                 ingest: dict[str, Any] | None = None,
                 channels: int | None = None, time_axis=None):
        self.blocks = blocks
        self.channels = channels
        #: the mesh's time Axis (parallel/mesh.py), or None
        self.time_axis = time_axis
        self.bid = bid
        #: the wire feeds' on-card converters, by output key
        self.ingest = ingest or {}
        self._edges = graph.edges
        self._gen_len = {bid[id(b)]: graph.out_chunk[id(b)] for b in blocks
                         if isinstance(b, SignalSourceBlock)}
        in_seg = {id(b) for b in blocks}

        # External input edges (values produced outside this segment) and
        # their planned lengths, to which a host block's short chunk is padded.
        self.ext_len: dict[str, int] = {}
        for b in blocks:
            for i in range(len(b.inputs)):
                src = graph.edges[PortRef(b, i)]
                if id(src.block) not in in_seg:
                    key = f"{bid[id(src.block)]}.{src.index}"
                    self.ext_len[key] = graph.out_chunk[id(src.block)]

        # Output edges consumed outside the segment; those read by host
        # blocks are copied to the host, the rest (Nop/Benchmark sinks)
        # stay on the device.
        self.out_keys: list[str] = []
        self.host_out_keys: list[str] = []
        for b in blocks:
            for oi in range(len(b.outputs)):
                outside = [c for c in graph.consumers(PortRef(b, oi))
                           if id(c.block) not in in_seg]
                if outside:
                    key = f"{bid[id(b)]}.{oi}"
                    self.out_keys.append(key)
                    if any(_wants_host(c.block) for c in outside):
                        self.host_out_keys.append(key)

        # a block downstream of a batch-producing block (ChannelizerBlock)
        # carries its state per batch element; a channel bank adds its
        # [C] axis in front.  A device source is generated once and its
        # chunk replicated over the bank, so its state stays as it is.
        self.states = {}
        for b in blocks:
            shape = tuple(graph.in_batch.get(id(b), ()))
            if channels and not isinstance(b, SignalSourceBlock):
                shape = (channels,) + shape
            self.states[bid[id(b)]] = broadcast_state(b.init_state(), shape)

    def run(self, ext: dict) -> dict:
        """One chunk through the segment's blocks, in order.  Under a time
        mesh each input [..., T] is reshaped to its shards [D, ..., T/D]
        (after the wire conversion, which is per sample), the blocks run
        their sharded forms, and each output is joined back."""
        ax = self.time_axis
        vals = {}
        for k, v in ext.items():
            v = self.ingest[k](v) if k in self.ingest else v
            vals[k] = split_shards(v, ax.n_local) if ax else v
        bid, edges = self.bid, self._edges
        for b in self.blocks:
            k = bid[id(b)]
            if isinstance(b, SignalSourceBlock):
                if ax:
                    st, outs = b.generate_sharded(
                        self.states[k], self._gen_len[k] // ax.size, ax)
                else:
                    st, outs = b.generate(self.states[k], self._gen_len[k])
                if self.channels:    # [..., T] -> [..., C, T]
                    outs = tuple(y.unsqueeze(-2).expand(
                        y.shape[:-1] + (self.channels, y.shape[-1]))
                        for y in (outs if isinstance(
                            outs, (tuple, list)) else (outs,)))
            else:
                ins = [vals[f"{bid[id(src.block)]}.{src.index}"]
                       for src in (edges[PortRef(b, i)]
                                   for i in range(len(b.inputs)))]
                if ax:
                    st, outs = b.process_sharded(self.states[k], *ins,
                                                 axis=ax)
                else:
                    st, outs = b.process(self.states[k], *ins)
            self.states[k] = st
            if b.masked_output or (len(b.outputs) == 1
                                   and not isinstance(outs, (tuple, list))):
                outs = (outs,)          # a (values, mask) pair is one port
            for oi, y in enumerate(outs):
                vals[f"{k}.{oi}"] = y
        if ax:
            return {ok: join_shards(vals[ok]) for ok in self.out_keys}
        return {ok: vals[ok] for ok in self.out_keys}


class _Prefetcher:
    """Read-ahead pump stage: a background thread reads host sources and
    copies the chunk to the device, so file I/O, host format conversion
    and the host->device copy of chunk k+1 overlap the device compute of
    chunk k.  The reference gets the same overlap
    from its process-per-block pipes (composite.lua:568-636); here one
    thread + a small bounded queue replaces the socketpair transport.

    ``read_fn(seq)`` is Runner._read_chunk: chunk ``seq`` (its sequence
    number, from 0, in read order) read and moved to the device, as
    (values, nvalid, eof, seq), or None at EOF.  Errors it raises
    propagate out of :meth:`get` on the pump thread.  ``tracer`` is made
    the thread's current one (core/trace.py).

    The reader runs up to ``depth`` chunks ahead of consumption; ``budget``
    (set from Runner.run's max_chunks) bounds the read-ahead so a bounded
    run never reads source chunks it will not consume.
    """

    def __init__(self, read_fn, depth: int = 3, budget: int | None = None,
                 tracer: trace_mod.Tracer | None = None):
        self._read_fn = read_fn
        self._tracer = tracer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._budget = budget
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="read-ahead")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _main(self):
        trace_mod.set_current(self._tracer)
        try:
            n_read = 0
            while not self._stop.is_set():
                if self._budget is not None and n_read >= self._budget:
                    chunk = None
                else:
                    chunk = self._read_fn(n_read)
                    n_read += 1
                self._put(chunk)
                if chunk is None or chunk[2]:
                    return
        except BaseException as exc:  # noqa: BLE001 — surfaced from get()
            self.error = exc
            self._put(None)

    def get(self):
        """Next (values, nvalid, eof, seq) chunk, or None at EOF.
        Re-raises any reader-thread exception."""
        while True:
            if self.error is not None and self._q.empty():
                err, self.error = self.error, None
                raise err
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self.error is None:
                    return None
                continue
            if item is None and self.error is not None:
                err, self.error = self.error, None
                raise err
            return item

    def shutdown(self, timeout: float = 5.0):
        self._stop.set()
        self._thread.join(timeout=timeout)


class Runner:
    """Runs a flow graph on one device (``device=None`` is the CUDA card;
    ``"cpu"`` runs the plain path) in ``mode`` "fused" or "eager" (module
    docstring); ``trace`` None reads LUARADIO_TPU_TRACE.

    ``channels=C`` runs it as a bank of C channels (module docstring).
    It is taken from the graph's BankSource when not given; a BankSource
    of another width, or a host source that is not a BankSource, raises,
    and so does a host block that feeds a device block (its per-channel
    output has no common length to batch).

    ``mesh`` (parallel/mesh.py) shards the graph: an axis named
    ``time_axis`` splits every stream's time axis into shards, an axis
    named ``channel_axis`` banks channels (``channels`` defaults to its
    size), in fused mode only.  Across processes a mid-graph host block
    under a time split raises: it needs the whole stream in one
    process."""

    def __init__(self, top: CompositeBlock, mode: str = "fused",
                 chunk_size: int | None = None, trace: bool | None = None,
                 optimize: bool = True, mesh=None,
                 channels: int | None = None,
                 channel_axis: str = "channel", time_axis: str = "time", *,
                 device=None):
        from luaradio_tpu_torch.blocks.sources.bank import BankSource
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (choices: "
                             f"{', '.join(MODES)})")
        self.mesh = mesh
        self.time_axis = None           # the mesh's time Axis, if any
        chan_banked = False
        if mesh is not None:
            if mode != "fused":
                raise ValueError("mesh execution requires mode='fused'")
            chan_banked = channel_axis in mesh.axis_names
            if time_axis in mesh.axis_names:
                self.time_axis = mesh.axis(time_axis)
            elif not chan_banked:
                raise ValueError(
                    f"mesh has neither a {channel_axis!r} nor a "
                    f"{time_axis!r} axis: nothing to shard over (axes: "
                    f"{mesh.axis_names})")
            if mesh.multihost and mesh.axis_names[0] not in (channel_axis,
                                                             time_axis):
                raise ValueError(
                    f"mesh: the processes split its first axis "
                    f"{mesh.axis_names[0]!r}, which is neither "
                    f"{channel_axis!r} nor {time_axis!r}")
            if chan_banked and channels is None:
                channels = mesh.shape[channel_axis]
        shards = self.time_axis.size if self.time_axis else 1
        self.mode = mode
        if trace is None:
            trace = trace_mod.enabled_by_env()
        self.tracer = trace_mod.Tracer() if trace else None
        self.graph = g = Graph(top, chunk_size=chunk_size, optimize=optimize,
                               shards=shards, fuse_kernels=mesh is None,
                               device=device)
        self.device = g.device
        self.bid = {id(b): f"b{i}" for i, b in enumerate(g.order)}
        self.sources = [b for b in g.order if isinstance(b, HostSourceBlock)]

        for s in self.sources:
            if isinstance(s, BankSource):
                if channels is None:
                    channels = s.n_channels
                elif s.n_channels != channels:
                    raise ValueError(f"{s.name}: {s.n_channels} channels in "
                                     f"a bank of channels={channels}")
            elif channels:
                raise ValueError(f"{s.name}: a bank of channels={channels} "
                                 f"reads its host streams through a "
                                 f"BankSource")
        self.channels = channels

        # Across processes the mesh's first axis is split: over time each
        # process keeps its contiguous block of every chunk, over channels
        # it runs its range of channels.  ``_split_axes`` names, for a
        # source value [C?, T], the mesh axis of each dimension
        # (parallel/multihost.py local_slices).
        has_mid_host = any(b.domain == "host" and b.outputs
                           and not isinstance(b, HostSourceBlock)
                           for b in g.order)
        self._split_axes = None
        self._chan_local = (0, channels) if channels else None
        if mesh is not None and mesh.multihost:
            time_split = mesh.axis_names[0] == time_axis
            if time_split and has_mid_host:
                raise NotImplementedError(
                    "multihost time sharding: a mid-graph host block needs "
                    "the global stream on one host; use a ('channel',) bank "
                    "mesh (whole channels per host) for framer/decoder "
                    "graphs" if not chan_banked else
                    "multihost channel bank: a channel's time axis spans "
                    "processes, so host blocks cannot see whole channels; "
                    "order the mesh so each process owns whole channels")
            if not time_split and channels % mesh.shape[channel_axis]:
                raise ValueError(
                    f"channels={channels} does not split evenly over the "
                    f"mesh's {mesh.shape[channel_axis]} channel rows")
            self._split_axes = ((channel_axis,) if channels else ()) + (
                time_axis if time_split else None,)
            if channels:
                rows = multihost.local_slices(mesh, (channels,),
                                              (channel_axis,))[0]
                self._chan_local = (rows.start, rows.stop)
        #: channel rows this process runs
        self._rows = (self._chan_local[1] - self._chan_local[0]
                      if channels else None)
        # one clone of each mid-graph host block per channel, each with
        # its own state (framers, decoders); their outputs stay on the host
        self._bank_clones: dict[int, list[Block]] = {}
        if channels:
            for b in g.order:
                if (b.domain != "host" or not b.outputs
                        or isinstance(b, HostSourceBlock)):
                    continue
                if any(c.block.domain == "device"
                       for oi in range(len(b.outputs))
                       for c in g.consumers(PortRef(b, oi))):
                    raise NotImplementedError(
                        f"channel bank: host block {b.name} feeding a "
                        f"device block is not supported")
                self._bank_clones[id(b)] = [copy.deepcopy(b)
                                            for _ in range(self._rows)]

        #: each host source's route to the card (core/ingest.py)
        self.feeds = plan_feeds(self.sources, g, self.bid, self.device)
        self._read_on_pump = mode == "eager" or all(
            f.route == "resident" for f in self.feeds)

        # One segment per stage that contains device blocks.
        self.stage_plan: list[tuple[Segment | None, list[Block]]] = []
        for st in range(g.num_stages):
            dev = [b for b in g.order
                   if g.stage[id(b)] == st and b.domain == "device"]
            host = [b for b in g.order
                    if g.stage[id(b)] == st and b.domain == "host"
                    and not isinstance(b, HostSourceBlock)]
            seg = (Segment(g, dev, self.bid, {
                f.keys[0]: f.ingest for f in self.feeds if f.ingest},
                self._rows, self.time_axis) if dev else None)
            self.stage_plan.append((seg, host))

        # Pipelined pumping (fused mode): when no device block consumes a
        # host block's output, the device segments of chunk k are queued
        # before the host tail of chunk k-1 runs.  Mid-graph host stages
        # feeding device blocks force lockstep order.
        self.pipelined = mode == "fused" and all(
            c.block.domain != "device"
            for (_, hosts) in self.stage_plan for h in hosts
            for oi in range(len(h.outputs))
            for c in g.consumers(PortRef(h, oi)))

        #: host-to-device copies of source and host-block data so far
        #: (from the read-ahead thread and the pump, hence the lock)
        self.h2d_copies = 0
        self._h2d_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._chunk_budget: int | None = None
        self._prefetcher: _Prefetcher | None = None
        self._n_read = 0        # chunks the pump read itself (their seq)
        self.running = False
        self.chunks_processed = 0
        self.error: BaseException | None = None
        self._cleaned_up = False

    # ------------------------------------------------------------------
    def _prefetch_put(self, values: dict) -> dict:
        """A chunk's values with the copied feeds' payloads moved to the
        device (the graph's device, named explicitly: in fused mode this
        runs on the read-ahead thread, in eager mode on the pump).  A
        pinned wire block's copy does not wait: it is queued on the card's
        default stream, which both threads share, so the pump's kernels
        that read the chunk run after it."""
        for f in self.feeds:
            if f.copied:    # device blocks take arrays, never host objects
                for k in f.keys:
                    values[k] = self._to_device(values[k])
        return values

    def _to_device(self, arr) -> torch.Tensor:
        with self._h2d_lock:
            self.h2d_copies += 1
        return to_device(arr, self.device)

    def _next_chunk(self):
        """One chunk of source data (values, nvalid, eof, seq), via the
        read-ahead thread in fused mode (lazily started) or read by the
        pump itself in eager mode; None at EOF.  When every source is
        device-resident there is no host read or copy to overlap, so the
        pump reads the windows itself."""
        if self._read_on_pump:
            seq = self._n_read
            self._n_read += 1
            return self._read_chunk(seq) if self.feeds \
                else ({}, {}, False, seq)
        if self._prefetcher is None:
            self._prefetcher = _Prefetcher(
                self._read_chunk, budget=self._chunk_budget,
                tracer=self.tracer)
        if self.tracer is None:
            return self._prefetcher.get()
        with self.tracer.span("sources.wait") as sp:
            chunk = self._prefetcher.get()
            if chunk is not None:
                sp.chunk = chunk[3]
            return chunk

    def _read_chunk(self, seq: int):
        """Chunk ``seq`` read from the host sources and its device payloads
        copied (spans ``sources.read``, ``sources.h2d``): (values, nvalid,
        eof, seq), or None at EOF."""
        chunk = self._traced("sources.read", seq, self._read_sources)
        if chunk is None:
            return None
        values, nvalid, eof = chunk
        return (self._traced("sources.h2d", seq, self._prefetch_put, values),
                nvalid, eof, seq)

    def _traced(self, name, chunk, fn, *args):
        if self.tracer is None:
            return fn(*args)
        with self.tracer.span(name, chunk):
            return fn(*args)

    def _read_sources(self):
        """One chunk from every host source, each through its feed
        (core/ingest.py): (values, nvalid, eof), or None when the stream
        ended before this chunk.  A short last chunk comes zero-padded to
        the planned length (shapes stay fixed); nvalid trims the outputs."""
        values, nvalid, eof = {}, {}, False
        for f in self.feeds:
            short = f.read(values, nvalid)
            if short is None:
                return None
            eof = eof or short
        if self._split_axes is not None:
            values = {k: self._local(v) for k, v in values.items()}
        return values, nvalid, eof

    def _local(self, v):
        """This process's part of a chunk read in full (every process
        reads the whole chunk): its channel rows, or its contiguous block
        of the time axis.  nvalid stays global."""
        if isinstance(v, list):
            return v
        axes = self._split_axes[-v.ndim:]
        return v[multihost.local_slices(self.mesh, v.shape, axes)]

    def _nv_local(self, block: Block, nv):
        """A global valid count at ``block``'s output as a count within
        this process's time block."""
        if nv is None or self._split_axes is None \
                or self._split_axes[-1] is None:
            return nv
        sl = multihost.local_slices(self.mesh, (self.graph.out_chunk[id(
            block)],), self._split_axes[-1:])[0]
        return min(max(0, nv - sl.start), sl.stop - sl.start)

    def _run_segment(self, seg: Segment, values, nvalid, fetches):
        g = self.graph
        ext = {}
        for k, want in seg.ext_len.items():
            v = values[k]
            if isinstance(v, np.ndarray):  # a host block's output
                v = self._to_device(pad_to(v, want))
            ext[k] = v
        outs = seg.run(ext)
        # start the copies host blocks need now; they complete while the
        # card works on the next chunk (synchronized in _run_hosts)
        for k in seg.host_out_keys:
            v = outs[k]
            outs[k] = (tuple(t.to("cpu", non_blocking=True) for t in v)
                       if isinstance(v, tuple)     # masked: values, mask
                       else v.to("cpu", non_blocking=True))
        if seg.host_out_keys and self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            fetches.append(ev)
        values.update(outs)
        for b in seg.blocks:
            k = self.bid[id(b)]
            nin = min((nvalid.get(f"{self.bid[id(g.edges[PortRef(b, i)].block)]}"
                                  f".{g.edges[PortRef(b, i)].index}",
                                  g.in_chunk[id(b)])
                       for i in range(len(b.inputs))),
                      default=g.out_chunk[id(b)])
            if b.inputs:
                nvalid[f"{k}.0"] = b.out_count(nin)
                for oi in range(1, len(b.outputs)):
                    nvalid[f"{k}.{oi}"] = nvalid[f"{k}.0"]

    @staticmethod
    def _wait_copies(fetches):
        """Wait for the copies back to the host that ``fetches`` (CUDA
        events) mark."""
        while fetches:
            fetches.pop().synchronize()

    def _run_hosts(self, host_blocks, values, nvalid):
        g = self.graph
        for b in host_blocks:
            # a bank's clones, per-channel inputs and masked device
            # outputs go row by row (compacting [C, T] values with a
            # [C, T] mask in one values[mask] would join the channels);
            # a sink that only measures length takes them whole
            srcs = [g.edges[PortRef(b, i)] for i in range(len(b.inputs))]
            if id(b) in self._bank_clones or _wants_host(b) and any(
                    isinstance(values.get(f"{self.bid[id(src.block)]}"
                                          f".{src.index}"), _Banked)
                    or (self.channels and src.block.masked_output)
                    for src in srcs):
                self._run_host_banked(b, values, nvalid)
                continue
            ins = []
            for i in range(len(b.inputs)):
                src = g.edges[PortRef(b, i)]
                sk = f"{self.bid[id(src.block)]}.{src.index}"
                if not _wants_host(b):
                    ins.append(values[sk])
                    continue
                ins.append(_to_host(values[sk], self._nv_local(
                    src.block, nvalid.get(sk)), src.block.masked_output))
            outs = b.process(*ins)
            if outs is not None:
                if not isinstance(outs, tuple):
                    outs = (outs,)
                k = self.bid[id(b)]
                for oi, y in enumerate(outs):
                    values[f"{k}.{oi}"] = y
                    try:
                        nvalid[f"{k}.{oi}"] = len(y)
                    except TypeError:
                        pass

    def _run_host_banked(self, b, values, nvalid):
        """Run host block ``b`` once per channel (clones carry
        per-channel state): a device input is sliced row by row from the
        copy already on the host, a masked one compacted row by row, and
        per-channel host inputs pass through."""
        g = self.graph
        rows = []
        for i in range(len(b.inputs)):
            src = g.edges[PortRef(b, i)]
            sk = f"{self.bid[id(src.block)]}.{src.index}"
            v = values[sk]
            if isinstance(v, _Banked):
                rows.append(v.rows)
                continue
            nv = self._nv_local(src.block, nvalid.get(sk))
            if src.block.masked_output:
                vals, mask = (t.numpy() for t in v)
                if nv is not None and nv < mask.shape[-1]:
                    mask = mask.copy()
                    mask[..., max(0, nv):] = False
                rows.append([vals[c][mask[c]] for c in range(self._rows)])
            else:
                arr = _to_host(v, nv)
                rows.append([arr[c] for c in range(self._rows)])
        clones = self._bank_clones.get(id(b))
        outs = [(clones[c] if clones else b).process(*(r[c] for r in rows))
                for c in range(self._rows)]
        if clones and b.outputs:
            k = self.bid[id(b)]
            for oi in range(len(b.outputs)):
                banked = _Banked(
                    (o[oi] if isinstance(o, tuple) else o)
                    if o is not None else [] for o in outs)
                values[f"{k}.{oi}"] = banked
                nvalid[f"{k}.{oi}"] = len(banked)

    def _dispatch_chunk(self):
        """Phase 1: sources + all device segments (queued on the card).
        Returns (values, nvalid, eof, fetches, seq, t_dispatched) or None
        at EOF; ``t_dispatched`` (perf_counter_ns, only when tracing) ends
        the dispatch, where the chunk's hold starts."""
        chunk = self._next_chunk()
        if chunk is None:
            return None
        values, nvalid, eof, seq = chunk
        fetches: list = []
        for i, (seg, _) in enumerate(self.stage_plan):
            if seg is not None:
                self._traced(f"segment[{i}].dispatch", seq, self._run_segment,
                             seg, values, nvalid, fetches)
        t_dispatched = (time.perf_counter_ns() if self.tracer is not None
                        else None)
        return values, nvalid, eof, fetches, seq, t_dispatched

    def _finish_chunk(self, dispatched):
        """Phase 2: the host tail of a chunk ``_dispatch_chunk`` returned,
        after waiting for its copies."""
        values, nvalid, _, fetches, seq, _ = dispatched
        self._traced("host.d2h_wait", seq, self._wait_copies, fetches)
        if self.tracer is not None:
            self.tracer.resolve_device(seq)
        for i, (_, host_blocks) in enumerate(self.stage_plan):
            if host_blocks:
                self._traced(f"host[{i}].process", seq, self._run_hosts,
                             host_blocks, values, nvalid)
        self.chunks_processed += 1

    def _pump_once(self) -> bool:
        """Lockstep: one chunk through the whole graph.  False at EOF."""
        chunk = self._next_chunk()
        if chunk is None:
            return False
        values, nvalid, eof, seq = chunk
        for i, (seg, host_blocks) in enumerate(self.stage_plan):
            fetches: list = []
            if seg is not None:
                self._traced(f"segment[{i}].dispatch", seq, self._run_segment,
                             seg, values, nvalid, fetches)
            self._traced("host.d2h_wait", seq, self._wait_copies, fetches)
            if host_blocks:
                self._traced(f"host[{i}].process", seq, self._run_hosts,
                             host_blocks, values, nvalid)
        if self.tracer is not None:
            self.tracer.resolve_device(seq)
        self.chunks_processed += 1
        return not eof

    def _run_pipelined(self, max_chunks: int | None):
        """Chunk k's host tail runs after chunk k+1 is dispatched: k is
        held (span ``chunk.hold``) while k-1's host tail runs and k+1 is
        waited for and queued."""
        pending = None
        n = 0
        while not self._stop.is_set():
            cur = self._dispatch_chunk()
            if pending is not None:
                if cur is not None and self.tracer is not None:
                    self.tracer.record("chunk.hold", pending[5],
                                       time.perf_counter_ns(), pending[4])
                self._finish_chunk(pending)
            pending = cur
            if cur is None:
                break
            n += 1
            if cur[2] or (max_chunks is not None and n >= max_chunks):
                break
        if pending is not None:
            self._finish_chunk(pending)

    def run(self, max_chunks: int | None = None):
        """Run to EOF (or error).  A block exception collapses the graph and
        propagates — the analog of the reference's child-crash supervision
        (radio/core/composite.lua:773-847)."""
        self.running = True
        self._chunk_budget = max_chunks
        prev = trace_mod.set_current(self.tracer)
        try:
            if self.pipelined:
                self._run_pipelined(max_chunks)
            else:
                n = 0
                while not self._stop.is_set():
                    if not self._pump_once():
                        break
                    n += 1
                    if max_chunks is not None and n >= max_chunks:
                        break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.tracer is not None:
                self.tracer.resolve_device()
        except BaseException as exc:
            self.error = exc
            raise
        finally:
            trace_mod.set_current(prev)
            self.running = False
            self._cleanup_once()

    def _cleanup_once(self):
        """cleanup() every block exactly once, even if a cleanup itself
        raises mid-way (remaining blocks still cleaned)."""
        if self._cleaned_up:
            return
        self._cleaned_up = True
        if self._prefetcher is not None:
            self._prefetcher.shutdown()
            self._prefetcher = None
        first_err = None
        clones = [c for cl in self._bank_clones.values() for c in cl]
        for b in list(self.graph.order) + clones:
            try:
                b.cleanup()
            except BaseException as exc:  # noqa: BLE001 — keep cleaning
                if first_err is None:
                    first_err = exc
        if first_err is not None and self.error is None:
            raise first_err

    # -- threaded start/wait/stop (reference composite.lua:534,886,913) ----
    def start(self):
        self._thread = threading.Thread(target=self._thread_main, daemon=True)
        self.running = True
        self._thread.start()

    def _thread_main(self):
        try:
            self.run()
        except BaseException:  # noqa: BLE001 — surfaced via wait()/status()
            pass  # self.error holds it; re-raised from wait()

    def stop(self, timeout: float | None = None):
        self._stop.set()
        self.wait(timeout=timeout)

    def wait(self, timeout: float | None = None):
        """Join the pump thread; re-raise any block exception here (the
        reference surfaces child crashes from wait()).  With ``timeout``,
        raise TimeoutError if the graph is still running by then."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"flow graph still running after {timeout} s")
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err


__all__ = ["MODES", "Runner", "Segment", "broadcast_state"]
