"""Flow-graph execution.

The reference runs one OS process per block connected by UNIX socketpairs,
with a poll()-based hot loop of read -> deserialize -> process -> serialize
-> write (radio/core/composite.lua:568-636, radio/core/block.lua:556-608).

Port design: each *stage* of device blocks runs as one step function
``step(states, ext_inputs) -> (states, outputs)`` over torch tensors on the
graph's device; block boundaries inside a segment cost one tensor hand-off.
A host "pump" drives chunks: a read-ahead thread reads host sources and
copies each chunk to the card, the pump feeds the segments, and boundary
outputs are copied back to the host asynchronously for the host blocks
(file sinks).  PyTorch queues the card's work asynchronously, so host I/O
for one chunk overlaps device compute of the previous one.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np
import torch

from luaradio_tpu_torch.core.block import (Block, HostSourceBlock,
                                           SignalSourceBlock, SinkBlock)
from luaradio_tpu_torch.core.composite import CompositeBlock, Graph, PortRef
from luaradio_tpu_torch.ops.complexutil import to_device


def _to_host(value, n_valid=None):
    """Host numpy view of an edge value (already copied off the card by
    the pump), trimmed to its valid samples.  Time is the LAST axis."""
    if isinstance(value, (list, tuple)):
        return value
    arr = value.numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    if n_valid is not None and n_valid < arr.shape[-1]:
        arr = arr[..., :max(0, n_valid)]
    return arr


def _wants_host(block: Block) -> bool:
    return not (isinstance(block, SinkBlock) and not block.wants_data)


class Segment:
    """A maximal group of device blocks run as one step function."""

    def __init__(self, graph: Graph, blocks: list[Block], bid: dict[int, str],
                 wire_ingest: dict[str, Any] | None = None):
        self.blocks = blocks
        self.bid = bid
        self.wire_ingest = wire_ingest or {}
        self._edges = graph.edges
        self._gen_len = {bid[id(b)]: graph.out_chunk[id(b)] for b in blocks
                         if isinstance(b, SignalSourceBlock)}
        in_seg = {id(b) for b in blocks}

        # External input edges (values produced outside this segment).
        self.ext_keys: list[str] = []
        for b in blocks:
            for i in range(len(b.inputs)):
                src = graph.edges[PortRef(b, i)]
                if id(src.block) not in in_seg:
                    key = f"{bid[id(src.block)]}.{src.index}"
                    if key not in self.ext_keys:
                        self.ext_keys.append(key)

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

        self.states = {}
        for b in blocks:
            st = b.init_state()
            batch = tuple(graph.in_batch.get(id(b), ()))
            if batch and st is not None:
                st = st.expand(batch + st.shape).clone()
            self.states[bid[id(b)]] = st

    def run(self, ext: dict) -> dict:
        """One chunk through the segment's blocks, in order."""
        vals = {}
        for k, v in ext.items():
            vals[k] = self.wire_ingest[k](v) if k in self.wire_ingest else v
        bid, edges = self.bid, self._edges
        for b in self.blocks:
            k = bid[id(b)]
            if isinstance(b, SignalSourceBlock):
                st, outs = b.generate(self.states[k], self._gen_len[k])
            else:
                ins = [vals[f"{bid[id(src.block)]}.{src.index}"]
                       for src in (edges[PortRef(b, i)]
                                   for i in range(len(b.inputs)))]
                st, outs = b.process(self.states[k], *ins)
            self.states[k] = st
            if len(b.outputs) == 1 and not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for oi, y in enumerate(outs):
                vals[f"{k}.{oi}"] = y
        return {ok: vals[ok] for ok in self.out_keys}


class _Prefetcher:
    """Read-ahead pump stage: a background thread reads host sources,
    converts wire formats, and copies the chunk to the device, so file
    I/O, format conversion, and the host->device copy of chunk k+1 overlap
    the device compute of chunk k.  The reference gets the same overlap
    from its process-per-block pipes (composite.lua:568-636); here one
    thread + a small bounded queue replaces the socketpair transport.

    ``read_fn`` is Runner._read_sources; ``put_fn(key, arr)`` moves a
    payload to the device (returns the value to enqueue).  Errors raised by
    either propagate out of :meth:`get` on the pump thread.

    The reader runs up to ``depth`` chunks ahead of consumption; ``budget``
    (set from Runner.run's max_chunks) bounds the read-ahead so a bounded
    run never reads source chunks it will not consume.
    """

    def __init__(self, read_fn, put_fn, depth: int = 3,
                 budget: int | None = None):
        self._read_fn = read_fn
        self._put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._budget = budget
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._main, daemon=True)
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
        try:
            n_read = 0
            while not self._stop.is_set():
                if self._budget is not None and n_read >= self._budget:
                    chunk = None
                else:
                    chunk = self._read_fn()
                    n_read += 1
                if chunk is not None:
                    values, nvalid, eof = chunk
                    values = {k: self._put_fn(k, v) for k, v in values.items()}
                    chunk = (values, nvalid, eof)
                self._put(chunk)
                if chunk is None or chunk[2]:
                    return
        except BaseException as exc:  # noqa: BLE001 — surfaced from get()
            self.error = exc
            self._put(None)

    def get(self):
        """Next (values, nvalid, eof) chunk, or None at EOF.  Re-raises any
        reader-thread exception."""
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
    ``"cpu"`` runs the plain path)."""

    def __init__(self, top: CompositeBlock, chunk_size: int | None = None,
                 optimize: bool = True, device=None):
        self.graph = g = Graph(top, chunk_size=chunk_size, optimize=optimize,
                               device=device)
        self.device = g.device
        self.bid = {id(b): f"b{i}" for i, b in enumerate(g.order)}
        self._by_bid = {f"b{i}": b for i, b in enumerate(g.order)}
        self.sources = [b for b in g.order if isinstance(b, HostSourceBlock)]

        # A host source whose outputs feed only device blocks has its
        # chunks copied to the device by the read-ahead thread, as raw
        # wire items where the source converts exactly on the device.
        self.wire_ingest: dict[str, Any] = {}
        self._wire_srcs: set[int] = set()
        self._transfer_keys: set[str] = set()
        for s in self.sources:
            keys = [f"{self.bid[id(s)]}.{oi}" for oi in range(len(s.outputs))]
            all_dev = all(c.block.domain == "device"
                          for oi in range(len(s.outputs))
                          for c in g.consumers(PortRef(s, oi)))
            if not all_dev:
                continue
            self._transfer_keys.update(keys)
            ing = s.device_ingest()
            if ing is not None and len(s.outputs) == 1:
                self.wire_ingest[keys[0]] = ing
                self._wire_srcs.add(id(s))

        # One segment per stage that contains device blocks.
        self.stage_plan: list[tuple[Segment | None, list[Block]]] = []
        for st in range(g.num_stages):
            dev = [b for b in g.order
                   if g.stage[id(b)] == st and b.domain == "device"]
            host = [b for b in g.order
                    if g.stage[id(b)] == st and b.domain == "host"
                    and not isinstance(b, HostSourceBlock)]
            seg = Segment(g, dev, self.bid, self.wire_ingest) if dev else None
            self.stage_plan.append((seg, host))

        # Pipelined pumping: when no device block consumes a host block's
        # output, the device segments of chunk k are queued before the host
        # tail of chunk k-1 runs.  Mid-graph host stages feeding device
        # blocks force lockstep order.
        self.pipelined = all(
            c.block.domain != "device"
            for (_, hosts) in self.stage_plan for h in hosts
            for oi in range(len(h.outputs))
            for c in g.consumers(PortRef(h, oi)))

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._chunk_budget: int | None = None
        self._prefetcher: _Prefetcher | None = None
        self.running = False
        self.chunks_processed = 0
        self.error: BaseException | None = None
        self._cleaned_up = False

    # ------------------------------------------------------------------
    def _prefetch_put(self, key: str, value):
        """Read-ahead hook: copy payloads that only device blocks consume
        to the device (the graph's device, named explicitly: this runs on
        the read-ahead thread)."""
        if key not in self._transfer_keys or not isinstance(value, np.ndarray):
            return value
        return to_device(value, self.device)

    def _next_chunk(self):
        """One chunk of source data, via the read-ahead thread (lazily
        started)."""
        if not self.sources:
            return {}, {}, False
        if self._prefetcher is None:
            self._prefetcher = _Prefetcher(self._read_sources,
                                           self._prefetch_put,
                                           budget=self._chunk_budget)
        return self._prefetcher.get()

    def _read_sources(self):
        """Read one chunk from every host source.  Returns (values, nvalid,
        eof) or None when the stream ended before this chunk.  The final
        partial chunk is zero-padded to the planned length (shapes stay
        fixed); nvalid trims the outputs."""
        g = self.graph
        values: dict[str, Any] = {}
        nvalid: dict[str, int] = {}
        eof = False
        for s in self.sources:
            want = g.out_chunk[id(s)]
            if id(s) in self._wire_srcs:
                wr = s.wire_read(want)
                if wr is None:
                    return None
                raw, nv = wr
                k = getattr(s, "_wire_factor", 1)
                if nv < want:
                    eof = True
                    pad = np.zeros(raw.shape[:-1] + (want * k - raw.shape[-1],),
                                   dtype=raw.dtype)
                    raw = np.concatenate([raw, pad], axis=-1)
                key = f"{self.bid[id(s)]}.0"
                values[key] = raw
                nvalid[key] = nv
                continue
            data = s.read(want)
            if data is None:
                return None
            if not isinstance(data, tuple):
                data = (data,)
            for oi, arr in enumerate(data):
                key = f"{self.bid[id(s)]}.{oi}"
                if isinstance(arr, list):
                    values[key] = arr
                    nvalid[key] = len(arr)
                    continue
                arr = np.asarray(arr)
                nv = arr.shape[-1]
                if nv < want:
                    eof = True
                    pad = np.zeros(arr.shape[:-1] + (want - nv,),
                                   dtype=arr.dtype)
                    arr = np.concatenate([arr, pad], axis=-1)
                values[key] = arr
                nvalid[key] = nv
        if any(nvalid.get(f"{self.bid[id(s)]}.0", 1) == 0
               for s in self.sources):
            return None
        return values, nvalid, eof

    def _run_segment(self, seg: Segment, values, nvalid, fetches):
        g = self.graph
        ext = {}
        for k in seg.ext_keys:
            v = values[k]
            if isinstance(v, np.ndarray):  # a host block's output
                # the last chunk may come short: pad it to the planned
                # length (nvalid trims the outputs again)
                want = g.out_chunk[id(self._by_bid[k.split(".")[0]])]
                if v.shape[-1] < want:
                    v = np.concatenate([v, np.zeros(
                        v.shape[:-1] + (want - v.shape[-1],), v.dtype)],
                        axis=-1)
                v = to_device(v, self.device)
            ext[k] = v
        outs = seg.run(ext)
        # start the copies host blocks need now; they complete while the
        # card works on the next chunk (synchronized in _run_hosts)
        for k in seg.host_out_keys:
            outs[k] = outs[k].to("cpu", non_blocking=True)
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

    def _run_hosts(self, host_blocks, values, nvalid, fetches):
        g = self.graph
        while fetches:
            fetches.pop().synchronize()
        for b in host_blocks:
            ins = []
            for i in range(len(b.inputs)):
                src = g.edges[PortRef(b, i)]
                sk = f"{self.bid[id(src.block)]}.{src.index}"
                if not _wants_host(b):
                    ins.append(values[sk])
                    continue
                ins.append(_to_host(values[sk], nvalid.get(sk)))
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

    def _dispatch_chunk(self):
        """Phase 1: sources + all device segments (queued on the card).
        Returns (values, nvalid, eof, fetches) or None at EOF."""
        chunk = self._next_chunk()
        if chunk is None:
            return None
        values, nvalid, eof = chunk
        fetches: list = []
        for seg, _ in self.stage_plan:
            if seg is not None:
                self._run_segment(seg, values, nvalid, fetches)
        return values, nvalid, eof, fetches

    def _finish_chunk(self, values, nvalid, fetches):
        """Phase 2: the host tail (waits for this chunk's copies)."""
        for _, host_blocks in self.stage_plan:
            self._run_hosts(host_blocks, values, nvalid, fetches)
        self.chunks_processed += 1

    def _pump_once(self) -> bool:
        """Lockstep: one chunk through the whole graph.  False at EOF."""
        chunk = self._next_chunk()
        if chunk is None:
            return False
        values, nvalid, eof = chunk
        for seg, host_blocks in self.stage_plan:
            fetches: list = []
            if seg is not None:
                self._run_segment(seg, values, nvalid, fetches)
            self._run_hosts(host_blocks, values, nvalid, fetches)
        self.chunks_processed += 1
        return not eof

    def _run_pipelined(self, max_chunks: int | None):
        pending = None
        n = 0
        while not self._stop.is_set():
            cur = self._dispatch_chunk()
            if pending is not None:
                self._finish_chunk(*pending[:2], pending[3])
            pending = cur
            if cur is None:
                break
            n += 1
            if cur[2] or (max_chunks is not None and n >= max_chunks):
                break
        if pending is not None:
            self._finish_chunk(*pending[:2], pending[3])

    def run(self, max_chunks: int | None = None):
        """Run to EOF (or error).  A block exception collapses the graph and
        propagates — the analog of the reference's child-crash supervision
        (radio/core/composite.lua:773-847)."""
        self.running = True
        self._chunk_budget = max_chunks
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
        except BaseException as exc:
            self.error = exc
            raise
        finally:
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
        for b in self.graph.order:
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


__all__ = ["Runner", "Segment"]
