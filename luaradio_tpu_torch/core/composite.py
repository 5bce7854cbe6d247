"""Flow graph construction and compilation.

The reference's CompositeBlock (radio/core/composite.lua)
builds the graph (connect, :111), validates it, topologically orders it
(:261-298), differentiates types (:314), wires socketpair pipes (:381),
validates rates (:394), and then forks one OS process per block (:568-636).

Port redesign: the same *front half* (graph build, flatten, topo sort,
type differentiation, rate validation) feeds a different back half: the
graph is partitioned into **stages** — maximal groups of device blocks that
run as one step function on the card, with host blocks (file I/O, sinks)
running between them.  Chunk sizes per edge are planned statically from the
exact rational rate ratios.
"""

from __future__ import annotations

import math
from fractions import Fraction

from luaradio_tpu_torch.core.block import Block, SourceBlock


class PortRef:
    __slots__ = ("block", "index")

    def __init__(self, block: Block, index: int):
        self.block = block
        self.index = index

    def __eq__(self, other):
        return self.block is other.block and self.index == other.index

    def __hash__(self):
        return hash((id(self.block), self.index))

    def __repr__(self):
        return f"{self.block.name}[{self.index}]"


def _in_index(block: Block, name: str) -> int:
    for i, p in enumerate(block.inputs):
        if p.name == name:
            return i
    raise ValueError(f"{block.name}: no input port named {name!r}")


def _out_index(block: Block, name: str) -> int:
    for i, p in enumerate(block.outputs):
        if p.name == name:
            return i
    raise ValueError(f"{block.name}: no output port named {name!r}")


class CompositeBlock(Block):
    """A flow graph; also usable as a hierarchical block with aliased ports
    (reference composites, e.g. radio/composites/tuner.lua:30-48)."""

    def __init__(self):
        super().__init__()
        self._blocks: list[Block] = []
        self._connections: list[tuple[Block, str, Block, str]] = []
        self._runner = None  # set by run()/start()

    # -- graph construction (mirrors composite.lua:111-186) ----------------
    def connect(self, *args):
        if len(args) >= 2 and all(isinstance(a, Block) for a in args):
            # Linear form: connect(b1, b2, b3, ...) pairs first out -> first in.
            for src, dst in zip(args, args[1:]):
                self._connect_by_name(src, src.outputs[0].name,
                                      dst, dst.inputs[0].name)
            return args[-1]
        if len(args) == 4:
            src, src_port, dst, dst_port = args
            # Allow either direction like the reference: (blk, out, blk, in).
            self._connect_by_name(src, src_port, dst, dst_port)
            return dst
        raise ValueError("connect(): expected blocks, or (src, 'out', dst, 'in')")

    def _connect_by_name(self, src: Block, src_port: str, dst: Block, dst_port: str):
        for b in (src, dst):
            if b is not self and b not in self._blocks:
                self._blocks.append(b)
        # Alias declarations reference one of self's external ports; like the
        # reference (composite.lua:111-186) the direction is inferred from
        # the *kind* of self's port, so both connect(self, 'out', inner,
        # 'out') and connect(inner, 'out', self, 'out') declare an output
        # alias.
        if dst is self:
            src, src_port, dst, dst_port = dst, dst_port, src, src_port
        if src is self:
            in_names = {p.name for p in self.inputs}
            if src_port in in_names:
                # input alias: (self, 'in') -> (inner, 'in')
                _in_index(dst, dst_port)
                self._connections.append((self, src_port, dst, dst_port))
            else:
                # output alias: (inner, 'out') -> (self, 'out')
                _out_index(self, src_port)
                _out_index(dst, dst_port)
                self._connections.append((dst, dst_port, self, src_port))
            return
        else:
            _out_index(src, src_port)
            _in_index(dst, dst_port)
            for (s, sp, d, dp) in self._connections:
                if d is dst and dp == dst_port and d is not self:
                    raise ValueError(
                        f"{dst.name}.{dst_port} already connected")
        self._connections.append((src, src_port, dst, dst_port))

    # -- flattening (reference _crawl_connections, composite.lua:343) ------
    def _flatten(self):
        """Resolve hierarchical composites into leaf blocks + leaf edges.

        Returns (leaf_blocks, edges) where edges maps input PortRef ->
        output PortRef.
        """
        leaf_blocks: list[Block] = []
        raw_conns: list[tuple[Block, str, Block, str]] = []
        in_alias: dict[tuple[int, str], list[tuple[Block, str]]] = {}
        out_alias: dict[tuple[int, str], tuple[Block, str]] = {}

        def collect(comp: "CompositeBlock"):
            for child in comp._blocks:
                if isinstance(child, CompositeBlock):
                    collect(child)
                else:
                    if child not in leaf_blocks:
                        leaf_blocks.append(child)
            for (src, sp, dst, dp) in comp._connections:
                if src is comp:
                    in_alias.setdefault((id(comp), sp), []).append((dst, dp))
                elif dst is comp:
                    out_alias[(id(comp), dp)] = (src, sp)
                else:
                    raw_conns.append((src, sp, dst, dp))

        collect(self)

        def resolve_src(src: Block, sp: str) -> tuple[Block, str]:
            while isinstance(src, CompositeBlock):
                key = (id(src), sp)
                if key not in out_alias:
                    raise ValueError(
                        f"{src.name}: unaliased composite output {sp!r}")
                src, sp = out_alias[key]
            return src, sp

        def resolve_dst(dst: Block, dp: str) -> list[tuple[Block, str]]:
            if not isinstance(dst, CompositeBlock):
                return [(dst, dp)]
            key = (id(dst), dp)
            if key not in in_alias:
                raise ValueError(f"{dst.name}: unaliased composite input {dp!r}")
            out = []
            for (d, p) in in_alias[key]:
                out.extend(resolve_dst(d, p))
            return out

        edges: dict[PortRef, PortRef] = {}
        for (src, sp, dst, dp) in raw_conns:
            s, spn = resolve_src(src, sp)
            for (d, dpn) in resolve_dst(dst, dp):
                dref = PortRef(d, _in_index(d, dpn))
                if dref in edges:
                    raise ValueError(f"{d.name}.{dpn} connected twice")
                edges[dref] = PortRef(s, _out_index(s, spn))
        return leaf_blocks, edges

    # -- run API (mirrors composite.lua:514-950) ---------------------------
    def run(self, max_chunks: int | None = None,
            chunk_size: int | None = None, optimize: bool = True,
            device=None):
        """Run the flow graph to completion (EOF of any source).

        ``device`` defaults to the CUDA card (core/platform.py
        resolve_device); ``device="cpu"`` runs the plain PyTorch path."""
        from luaradio_tpu_torch.core.runtime import Runner
        runner = Runner(self, chunk_size=chunk_size, optimize=optimize,
                        device=device)
        runner.run(max_chunks=max_chunks)
        return self

    def start(self, chunk_size: int | None = None,
              optimize: bool = True, device=None):
        from luaradio_tpu_torch.core.runtime import Runner
        if self._runner is not None and self._runner.running:
            raise RuntimeError("flow graph already running")
        self._runner = Runner(self, chunk_size=chunk_size,
                              optimize=optimize, device=device)
        self._runner.start()
        return self

    def stop(self, timeout: float | None = None):
        if self._runner is not None:
            self._runner.stop(timeout=timeout)
        return self

    def wait(self, timeout: float | None = None):
        """Join the running graph; with ``timeout``, raise TimeoutError
        if it has not ended by then."""
        if self._runner is not None:
            self._runner.wait(timeout=timeout)
        return self

    def status(self) -> dict:
        """Reference composite.lua:858 reports {running}; the runtime
        additionally exposes any captured block exception (a crashed block
        collapses the graph — see Runner.wait())."""
        if self._runner is None:
            return {"running": False}
        return {"running": self._runner.running,
                "error": self._runner.error}


class Graph:
    """Flattened, validated, typed, rate-checked, optimized, chunk-planned
    graph."""

    def __init__(self, top: CompositeBlock, chunk_size: int | None = None,
                 optimize: bool = True, device=None):
        from luaradio_tpu_torch.core.platform import resolve_device
        self.device = resolve_device(device)
        self.blocks, self.edges = top._flatten()
        for b in self.blocks:
            b.device = self.device
        self._validate_connected()
        self.order = self._topo_sort()
        self._differentiate()
        self._demote_duals()
        self._validate_rates()
        from luaradio_tpu_torch.core import optimize as opt
        self.n_fusions = opt.optimize_graph(self) if optimize else 0
        self._propagate_batch()
        self._plan_chunks(chunk_size)
        self._assign_stages()
        self._initialize()

    # -- batch-shape propagation (leading channel axes; see Block.
    #    out_batch_shape) ------------------------------------------------
    def _propagate_batch(self):
        self.batch: dict[int, tuple] = {}      # output batch shape
        self.in_batch: dict[int, tuple] = {}   # input batch shape (= the
        # shape carried state is allocated with; a batch-PRODUCING block's
        # own state is unbatched)
        for b in self.order:
            ins = []
            for i in range(len(b.inputs)):
                src = self.edges[PortRef(b, i)]
                ins.append(self.batch[id(src.block)])
            self.in_batch[id(b)] = max(ins, key=len) if ins else ()
            self.batch[id(b)] = b.out_batch_shape(ins)

    # -- validation (composite.lua:302-341) --------------------------------
    def _validate_connected(self):
        for b in self.blocks:
            for i, p in enumerate(b.inputs):
                if PortRef(b, i) not in self.edges:
                    raise ValueError(f"{b.name}: unconnected input {p.name!r}")

    def preds(self, b: Block) -> list[Block]:
        out = []
        for i in range(len(b.inputs)):
            src = self.edges[PortRef(b, i)]
            if src.block not in out:
                out.append(src.block)
        return out

    # -- topological order (composite.lua:261-298) --------------------------
    def _topo_sort(self) -> list[Block]:
        indeg = {id(b): 0 for b in self.blocks}
        succs: dict[int, list[Block]] = {id(b): [] for b in self.blocks}
        for dref, sref in self.edges.items():
            indeg[id(dref.block)] = indeg[id(dref.block)]  # ensure key
        for b in self.blocks:
            for p in self.preds(b):
                succs[id(p)].append(b)
                indeg[id(b)] += 1
        # deduplicate multi-edges in indegree: recompute properly
        indeg = {id(b): len(self.preds(b)) for b in self.blocks}
        ready = [b for b in self.blocks if indeg[id(b)] == 0]
        order = []
        seen_succ = {id(b): list(dict.fromkeys((id(s), s) for s in succs[id(b)]))
                     for b in self.blocks}
        while ready:
            b = ready.pop(0)
            order.append(b)
            for (_, s) in seen_succ[id(b)]:
                indeg[id(s)] -= 1
                if indeg[id(s)] == 0:
                    ready.append(s)
        if len(order) != len(self.blocks):
            raise ValueError("flow graph contains a cycle")
        return order

    # -- type differentiation (block.lua:296, composite.lua:314) ------------
    def _differentiate(self):
        for b in self.order:
            in_types = []
            for i in range(len(b.inputs)):
                src = self.edges[PortRef(b, i)]
                in_types.append(src.block.get_output_type(src.index))
            b.differentiate(in_types)

    # -- dual-block demotion -------------------------------------------------
    # Device blocks cannot consume variable-rate streams (static shapes).
    # Blocks downstream of a variable-output host block are demoted to host
    # mode if they declare dual=True (e.g. Slicer, DifferentialDecoder in
    # framer chains), else it's a graph error.
    def _demote_duals(self):
        tainted: set[int] = set()
        for b in self.order:
            pred_tainted = any(id(p) in tainted for p in self.preds(b))
            if b.domain == "device" and pred_tainted:
                if getattr(b, "dual", False):
                    b.domain = "host"
                    b.process = b.process_host
                else:
                    raise ValueError(
                        f"{b.name}: device block cannot consume a "
                        f"variable-rate stream (not dual-capable)")
            if (getattr(b, "variable_output", False)
                    or (b.domain == "host" and pred_tainted)):
                tainted.add(id(b))

    # -- rate propagation & validation (composite.lua:394) ------------------
    def _validate_rates(self):
        for b in self.order:
            if isinstance(b, SourceBlock) and not b.inputs:
                continue  # source: rate from itself
            rates = []
            for i in range(len(b.inputs)):
                src = self.edges[PortRef(b, i)]
                rates.append(src.block.get_rate())
            if not rates:
                continue
            r0 = rates[0]
            for r in rates[1:]:
                if not math.isclose(r, r0, rel_tol=1e-9):
                    raise ValueError(
                        f"{b.name}: mismatched input rates {rates}")
            b.input_rate = r0

    # -- chunk planning ------------------------------------------------------
    # Each edge gets a static chunk length proportional to its sample rate, so
    # every step sees the same shapes chunk after chunk.  q[block] is the
    # block's *input* chunk length relative to an arbitrary unit; sources are
    # seeded at their rate ratio so multi-source graphs stay consistent.
    DEFAULT_CHUNK = 1 << 18  # target samples per chunk at the fastest edge

    def _plan_chunks(self, chunk_size: int | None):
        target = chunk_size or self.DEFAULT_CHUNK
        out_q: dict[int, Fraction] = {}  # id(block) -> output chunk fraction

        # Seed: express every source's output chunk relative to the first
        # source via the (float) rate ratio snapped to an exact rational.
        sources = [b for b in self.order if not b.inputs]
        if not sources:
            raise ValueError("flow graph has no sources")
        base_rate = sources[0].get_rate()
        for s in sources:
            ratio = s.get_rate() / base_rate
            q = Fraction(ratio).limit_denominator(1 << 20)
            # Guard the rational snap: an irrational/near-miss rate pair
            # would silently quantize chunk sizes and skew timing.
            if ratio and abs(float(q) / ratio - 1.0) > 1e-9:
                raise ValueError(
                    f"{s.name}: source rate ratio {ratio!r} (vs "
                    f"{sources[0].name}) is not a small rational; "
                    f"multi-source graphs need commensurable rates")
            out_q[id(s)] = q

        for b in self.order:
            if not b.inputs:
                continue
            qs = []
            for i in range(len(b.inputs)):
                src = self.edges[PortRef(b, i)]
                qs.append(out_q[id(src.block)])
            if any(q != qs[0] for q in qs):
                raise ValueError(f"{b.name}: inconsistent input chunk ratios {qs}")
            out_q[id(b)] = qs[0] * b.get_rate_ratio()

        # Pick the base so every block's input chunk is an integer multiple of
        # its chunk_multiple().
        required = 1
        for b in self.order:
            q = out_q[id(b)] / b.get_rate_ratio() if b.inputs else out_q[id(b)]
            m = b.chunk_multiple() if b.domain == "device" else 1
            # base * q must be a positive integer divisible by m
            d = (q.denominator * m) // math.gcd(q.numerator, q.denominator * m)
            required = required // math.gcd(required, d) * d
            if required > (1 << 26):
                raise ValueError(
                    f"chunk planning: combined rate-ratio/chunk-multiple "
                    f"constraints force chunks of >= {required} samples "
                    f"(at {b.name}); use commensurable rates or rational "
                    f"resampling with smaller factors")

        max_q = max(out_q[id(b)] for b in self.order)
        base = max(1, round(target / float(max_q)))
        base = ((base + required - 1) // required) * required

        self.in_chunk: dict[int, int] = {}
        self.out_chunk: dict[int, int] = {}
        for b in self.order:
            oq = out_q[id(b)]
            self.out_chunk[id(b)] = int(base * oq)
            iq = oq / b.get_rate_ratio() if b.inputs else oq
            self.in_chunk[id(b)] = int(base * iq)
            if b.inputs and self.in_chunk[id(b)] <= 0:
                raise ValueError(f"{b.name}: zero-size chunk; increase chunk_size")

    # -- stage assignment (device-segment partitioning) ----------------------
    # stage(b) increments every time the domain changes along a path.  All
    # device blocks with equal stage run in ONE segment step; host blocks
    # run between stages.  See runtime.py.
    def _assign_stages(self):
        stage: dict[int, int] = {}
        for b in self.order:
            s = 0
            for p in self.preds(b):
                ps = stage[id(p)]
                if p.domain != b.domain:
                    ps += 1
                s = max(s, ps)
            stage[id(b)] = s
        self.stage = stage
        self.num_stages = 1 + max(stage.values()) if stage else 0

    def _initialize(self):
        for b in self.order:
            b.initialize()

    # -- helpers -------------------------------------------------------------
    def consumers(self, src: PortRef) -> list[PortRef]:
        return [d for d, s in self.edges.items() if s == src]


__all__ = ["CompositeBlock", "Graph", "PortRef"]
