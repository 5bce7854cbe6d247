"""Block model.

The reference's block base class (radio/core/block.lua:238-485)
provides: multiple *type signatures* per block, differentiation (choosing the
signature that matches the connected input types and binding the matching
process/initialize variants), sample-rate propagation, and the
instantiate/initialize/process/cleanup lifecycle.

Port redesign: a block is a *function over chunks*.  Device blocks
("SignalBlock") expose

    init_state() -> tensor or tuple of tensors
    process(state, *xs) -> (state', ys)

where xs/ys are torch tensors on the graph's device whose **last axis is
time** (leading axes are broadcast batch/channel dims).  A flow graph runs
consecutive device blocks as one step function on the card (core/runtime.py);
host blocks (sources, sinks, protocol framers) run on numpy arrays between
device segments.  The graph sets ``block.device`` before ``initialize()``,
so blocks allocate their constants (taps, phasor tables) and state there.

There is no per-block process or socket: the reference's fork-per-block +
socketpair transport (radio/core/composite.lua:568-636,
radio/core/pipe.lua:59-65) is replaced by one step function per device
segment and a host chunk pump at the graph boundary.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Sequence

from luaradio_tpu_torch.types import SampleType


class Input:
    """Input port descriptor.

    ``accepted`` is a SampleType, a tuple of SampleTypes, or a predicate
    ``f(SampleType) -> bool`` (the reference supports predicate signatures,
    e.g. JSONSink accepts any type with to_json —
    radio/blocks/sinks/json.lua).
    """

    def __init__(self, name: str, accepted):
        self.name = name
        self.accepted = accepted

    def matches(self, t: SampleType) -> bool:
        acc = self.accepted
        if callable(acc) and not isinstance(acc, SampleType):
            return bool(acc(t))
        if isinstance(acc, (tuple, list, set)):
            return t in acc
        return t == acc

    def __repr__(self):
        return f"Input({self.name!r})"


class Output:
    """Output port descriptor.

    ``type`` may be a SampleType or a function of the matched input types
    (for blocks whose output type depends on input type).
    """

    def __init__(self, name: str, type=None):
        self.name = name
        self.type = type

    def __repr__(self):
        return f"Output({self.name!r})"


class TypeSignature:
    def __init__(self, inputs: Sequence[Input], outputs: Sequence[Output],
                 process_name: str | None = None,
                 initialize_name: str | None = None):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.process_name = process_name
        self.initialize_name = initialize_name


class Block:
    """Base class for all blocks.

    Mirrors the reference block contract (add_type_signature / differentiate /
    get_input_type / get_output_type / get_rate —
    radio/core/block.lua:238-390).
    """

    #: "device" blocks run inside a device segment's step on the card;
    #: "host" blocks run on the host between device segments.
    domain = "host"
    #: host block whose output length is data-dependent (framers, decoders).
    variable_output = False
    #: device block whose one output is a (values, mask) pair of equal
    #: shapes (the Sampler): the runtime copies both to the host and keeps
    #: values[mask] there, so its consumers see a data-dependent length.
    masked_output = False
    #: device block that can be demoted to host mode (process_host) when fed
    #: by a variable-rate host stage.
    dual = False

    def __init__(self):
        self.name = type(self).__name__
        self.signatures: list[TypeSignature] = []
        self.inputs: list[Input] = []
        self.outputs: list[Output] = []
        self.signature: TypeSignature | None = None
        self.input_types: list[SampleType] = []
        self.output_types: list[SampleType] = []
        self.input_rate: float | None = None
        #: torch.device the block's tensors live on (set by the graph)
        self.device = None
        self._differentiated = False

    # -- construction -----------------------------------------------------
    def add_type_signature(self, inputs: Sequence[Input], outputs: Sequence[Output],
                           process_name: str | None = None,
                           initialize_name: str | None = None):
        if self.signatures:
            if len(self.signatures[0].inputs) != len(inputs):
                raise ValueError(f"{self.name}: inconsistent input port count")
            if len(self.signatures[0].outputs) != len(outputs):
                raise ValueError(f"{self.name}: inconsistent output port count")
        self.signatures.append(TypeSignature(inputs, outputs, process_name,
                                             initialize_name))
        # Port lists come from the first signature (names must agree).
        if len(self.signatures) == 1:
            self.inputs = list(inputs)
            self.outputs = list(outputs)

    # -- differentiation (type propagation) -------------------------------
    def differentiate(self, input_types: Sequence[SampleType]):
        """Select the type signature matching the given input types and bind
        the per-signature process/initialize methods.
        (reference: radio/core/block.lua:296-345)"""
        input_types = list(input_types)
        for sig in self.signatures:
            if len(sig.inputs) != len(input_types):
                continue
            if all(p.matches(t) for p, t in zip(sig.inputs, input_types)):
                self.signature = sig
                self.input_types = input_types
                self.output_types = []
                for out in sig.outputs:
                    t = out.type
                    if callable(t) and not isinstance(t, SampleType):
                        t = t(input_types)
                    self.output_types.append(t)
                if sig.process_name is not None:
                    self.process = getattr(self, sig.process_name)
                if sig.initialize_name is not None:
                    self.initialize = getattr(self, sig.initialize_name)
                self._differentiated = True
                return
        raise ValueError(
            f"{self.name}: no type signature matches input types "
            f"{[t.name for t in input_types]}")

    def get_input_type(self, index: int = 0) -> SampleType:
        self._check_differentiated()
        return self.input_types[index]

    def get_output_type(self, index: int = 0) -> SampleType:
        self._check_differentiated()
        return self.output_types[index]

    def _check_differentiated(self):
        if not self._differentiated:
            raise RuntimeError(f"{self.name}: block not differentiated yet")

    # -- rates -------------------------------------------------------------
    def get_rate_ratio(self) -> Fraction:
        """Output rate / input rate as an exact rational.  Overridden by
        rate-changing blocks (Downsampler: 1/M, Upsampler: L/1 — reference
        overrides get_rate, radio/blocks/signal/downsampler.lua:36)."""
        return Fraction(1)

    def get_rate(self) -> float:
        if self.input_rate is None:
            raise RuntimeError(f"{self.name}: rate not set")
        return self.input_rate * self.get_rate_ratio()

    # -- batching ----------------------------------------------------------
    def out_batch_shape(self, in_batches: Sequence[tuple]) -> tuple:
        """Leading (batch/channel) axes of this block's outputs, given its
        inputs' batch shapes.  Device blocks broadcast over leading axes
        (last axis is time).  The graph propagates batch shapes so carried
        state is allocated per batch element (core/composite.py)."""
        batches = [tuple(b) for b in in_batches]
        if not batches:
            return ()
        return max(batches, key=len)

    # -- chunking ----------------------------------------------------------
    def chunk_multiple(self) -> int:
        """Required divisor of the per-call input chunk length.  The graph
        planner picks source chunk sizes so every block's constraint holds
        (e.g. a decimator requires a multiple of its factor)."""
        return 1

    def out_count(self, n_valid: int) -> int:
        """Number of valid output samples given n_valid valid input samples
        (used only for the final partial chunk at EOF)."""
        r = self.get_rate_ratio()
        return (n_valid * r.numerator) // r.denominator

    # -- lifecycle ---------------------------------------------------------
    def initialize(self):
        """Called once after differentiate + rate propagation; design filter
        taps, allocate constants, etc. (reference block.lua:471)."""

    def cleanup(self):
        """Called once when the flow graph stops (close files, etc.)."""

    def __repr__(self):
        return f"<{self.name}>"


class SignalBlock(Block):
    """A device block: a function of torch tensors on the graph's device,
    run inside its segment's step.  State is explicit and threaded through
    process().

    Time-axis sharding contract (the JAX package's core/block.py; a mesh
    with a ``"time"`` axis runs ANY graph of blocks that keep it,
    parallel/mesh.py).  Under a time mesh a block receives each input as
    ``[D_local, ..., T_local]``, the shards this process holds stacked on
    the leading axis, and the one global carried state (no shard axis):

    * ``time_local = True``: no coupling along time (elementwise math,
      zero stuffing, aligned decimation), so process() is exact on the
      stacked shards as they are.
    * ``tail_state = True``: the carried state is exactly the last
      ``state.shape[-1]`` INPUT samples (FIR family, delay lines).  The
      default process_sharded() feeds each shard its left neighbour's
      input tail (the carried state on shard 0) and returns the stream's
      global input tail as the new state, both from one halo exchange.
    * otherwise a block that can shard overrides process_sharded()
      (recurrences through distributed prefix scans, mixers through
      per-shard phase offsets); a block that cannot (a per-sample
      feedback loop, a data-dependent output count) keeps the default,
      which raises with the block's name.

    Every process_sharded returns the true global state, the same on
    every shard and every process, so the next chunk may read it on any
    shard (the JAX package reads tail states on shard 0 only; the port
    has no counterpart of its ``shard0_state``)."""

    domain = "device"
    #: no coupling along time: process() on any split of the time axis
    #: is exact
    time_local = False
    #: the carried state is the last state.shape[-1] input samples
    tail_state = False

    def init_state(self) -> Any:
        return None

    def process(self, state, *xs):
        raise NotImplementedError

    def process_sharded(self, state, *xs, axis):
        """Run one chunk with its time (last) axis sharded over ``axis``
        (parallel/mesh.py Axis): ``xs`` are ``[D_local, ..., T_local]``,
        ``state`` and the returned state the global carry."""
        if self.time_local:
            return self.process(state, *xs)
        if self.tail_state and len(xs) == 1:
            x = xs[0]
            k = state.shape[-1]
            if k > x.shape[-1]:
                raise NotImplementedError(
                    f"{self.name}: carried tail ({k}) exceeds the per-shard "
                    f"chunk ({x.shape[-1]}); increase chunk_size")
            halo, tail = axis.halo_and_tail(x.to(state.dtype), k,
                                            first=state)
            _, y = self.process(halo, x)
            return tail, y
        raise NotImplementedError(
            f"{self.name} does not support time-axis sharding; use channel "
            f"banking (mesh with a 'channel' axis) for this graph")


class HostBlock(Block):
    """A host block: runs eagerly on numpy arrays / Python objects."""

    domain = "host"

    def process(self, *xs):
        raise NotImplementedError


class SourceBlock(Block):
    """Base for sources. Device sources (SignalSource) subclass
    SignalSourceBlock; host sources (files) subclass HostSourceBlock.

    Sources must set ``self.rate`` (samples/sec) before initialize()."""

    rate: float | None = None

    def __init__(self):
        super().__init__()
        self.input_rate = None

    def get_rate(self) -> float:
        if self.rate is None:
            raise RuntimeError(f"{self.name}: source rate unknown")
        return float(self.rate)


class SignalSourceBlock(SourceBlock, SignalBlock):
    """Device-resident source: generates chunks on the device.

    process(state, n) is not used; instead ``generate(state, length) ->
    (state, ys)`` produces a fixed-length chunk inside the segment step."""

    domain = "device"

    def generate(self, state, length: int):
        raise NotImplementedError

    def generate_sharded(self, state, length: int, axis):
        """This process's shards of the chunk, ``[D_local, length]``
        (global chunk = length * axis.size).  Sources whose output depends
        on the absolute sample position (oscillators, generators)
        override this with per-shard offsets or streams."""
        if self.time_local:
            return self.generate(state, length)
        raise NotImplementedError(
            f"{self.name} does not support time-axis sharding")


class HostSourceBlock(SourceBlock, HostBlock):
    """Host source: read(n) returns up to n samples as a numpy array per
    output port, or None at EOF.  The rest of the ingest contract has
    defaults, and from it the runtime picks the source's route to the card
    once (core/ingest.py): ``device_ingest``, ``wire_read`` and
    ``wire_factor`` (wire items a sample) make the wire route,
    ``resident_setup`` and ``resident_read`` the resident one, which
    ``resident`` takes where eligible (None), never (False) or requires
    (True: the runtime raises where it cannot be had)."""

    domain = "host"
    wire_factor = 1
    resident: bool | None = None

    def read(self, n: int):
        raise NotImplementedError

    def wire_read(self, n: int):
        """Raw wire samples as (numpy integer array, n_valid) or None at
        EOF.  Only called when device_ingest() returned a converter."""
        raise NotImplementedError

    def device_ingest(self):
        """Return a function converting the wire_read array (as a tensor on
        the device) to the block's samples, or None when this source does
        not support device-side conversion (the default)."""
        return None

    def resident_setup(self, chunk: int) -> bool:
        """Put the payload on the device for ``chunk``-sample windows, or
        return False where the source has no ring (the default)."""
        return False

    def resident_read(self, n: int):
        """The next ``n`` samples from the ring, a tensor on the device.
        Only called after resident_setup returned True."""
        raise NotImplementedError


class SinkBlock(HostBlock):
    """Host sink. ``wants_data=False`` sinks (Nop, Benchmark) never force a
    device->host transfer of their input."""

    wants_data = True

    def process(self, *xs):
        raise NotImplementedError


__all__ = [
    "Input", "Output", "TypeSignature", "Block", "SignalBlock", "HostBlock",
    "SourceBlock", "SignalSourceBlock", "HostSourceBlock", "SinkBlock",
]
