"""Flow-graph optimizer: LTI fusion rewrites.

The reference executes every block as its own process at its own full
sample rate; a LuaRadio chain like ``LPF -> FMDeemphasis -> Downsampler(8)``
costs three pipe hops and computes 8x more FIR output than survives
(radio/blocks/signal/{firfilter,fmdeemphasisfilter,downsampler}.lua).
This pass removes the *algorithmic* waste:

* **FIR x FIR combining** — adjacent FIR stages collapse into one filter
  with convolved taps (one pass over memory instead of two).
* **IIR -> FIR conversion** — short stable IIRs (deemphasis, single-pole
  filters) whose impulse response decays below 1e-10 are replaced by their
  truncated impulse response.
* **Decimation folding** — a trailing Downsampler(D) folds into the filter:
  only every D-th output is computed (ops/fir.py fir_decimate).
* **Discriminator + decimating FIR** (opt-in, ``_fuse_disc_fir``) — the
  pair becomes one block running the CUDA kernel K2.

All rewrites are exact LTI algebra except IIR truncation, which is bounded
by 1e-10 of the impulse-response peak.  Disable with
``run(optimize=False)``.
"""

from __future__ import annotations

import os

import numpy as np

from luaradio_tpu_torch.core.block import Block, SignalBlock


def _fir_equiv(block: Block):
    fn = getattr(block, "fir_equivalent", None)
    if fn is None:
        return None
    return fn()


def _is_chain_candidate(graph, b: Block) -> bool:
    return (isinstance(b, SignalBlock) and b.domain == "device"
            and len(b.inputs) == 1 and len(b.outputs) == 1
            and not b.masked_output)


def _decim_factor(b: Block) -> int | None:
    from luaradio_tpu_torch.blocks.signal.sampling import DownsamplerBlock
    if isinstance(b, DownsamplerBlock):
        return b.factor
    return None


def optimize_graph(graph) -> int:
    """Apply LTI fusion rewrites in place.  Returns the number of rewrites.

    Runs after type differentiation and rate validation (so designed taps
    and rational ratios are known) and before chunk planning (so the fused
    blocks' chunk multiples drive the planner).
    """
    from luaradio_tpu_torch.core.composite import PortRef
    from luaradio_tpu_torch.blocks.signal.filtering import DecimatingFIRBlock
    from luaradio_tpu_torch.ops.fir import combine_taps
    from luaradio_tpu_torch.types import ComplexFloat32, Float32

    n_rewrites = 0
    changed = True
    while changed:
        changed = False
        for b in list(graph.order):
            if b not in graph.blocks:
                continue  # removed by an earlier rewrite this sweep
            if not _is_chain_candidate(graph, b):
                continue
            if _fir_equiv(b) is None and _decim_factor(b) is None:
                continue

            # Grow the longest chain of single-consumer LTI stages from b,
            # allowing trailing downsamplers to fold their factor in.
            chain = [b]
            cur = b
            while True:
                consumers = graph.consumers(PortRef(cur, 0))
                if len(consumers) != 1:
                    break
                nxt = consumers[0].block
                if (not _is_chain_candidate(graph, nxt)
                        or (_fir_equiv(nxt) is None
                            and _decim_factor(nxt) is None)):
                    break
                chain.append(nxt)
                cur = nxt

            # Trim trailing blocks so the chain ends at the last
            # downsampler or FIR (no dangling prefix-only case).
            while chain and _fir_equiv(chain[-1]) is None \
                    and _decim_factor(chain[-1]) is None:
                chain.pop()
            if len(chain) < 2 and _decim_factor(b) is None:
                # a lone IIR still benefits from FIR conversion (scan ->
                # convolution); a lone FIR/downsampler stays as-is
                from luaradio_tpu_torch.blocks.signal.filtering import \
                    IIRFilterBlock
                if not (len(chain) == 1 and isinstance(b, IIRFilterBlock)
                        and _fir_equiv(b) is not None):
                    continue
            if len(chain) == 1 and _decim_factor(b) is not None:
                continue  # a lone downsampler is already one strided view

            # Combine: taps convolve at full rate until a downsampler is
            # hit; downsamplers only fold when no filter FOLLOWS them in
            # the chain at the decimated rate with taps needing the
            # pre-decimation rate — i.e. filters after a downsampler see a
            # different rate.  Keep it exact: stop the chain at the first
            # downsampler that is followed by more stages.
            taps = np.array([1.0])
            decim = 1
            used = []
            for i, blk in enumerate(chain):
                d = _decim_factor(blk)
                if d is not None:
                    decim *= d
                    used.append(blk)
                    # fold at most the trailing run of downsamplers
                    rest = chain[i + 1:]
                    if any(_decim_factor(r) is None for r in rest):
                        break
                    continue
                if decim != 1:
                    break  # filter after decimation: different rate domain
                h = _fir_equiv(blk)
                if h is None:
                    break
                taps = combine_taps(taps, h)
                used.append(blk)
            chain = used
            if len(chain) < 2:
                from luaradio_tpu_torch.blocks.signal.filtering import \
                    IIRFilterBlock
                if not (len(chain) == 1 and isinstance(chain[0],
                                                       IIRFilterBlock)):
                    continue
            if len(taps) > 4096:
                continue  # iir_to_fir_taps' length cap; leave as-is

            in_type = chain[0].get_input_type()
            taps_c = np.iscomplexobj(taps)
            out_type = (ComplexFloat32
                        if (in_type == ComplexFloat32 or taps_c)
                        else Float32)
            if out_type != chain[-1].get_output_type():
                continue  # unexpected type algebra; bail conservatively

            new = DecimatingFIRBlock.synth(
                taps, decim, in_type, chain[0].input_rate, graph.device,
                name_hint="+".join(blk.name for blk in chain))
            new.initialize()

            # Rewire: input edge, output consumers, block lists.
            src = graph.edges.pop(PortRef(chain[0], 0))
            graph.edges[PortRef(new, 0)] = src
            last = PortRef(chain[-1], 0)
            for dref in list(graph.edges):
                if graph.edges[dref] == last:
                    graph.edges[dref] = PortRef(new, 0)
            for blk in chain[1:]:
                graph.edges.pop(PortRef(blk, 0), None)
            idx = graph.order.index(chain[0])
            for blk in chain:
                graph.blocks.remove(blk)
                graph.order.remove(blk)
            graph.blocks.append(new)
            graph.order.insert(idx, new)
            n_rewrites += 1
            changed = True
    n_rewrites += _fuse_disc_fir(graph)
    return n_rewrites


def _fuse_disc_fir(graph) -> int:
    """OPT-IN rewrite (LUARADIO_TPU_FORCE_WBFM_KERNEL=1, the JAX package's
    switch under the same name): ``FrequencyDiscriminator ->
    DecimatingFIR`` pairs become one DiscriminatorDecimatingFIRBlock
    (blocks/signal/modem.py), whose CUDA kernel K2 keeps the discriminated
    stream in shared memory between the atan2 and the FIR.

    The JAX package leaves it off by default because on the TPU the
    Pallas call is a fusion barrier (its measurement; core/optimize.py
    there).  The port keeps the same default so both packages build the
    same graphs; whether the kernel pays on the card is for a later
    measurement to decide.  Off under a mesh (``graph.fuse_kernels``),
    where the JAX package turns its Pallas fusion off too.
    """
    if not os.environ.get("LUARADIO_TPU_FORCE_WBFM_KERNEL") \
            or not graph.fuse_kernels:
        return 0
    from luaradio_tpu_torch.core.composite import PortRef
    from luaradio_tpu_torch.blocks.signal.filtering import DecimatingFIRBlock
    from luaradio_tpu_torch.blocks.signal.modem import (
        DiscriminatorDecimatingFIRBlock, FrequencyDiscriminatorBlock)
    from luaradio_tpu_torch.ops.wbfm import fits

    n = 0
    for b in list(graph.order):
        if not isinstance(b, FrequencyDiscriminatorBlock) \
                or b not in graph.blocks:
            continue
        cons = graph.consumers(PortRef(b, 0))
        if len(cons) != 1:
            continue
        d = cons[0].block
        if not (isinstance(d, DecimatingFIRBlock)
                and not np.iscomplexobj(d.taps)):
            continue
        k = -(-len(d.taps) // 128) * 128       # the block pads taps to 128s
        if not fits(k, d.decimation):
            continue  # window too large for the kernel's shared memory
        new = DiscriminatorDecimatingFIRBlock.synth(
            np.asarray(d.taps, np.float32), d.decimation,
            b.gain / (2 * np.pi), b.input_rate, graph.device,
            name_hint=f"{b.name}+{d.name}")
        new.initialize()
        src = graph.edges.pop(PortRef(b, 0))
        graph.edges[PortRef(new, 0)] = src
        last = PortRef(d, 0)
        for dref in list(graph.edges):
            if graph.edges[dref] == last:
                graph.edges[dref] = PortRef(new, 0)
        graph.edges.pop(PortRef(d, 0), None)
        idx = graph.order.index(b)
        for blk in (b, d):
            graph.blocks.remove(blk)
            graph.order.remove(blk)
        graph.blocks.append(new)
        graph.order.insert(idx, new)
        n += 1
    return n


__all__ = ["optimize_graph"]
